"""Byte-plane adjacency (ops/adjacency) + the chunked neighbor-codes build.

The neighbor-codes layout is built in row blocks (models/index.py) and its
adjacency is stored as byte planes. Reference behavior covered: the adjacency fetch of the traversal loop
(BANG_Base/bang_search.cu:701-760).
"""

import numpy as np
import jax.numpy as jnp

from bang_jax.ops.adjacency import (
    PlaneAdjacency,
    decode_adj_planes,
    pack_adj_planes,
    pack_adj_planes_np,
)


def test_pack_decode_roundtrip_np_and_device():
    rng = np.random.default_rng(3)
    adj = rng.integers(0, 2**31 - 1, size=(37, 24), dtype=np.int32)
    planes_np = pack_adj_planes_np(adj)
    planes_dev = np.asarray(pack_adj_planes(jnp.asarray(adj)))
    np.testing.assert_array_equal(planes_np, planes_dev)
    back = np.asarray(decode_adj_planes(jnp.asarray(planes_np)))
    np.testing.assert_array_equal(back, adj)


def test_plane_adjacency_matches_table_gather():
    rng = np.random.default_rng(4)
    n, r, q, p = 100, 16, 9, 2
    adj = rng.integers(0, n, size=(n, r), dtype=np.int32)
    parents = rng.integers(0, n, size=(q, p), dtype=np.int32)
    fetch = PlaneAdjacency(jnp.asarray(pack_adj_planes_np(adj)))
    assert fetch.r == r
    got = np.asarray(fetch(jnp.asarray(parents)))
    want = adj[parents].reshape(q, p * r)
    np.testing.assert_array_equal(got, want)


def test_chunked_neighbor_codes_build_matches_naive():
    """The blocked build (incl. the overlapping tail block when n % blk != 0)
    must equal the naive codes[adj] materialization."""
    from bang_jax.models.index import build_device_index
    from bang_jax.formats.graph import GraphIndex
    from bang_jax.formats.pq import PQData

    rng = np.random.default_rng(5)
    n, d, r, m = 4096 + 1111, 16, 8, 4  # NOT a multiple of the 4096 block
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    adj = rng.integers(0, n, size=(n, r), dtype=np.int32)
    deg = np.full(n, r, np.int32)
    codes = rng.integers(0, 256, size=(n, m), dtype=np.uint8)
    pivots = rng.normal(size=(256, d)).astype(np.float32)
    offs = np.linspace(0, d, m + 1).astype(np.int64)
    pq = PQData(pivots=pivots, centroid=np.zeros(d, np.float32),
                chunk_offsets=offs, codes=codes)

    import bang_jax.models.index as index_mod

    # force multiple blocks: shrink the block floor via monkeypatching max
    idx = build_device_index(
        graph=GraphIndex(vectors, adj, deg, 0), pq=pq, neighbor_codes=True
    )
    assert idx.adj is None and idx.adj_planes is not None
    want_codes = codes[adj].reshape(n, r * m)
    np.testing.assert_array_equal(np.asarray(idx.nbr_codes), want_codes)
    np.testing.assert_array_equal(
        np.asarray(decode_adj_planes(idx.adj_planes)), adj
    )


def test_chunked_build_overlapping_tail(monkeypatch):
    """Tail handling at a small forced block size (n % blk != 0)."""
    from bang_jax.models import index as index_mod
    from bang_jax.formats.graph import GraphIndex
    from bang_jax.formats.pq import PQData

    rng = np.random.default_rng(6)
    n, d, r, m = 103, 8, 4, 2
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    adj = rng.integers(0, n, size=(n, r), dtype=np.int32)
    codes = rng.integers(0, 256, size=(n, m), dtype=np.uint8)
    pivots = rng.normal(size=(256, d)).astype(np.float32)
    offs = np.linspace(0, d, m + 1).astype(np.int64)
    pq = PQData(pivots=pivots, centroid=np.zeros(d, np.float32),
                chunk_offsets=offs, codes=codes)

    real_min = min

    def fake_min(a, b=None, *rest):  # force blk=16 inside the builder
        if b is None:
            return real_min(a)
        v = real_min(a, b, *rest)
        return 16 if v == n else v

    monkeypatch.setattr(index_mod, "min", fake_min, raising=False)
    idx = index_mod.build_device_index(
        graph=GraphIndex(vectors, adj, np.full(n, r, np.int32), 0),
        pq=pq, neighbor_codes=True,
    )
    np.testing.assert_array_equal(
        np.asarray(idx.nbr_codes), codes[adj].reshape(n, r * m)
    )
    np.testing.assert_array_equal(
        np.asarray(decode_adj_planes(idx.adj_planes)), adj
    )
