"""Sharded (beyond-HBM) build pipeline tests at toy scale (CPU backend).

Covers formats/bigbuild.py: deterministic block generation, overlapped
k-means sharding, per-shard device builds + round-robin merge (DiskANN's
merge_shards scheme), the int8-exact ground-truth kernel, and end-to-end
searchability of the merged graph."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bang_jax.formats import bigbuild


@pytest.fixture(scope="module")
def gen():
    return bigbuild.BlockGen(20_000, 24, block=4096, n_clusters=64, seed=5)


def test_blockgen_deterministic(gen):
    a = np.asarray(jax.device_get(gen.gen_block(3)))
    b = np.asarray(jax.device_get(gen.gen_block(3)))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(jax.device_get(gen.gen_block(4)))
    assert not np.array_equal(a, c)
    assert a.dtype == np.uint8


def test_gt_int8_exact(gen):
    data = bigbuild.materialize_host(gen)
    rng = np.random.default_rng(0)
    queries = data[rng.integers(0, gen.n, 64)]
    ids, dists = bigbuild.groundtruth_u8_streamed(gen, queries, 10, q_block=64)
    # exact int distances vs float64 brute force
    want = (
        (queries.astype(np.float64)[:, None, :] - data.astype(np.float64)[None])
        ** 2
    ).sum(-1)
    want_best = np.sort(want, axis=1)[:, :10]
    np.testing.assert_array_equal(dists, want_best.astype(np.float32))
    gathered = np.take_along_axis(want, ids.astype(np.int64), axis=1)
    np.testing.assert_array_equal(gathered, np.sort(gathered, axis=1))
    np.testing.assert_allclose(gathered, want_best)


def test_merge_shard_adj_dedup():
    n, r = 6, 4
    p0 = np.array([[1, 2, 3, 0], [0, 2, 1, 1], [3, 3, 2, 2],
                   [4, 5, 3, 3], [5, 0, 4, 4], [0, 1, 5, 5]], np.int32)
    p1 = np.array([[2, 4, 0, 0], [3, 0, 1, 1], [1, 2, 2, 2],
                   [3, 3, 3, 3], [2, 3, 4, 4], [4, 2, 5, 5]], np.int32)
    adj, deg = bigbuild.merge_shard_adj([p0, p1], r, n, chunk=4)
    # row 0: interleave 1,2,2,4,3,0(self->skip),... dedup -> 1,2,4,3
    np.testing.assert_array_equal(adj[0], [1, 2, 4, 3])
    assert deg[0] == 4
    # row 3: p0 has 4,5; p1 all self -> 4,5 then self-padded
    np.testing.assert_array_equal(adj[3], [4, 5, 3, 3])
    assert deg[3] == 2
    # no row contains duplicates among its first deg entries
    for i in range(n):
        row = adj[i][: deg[i]]
        assert len(set(row.tolist())) == deg[i]
        assert i not in row


def test_sharded_build_end_to_end(gen):
    """Merged sharded graph is navigable: exactdistance search reaches >=80%
    recall@10 on the toy dataset (single-graph builds score ~95+; the
    overlapped-merge pays a small quality tax, as DiskANN's does)."""
    from bang_jax.models.index import build_device_index
    from bang_jax.formats.graph import GraphIndex
    from bang_jax.models.exactdistance import search_exact
    from bang_jax.utils.config import SearchParams
    from bang_jax.utils.recall import calculate_recall

    adj, degrees, assignment = bigbuild.build_sharded_vamana(
        gen, r=16, l_build=24, n_shards=3, overlap=2, batch=1024,
        n_passes=1, verbose=False,
    )
    assert adj.shape == (gen.n, 16)
    assert ((adj >= 0) & (adj < gen.n)).all()
    assert assignment.shape == (gen.n, 2)
    data = bigbuild.materialize_host(gen)
    medoid = bigbuild.medoid_streamed(gen)
    rng = np.random.default_rng(1)
    queries = data[rng.integers(0, gen.n, 128)].astype(np.float32)
    gt_ids, gt_dists = bigbuild.groundtruth_u8_streamed(
        gen, queries.astype(np.uint8), 10, q_block=128
    )
    index = build_device_index(
        graph=GraphIndex(data, adj, degrees, medoid), pq=None,
        neighbor_vectors=False,
    )
    ids, _, _ = search_exact(index, queries, SearchParams(L=48, k=10))
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 80.0, f"sharded-merge graph recall@10: {recall}"


def test_d2h_chunked_matches_device_get():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.integers(0, 1 << 30, (1000, 7)).astype(np.int32))
    out = bigbuild.d2h_chunked(x, chunk_bytes=256)  # many partial chunks
    np.testing.assert_array_equal(out, np.asarray(jax.device_get(x)))

def test_sharded_build_warm_degree_upgrade(gen):
    """Warm-started sharded build (init graph R=16 -> target R=32, the
    incremental-pass path used by the 100M R=64 rebuild): recall must beat
    the cold R=16 graph and structural invariants must hold (valid ids,
    no self-edges inside the degree prefix, compacted rows)."""
    from bang_jax.models.index import build_device_index
    from bang_jax.formats.graph import GraphIndex
    from bang_jax.models.exactdistance import search_exact
    from bang_jax.utils.config import SearchParams
    from bang_jax.utils.recall import calculate_recall

    adj16, deg16, _ = bigbuild.build_sharded_vamana(
        gen, r=16, l_build=24, n_shards=3, overlap=2, batch=1024,
        n_passes=1, verbose=False,
    )
    adj32, deg32, _ = bigbuild.build_sharded_vamana(
        gen, r=32, l_build=24, n_shards=3, overlap=2, batch=1024,
        n_passes=1, verbose=False, init_adj=adj16, init_deg=deg16,
    )
    n = gen.n
    assert adj32.shape == (n, 32)
    assert ((adj32 >= 0) & (adj32 < n)).all()
    rows = np.arange(n)[:, None]
    # degree prefix holds real (non-self) edges; the rest is self-padding
    col = np.arange(32)[None, :]
    in_prefix = col < deg32[:, None]
    assert (adj32[in_prefix] != np.broadcast_to(rows, (n, 32))[in_prefix]).all()

    data = bigbuild.materialize_host(gen)
    medoid = bigbuild.medoid_streamed(gen)
    rng = np.random.default_rng(1)
    queries = data[rng.integers(0, n, 128)].astype(np.float32)
    gt_ids, gt_dists = bigbuild.groundtruth_u8_streamed(
        gen, queries.astype(np.uint8), 10, q_block=128
    )
    params = SearchParams(L=32, k=10)

    def recall_of(adj, deg):
        index = build_device_index(
            graph=GraphIndex(data, adj, deg, medoid), pq=None,
            neighbor_vectors=False,
        )
        ids, _, _ = search_exact(index, queries, params)
        return calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)

    r_cold16 = recall_of(adj16, deg16)
    r_warm32 = recall_of(adj32, deg32)
    assert r_warm32 >= r_cold16 - 1.0, (r_cold16, r_warm32)
    assert r_warm32 >= 85.0, r_warm32

