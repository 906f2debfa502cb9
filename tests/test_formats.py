"""Round-trip and parity tests for the on-disk formats (SURVEY.md §2 C2/C5/C15)."""

import numpy as np
import pytest

from bang_jax.constants import DTYPE_FLOAT32, DTYPE_UINT8
from bang_jax.formats import (
    GraphIndex,
    load_bin,
    load_graph_index,
    load_metadata,
    load_truthset,
    save_bin,
    save_graph_index,
    save_truthset,
)
from bang_jax.formats.pq import PQData, load_pq, save_pq
from bang_jax.formats import synthetic


def test_bin_roundtrip(tmp_path):
    data = np.random.default_rng(0).normal(size=(17, 9)).astype(np.float32)
    path = tmp_path / "x.bin"
    save_bin(path, data)
    out = load_bin(path, np.float32)
    np.testing.assert_array_equal(out, data)


def test_bin_size_check(tmp_path):
    data = np.zeros((4, 4), np.float32)
    path = tmp_path / "x.bin"
    save_bin(path, data)
    with open(path, "ab") as f:
        f.write(b"xx")
    with pytest.raises(ValueError):
        load_bin(path, np.float32)


def test_truthset_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1000, size=(7, 10)).astype(np.uint32)
    dists = rng.normal(size=(7, 10)).astype(np.float32)
    path = tmp_path / "gt.bin"
    save_truthset(path, ids, dists)
    i2, d2 = load_truthset(path)
    np.testing.assert_array_equal(i2, ids)
    np.testing.assert_array_equal(d2, dists)


@pytest.mark.parametrize("dtype,code", [(np.float32, DTYPE_FLOAT32), (np.uint8, DTYPE_UINT8)])
def test_graph_roundtrip(tmp_path, dtype, code):
    rng = np.random.default_rng(2)
    n, d, r = 50, 12, 8
    if dtype == np.float32:
        vecs = rng.normal(size=(n, d)).astype(dtype)
    else:
        vecs = rng.integers(0, 255, size=(n, d)).astype(dtype)
    degrees = rng.integers(1, r + 1, size=n).astype(np.int32)
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    # self-pad beyond degree (in-memory convention)
    pad = np.arange(r)[None, :] >= degrees[:, None]
    adj[pad] = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r))[pad]

    prefix = str(tmp_path / "g")
    index = GraphIndex(vectors=vecs, adj=adj, degrees=degrees, medoid=7)
    save_graph_index(prefix, index)

    # the streamed writer must produce identical bytes regardless of block
    prefix_b = str(tmp_path / "g_blocked")
    save_graph_index(prefix_b, index, block=7)  # 50 rows -> 8 partial blocks
    with open(prefix + "_disk.bin", "rb") as a, open(prefix_b + "_disk.bin", "rb") as b:
        assert a.read() == b.read()

    meta = load_metadata(prefix + "_disk_metadata.bin")
    assert meta.n == n and meta.dim == d and meta.degree == r
    assert meta.medoid == 7 and meta.dtype_code == code
    assert meta.entry_len == d * np.dtype(dtype).itemsize + 4 + 4 * r

    out = load_graph_index(prefix)
    np.testing.assert_array_equal(out.vectors, vecs)
    np.testing.assert_array_equal(out.degrees, degrees)
    assert out.medoid == 7
    # valid neighbors are preserved as sets (writer sorts them); padding = self
    for i in range(n):
        got = out.adj[i]
        assert set(got[: degrees[i]]) == set(adj[i, : degrees[i]])
        assert list(got[: degrees[i]]) == sorted(got[: degrees[i]])
        assert all(got[degrees[i] :] == i)


def test_graph_mmap_load(tmp_path):
    rng = np.random.default_rng(3)
    n, d, r = 20, 6, 4
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    degrees = np.full(n, r, np.int32)
    prefix = str(tmp_path / "g")
    save_graph_index(prefix, GraphIndex(vecs, adj, degrees, 0))
    out = load_graph_index(prefix, mmap=True)
    np.testing.assert_allclose(np.asarray(out.vectors), vecs)


def test_pq_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    d, m, n = 24, 6, 100
    pq = PQData(
        pivots=rng.normal(size=(256, d)).astype(np.float32),
        centroid=rng.normal(size=d).astype(np.float32),
        chunk_offsets=synthetic.default_chunk_offsets(d, m),
        codes=rng.integers(0, 256, size=(n, m)).astype(np.uint8),
    )
    prefix = str(tmp_path / "p")
    save_pq(prefix, pq)
    out = load_pq(prefix)
    np.testing.assert_array_equal(out.pivots, pq.pivots)
    np.testing.assert_array_equal(out.centroid, pq.centroid)
    np.testing.assert_array_equal(out.chunk_offsets, pq.chunk_offsets)
    np.testing.assert_array_equal(out.codes, pq.codes)
    assert out.num_chunks == m


def test_synthetic_bundle(tiny_index):
    prefix = tiny_index["prefix"]
    meta = load_metadata(prefix + "_disk_metadata.bin")
    assert meta.n == tiny_index["n"]
    index = load_graph_index(prefix)
    assert index.adj.shape == (tiny_index["n"], tiny_index["r"])
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    assert queries.shape[0] == gt_ids.shape[0] == tiny_index["n_queries"]
    # ground truth distances ascending
    assert (np.diff(gt_dists, axis=1) >= 0).all()
