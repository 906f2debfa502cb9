"""End-to-end recall gate: Base variant (host-RAM graph, PQ on device,
pipelined host gather) — SURVEY.md §7 step 6. Also tests the native gather
library against the numpy fallback."""

import numpy as np
import pytest

from bang_jax.formats import load_bin, load_truthset
from bang_jax.models.base import BaseVariantSearcher
from bang_jax.native import (
    gather_parents_numpy,
    gather_parents_native,
    native_available,
)
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


@pytest.fixture(scope="module")
def loaded(tiny_index):
    prefix = tiny_index["prefix"]
    searcher = BaseVariantSearcher(prefix, n_pipeline_batches=2)
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return searcher, queries, gt_ids, gt_dists


def test_base_recall(loaded):
    searcher, queries, gt_ids, gt_dists = loaded
    ids, dists = searcher.search(queries, SearchParams(L=64, k=10))
    recall = calculate_recall(gt_ids, ids, 10, gt_dists)
    assert recall >= 90.0, f"base-variant recall@10 too low: {recall}"
    assert (np.diff(dists, axis=1) >= -1e-4).all()


def test_base_matches_inmemory(loaded, tiny_index):
    """Base and Inmemory run the same algorithm; recall must be comparable."""
    from bang_jax.models.index import device_index_from_files
    from bang_jax.models.inmemory import search_inmemory

    searcher, queries, gt_ids, gt_dists = loaded
    params = SearchParams(L=48, k=10)
    base_ids, _ = searcher.search(queries, params)
    index = device_index_from_files(tiny_index["prefix"], variant="inmemory")
    mem_ids, _, _ = search_inmemory(index, queries, params)
    r_base = calculate_recall(gt_ids, base_ids, 10, gt_dists)
    r_mem = calculate_recall(gt_ids, np.asarray(mem_ids), 10, gt_dists)
    assert abs(r_base - r_mem) < 5.0, (r_base, r_mem)


def test_base_single_pipeline_batch(loaded):
    searcher, queries, gt_ids, gt_dists = loaded
    one = BaseVariantSearcher.__new__(BaseVariantSearcher)
    one.__dict__.update(searcher.__dict__)
    one.n_pipeline_batches = 1
    ids, _ = one.search(queries[:32], SearchParams(L=64, k=10))
    recall = calculate_recall(gt_ids[:32], ids, 10, gt_dists[:32])
    assert recall >= 85.0


def test_native_gather_matches_numpy(tiny_index):
    searcher = BaseVariantSearcher(tiny_index["prefix"])
    if not native_available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    parents = rng.integers(0, searcher.meta.n, 64).astype(np.int32)
    m = searcher.meta
    args = (searcher.raw, m.entry_len, searcher.vec_bytes, m.dim, m.degree, m.dtype_code)

    nbrs_n = np.empty((64, m.degree), np.int32)
    vecs_n = np.empty((64, m.dim), np.float32)
    assert gather_parents_native(*args, parents, nbrs_n, vecs_n, 4)

    nbrs_p = np.empty_like(nbrs_n)
    vecs_p = np.empty_like(vecs_n)
    gather_parents_numpy(*args, parents, nbrs_p, vecs_p)

    np.testing.assert_array_equal(nbrs_n, nbrs_p)
    np.testing.assert_allclose(vecs_n, vecs_p)


def test_raw_gather_matches_converted(tiny_index):
    """raw_vecs mode ships unconverted storage bytes; viewing them as the
    index dtype and casting must equal the f32-converting gather (the Base
    step relies on this to cut per-iteration H2D 4x for u8/i8 indices)."""
    from bang_jax.native import gather_parents

    searcher = BaseVariantSearcher(tiny_index["prefix"])
    m = searcher.meta
    rng = np.random.default_rng(1)
    parents = rng.integers(0, m.n, 64).astype(np.int32)
    args = (searcher.raw, m.entry_len, searcher.vec_bytes, m.dim, m.degree,
            m.dtype_code)
    nbrs_f, vecs_f = gather_parents(*args, parents)
    nbrs_r, vecs_r = gather_parents(*args, parents, raw_vecs=True)
    assert vecs_r.dtype == np.uint8 and vecs_r.shape == (64, searcher.vec_bytes)
    np.testing.assert_array_equal(nbrs_f, nbrs_r)
    np.testing.assert_allclose(
        vecs_r.view(m.numpy_dtype).astype(np.float32), vecs_f
    )
    # and the searcher-facing wrapper returns the dtype view directly
    nbrs_s, vecs_s = searcher._host_gather(parents)
    assert vecs_s.dtype == m.numpy_dtype
    np.testing.assert_array_equal(nbrs_s, nbrs_f)


def test_base_beam_recall(loaded):
    searcher, queries, gt_ids, gt_dists = loaded
    ids, _ = searcher.search(queries, SearchParams(L=64, k=10, beam_width=4))
    recall = calculate_recall(gt_ids, ids, 10, gt_dists)
    assert recall >= 90.0, f"base beam=4 recall@10: {recall}"

def test_base_sampled_entry(loaded):
    """Base-variant sampled entry (PQ-reconstructed sample ranking on
    device): recall parity with the medoid start, fewer-or-equal device
    steps, and the beam-seeded (top-B entries) path."""
    searcher, queries, gt_ids, gt_dists = loaded
    ids_m, _ = searcher.search(queries, SearchParams(L=48, k=10, beam_width=2))
    steps_m = searcher.last_n_steps
    r_m = calculate_recall(gt_ids, ids_m, 10, gt_dists)
    ids_s, _ = searcher.search(
        queries,
        SearchParams(L=48, k=10, beam_width=2, entry_mode="sampled",
                     entry_samples=256),
    )
    steps_s = searcher.last_n_steps
    r_s = calculate_recall(gt_ids, ids_s, 10, gt_dists)
    assert r_s >= r_m - 1.5, (r_m, r_s)
    assert steps_s <= steps_m, (steps_m, steps_s)

