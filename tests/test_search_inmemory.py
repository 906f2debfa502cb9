"""End-to-end recall gate: in-memory PQ variant with exact re-rank
(SURVEY.md §7 step 5)."""

import numpy as np
import pytest

from bang_jax.formats import load_bin, load_truthset
from bang_jax.models.index import device_index_from_files
from bang_jax.models.inmemory import search_inmemory
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


@pytest.fixture(scope="module")
def loaded(tiny_index):
    prefix = tiny_index["prefix"]
    index = device_index_from_files(prefix, variant="inmemory")
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return index, queries, gt_ids, gt_dists


def test_inmemory_recall(loaded):
    index, queries, gt_ids, gt_dists = loaded
    params = SearchParams(L=64, k=10)
    ids, dists, stats = search_inmemory(index, queries, params)
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 90.0, f"PQ+rerank recall@10 too low: {recall}"
    # re-ranked distances are exact squared L2 of the returned ids
    vecs = np.asarray(index.vectors)
    if vecs.dtype == np.uint8 and vecs.shape[-1] == 4 * index.dim:
        vecs = vecs.view(np.float32)  # u8 bit-view packing of f32 tables
    want = ((queries[:, None, :] - vecs[np.asarray(ids)]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(dists), want, rtol=1e-3, atol=1e-2)


def test_inmemory_rerank_improves_over_raw_pq(loaded):
    index, queries, gt_ids, gt_dists = loaded
    p_rerank = SearchParams(L=64, k=10, rerank=True)
    p_raw = SearchParams(L=64, k=10, rerank=False)
    r_rerank = calculate_recall(
        gt_ids, np.asarray(search_inmemory(index, queries, p_rerank)[0]), 10, gt_dists
    )
    r_raw = calculate_recall(
        gt_ids, np.asarray(search_inmemory(index, queries, p_raw)[0]), 10, gt_dists
    )
    assert r_rerank >= r_raw


def test_inmemory_bloom_mode(loaded):
    index, queries, gt_ids, gt_dists = loaded
    params = SearchParams(L=64, k=10, visited_mode="bloom")
    ids, _, _ = search_inmemory(index, queries, params)
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 90.0, f"bloom-mode recall@10 too low: {recall}"


def test_inmemory_uint8(tiny_uint8_index):
    from bang_jax.formats.bin_io import load_bin_auto

    prefix = tiny_uint8_index["prefix"]
    index = device_index_from_files(prefix, variant="inmemory")
    queries = load_bin_auto(prefix + "_query.bin", np.uint8).astype(np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    ids, _, _ = search_inmemory(index, queries, SearchParams(L=64, k=10))
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 90.0, f"uint8 recall@10 too low: {recall}"


def test_neighbor_codes_layout_matches(tiny_index):
    """nbr_codes (gather-efficient layout) gives identical results."""
    from bang_jax.models.index import device_index_from_files

    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)[:64]
    params = SearchParams(L=48, k=10)
    idx_plain = device_index_from_files(prefix, neighbor_codes=False)
    idx_nbr = device_index_from_files(prefix, neighbor_codes=True)
    assert idx_nbr.nbr_codes is not None and idx_plain.nbr_codes is None
    ids_a, d_a, _ = search_inmemory(idx_plain, queries, params)
    ids_b, d_b, _ = search_inmemory(idx_nbr, queries, params)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    np.testing.assert_allclose(np.asarray(d_a), np.asarray(d_b), rtol=1e-5)


def test_fused_frontier_layout_matches(tmp_path):
    """Fused frontier rows (ONE gather per parent yields ids + distances)
    give identical results to the plain scattered layout, incl. beam>1."""
    from bang_jax.formats import synthetic
    from bang_jax.models.index import device_index_from_files

    prefix = str(tmp_path / "fx")
    synthetic.build_synthetic_index(
        prefix, n=3000, dim=32, r=64, m=8, n_queries=48, k=10, seed=21
    )
    queries = load_bin(prefix + "_query.bin", np.float32)[:48]
    idx_plain = device_index_from_files(prefix, neighbor_codes=False)
    idx_fused = device_index_from_files(prefix)  # default: fused when it fits
    assert idx_fused.fused_rows is not None and idx_plain.fused_rows is None
    # fused rows carry the ids: the i32 table must NOT be device-resident
    assert idx_fused.adj is None and idx_fused.adj_planes is None
    for beam in (1, 2):
        params = SearchParams(L=48, k=10, beam_width=beam)
        ids_a, d_a, _ = search_inmemory(idx_plain, queries, params)
        ids_b, d_b, _ = search_inmemory(idx_fused, queries, params)
        np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
        np.testing.assert_allclose(np.asarray(d_a), np.asarray(d_b), rtol=1e-5)


def test_fused_frontier_any_r(tiny_index):
    """Fused rows have no degree restriction: the r=24 tiny index selects
    them by default and searches exactly like the plain layout."""
    from bang_jax.models.index import device_index_from_files

    prefix = tiny_index["prefix"]
    idx = device_index_from_files(prefix)  # tiny index has r=24
    assert idx.fused_rows is not None and idx.nbr_codes is None
    idx_plain = device_index_from_files(prefix, neighbor_codes=False)
    queries = load_bin(prefix + "_query.bin", np.float32)[:32]
    params = SearchParams(L=32, k=10, beam_width=2)
    ids_a, _, _ = search_inmemory(idx_plain, queries, params)
    ids_b, _, _ = search_inmemory(idx, queries, params)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))


def test_neighbor_codes_beam_matches(tiny_index):
    from bang_jax.models.index import device_index_from_files

    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)[:64]
    params = SearchParams(L=48, k=10, beam_width=4)
    idx_plain = device_index_from_files(prefix, neighbor_codes=False)
    idx_nbr = device_index_from_files(prefix, neighbor_codes=True)
    ids_a, _, _ = search_inmemory(idx_plain, queries, params)
    ids_b, _, _ = search_inmemory(idx_nbr, queries, params)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
