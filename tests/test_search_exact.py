"""End-to-end recall gate: exact-distance variant on a synthetic index
(SURVEY.md §7 step 4 — the north-star milestone)."""

import numpy as np
import pytest

from bang_jax.formats import load_bin, load_truthset
from bang_jax.models.index import device_index_from_files
from bang_jax.models.exactdistance import search_exact
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


@pytest.fixture(scope="module")
def loaded(tiny_index):
    prefix = tiny_index["prefix"]
    index = device_index_from_files(prefix, variant="exactdistance")
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return index, queries, gt_ids, gt_dists


def test_exact_search_recall(loaded):
    index, queries, gt_ids, gt_dists = loaded
    params = SearchParams(L=64, k=10)
    ids, dists, stats = search_exact(index, queries, params)
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 95.0, f"recall@10 too low: {recall}"
    assert 0 < stats.iters <= params.max_iters
    assert stats.n_expanded > 0
    # distance computations bounded by expanded parents * degree
    assert 0 < stats.n_dist_comps <= stats.n_expanded * index.adj.shape[1]
    # distances ascending & exact for the returned ids
    d = np.asarray(dists)
    assert (np.diff(d, axis=1) >= -1e-4).all()
    gathered = index_vectors_dist(index, queries, np.asarray(ids))
    np.testing.assert_allclose(d, gathered, rtol=1e-3, atol=1e-2)


def index_vectors_dist(index, queries, ids):
    vecs = np.asarray(index.vectors)
    if vecs.dtype == np.uint8 and vecs.shape[-1] == 4 * index.dim:
        vecs = vecs.view(np.float32)  # u8 bit-view packing of f32 tables
    return ((queries[:, None, :] - vecs[ids]) ** 2).sum(-1)


def test_exact_search_bloom_mode(loaded):
    index, queries, gt_ids, gt_dists = loaded
    params = SearchParams(L=64, k=10, visited_mode="bloom")
    ids, _, _ = search_exact(index, queries, params)
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 95.0, f"bloom-mode recall@10 too low: {recall}"


def test_exact_search_larger_L_improves(loaded):
    index, queries, gt_ids, gt_dists = loaded
    r_small = calculate_recall(
        gt_ids, np.asarray(search_exact(index, queries, SearchParams(L=10, k=10))[0]), 10, gt_dists
    )
    r_large = calculate_recall(
        gt_ids, np.asarray(search_exact(index, queries, SearchParams(L=96, k=10))[0]), 10, gt_dists
    )
    assert r_large >= r_small
    assert r_large >= 98.0


def test_exact_search_k1(loaded):
    """k=1 should find the true nearest neighbor for nearly every query."""
    index, queries, gt_ids, gt_dists = loaded
    ids, _, _ = search_exact(index, queries, SearchParams(L=32, k=1))
    hit = (np.asarray(ids)[:, 0] == gt_ids[:, 0]).mean()
    assert hit >= 0.95


def test_fused_exact_frontier_pack_decode():
    """Pack/decode round-trip of the fused exact-frontier rows, with ids
    above 2^16 so every byte plane is exercised."""
    import jax.numpy as jnp

    from bang_jax.ops.l2 import decode_exact_frontier_rows, pack_exact_frontier_rows

    rng = np.random.default_rng(7)
    n, r, d = 70_000, 8, 16
    vectors = rng.integers(0, 256, (n, d), dtype=np.uint8)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    norms = (vectors.astype(np.float64) ** 2).sum(-1).astype(np.float32)

    rows = pack_exact_frontier_rows(
        jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(norms), n_blocks=4
    )
    assert rows.shape == (n, 8 * r + r * d)
    parents = jnp.asarray(rng.integers(0, n, (32, 2)).astype(np.int32))
    ids, dn, vecs = decode_exact_frontier_rows(rows[parents], r, d)
    p = np.asarray(parents)
    want_ids = adj[p].reshape(32, 2 * r)
    assert want_ids.max() > 1 << 16  # byte-plane-2 coverage
    np.testing.assert_array_equal(np.asarray(ids), want_ids)
    np.testing.assert_array_equal(np.asarray(dn), norms[want_ids])
    np.testing.assert_array_equal(
        np.asarray(vecs), vectors[want_ids.reshape(32, 2 * r)]
    )


def test_fused_exact_frontier_matches(tiny_uint8_index):
    """Fused exact-frontier rows (opt-in, see models/index.py) traverse
    identically to the scattered path."""
    from bang_jax.formats.graph import load_graph_index
    from bang_jax.models.index import build_device_index

    prefix = tiny_uint8_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.uint8).astype(np.float32)[:64]
    params = SearchParams(L=48, k=10, beam_width=2)
    graph = load_graph_index(prefix)
    idx_fused = build_device_index(graph=graph, fused_exact_frontier=True)
    assert idx_fused.fused_vec_rows is not None
    idx_plain = device_index_from_files(prefix, "exactdistance", neighbor_vectors=False)
    assert idx_plain.fused_vec_rows is None
    ids_a, d_a, _ = search_exact(idx_fused, queries, params)
    ids_b, d_b, _ = search_exact(idx_plain, queries, params)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    np.testing.assert_allclose(np.asarray(d_a), np.asarray(d_b), rtol=1e-5)


def test_neighbor_vectors_layout_matches(tiny_index):
    """nbr_vecs (gather-efficient layout) gives identical exact results."""
    from bang_jax.models.index import device_index_from_files

    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)[:64]
    params = SearchParams(L=48, k=10, beam_width=2)
    idx_plain = device_index_from_files(prefix, "exactdistance", neighbor_vectors=False)
    idx_nbr = device_index_from_files(prefix, "exactdistance", neighbor_vectors=True)
    assert idx_nbr.nbr_vecs is not None and idx_plain.nbr_vecs is None
    ids_a, d_a, _ = search_exact(idx_plain, queries, params)
    ids_b, d_b, _ = search_exact(idx_nbr, queries, params)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))

def test_sampled_entry_mode(loaded):
    """entry_mode="sampled" (per-query entry via a strided-sample matmul,
    models/entry.py) must preserve recall while spending no more traversal
    iterations than the shared-medoid start — on both variants."""
    index, queries, gt_ids, gt_dists = loaded
    base = SearchParams(L=32, k=10)
    samp = SearchParams(L=32, k=10, entry_mode="sampled", entry_samples=256)

    ids_m, _, st_m = search_exact(index, queries, base)
    ids_s, _, st_s = search_exact(index, queries, samp)
    r_m = calculate_recall(gt_ids, np.asarray(ids_m), 10, gt_dists)
    r_s = calculate_recall(gt_ids, np.asarray(ids_s), 10, gt_dists)
    assert r_s >= r_m - 1.0, (r_m, r_s)
    assert st_s.iters <= st_m.iters, (st_m.iters, st_s.iters)


def test_sampled_entry_mode_inmemory(tiny_index):
    from bang_jax.models.inmemory import search_inmemory

    prefix = tiny_index["prefix"]
    index = device_index_from_files(prefix, variant="inmemory")
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    # beam_width=2 also exercises the multi-entry seeding (top-2 sampled
    # entries fill both beam slots at init)
    samp = SearchParams(L=32, k=10, entry_mode="sampled", entry_samples=256,
                        beam_width=2)
    ids, _, stats = search_inmemory(index, queries, samp)
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 90.0, recall

def test_sampled_entry_ids_unit():
    """sampled_entry_ids returns the argmin over the strided sample by true
    squared L2 (rank-only form drops the |q|^2 constant)."""
    import jax.numpy as jnp
    from bang_jax.models.entry import sampled_entry_ids

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(500, 16)).astype(np.float32)
    qs = rng.normal(size=(7, 16)).astype(np.float32)
    norms = (vecs ** 2).sum(-1)
    s = 64
    got = np.asarray(sampled_entry_ids(jnp.asarray(qs), jnp.asarray(vecs),
                                       jnp.asarray(norms), s))
    stride = 500 // s
    sample = (np.arange(s) * stride) % 500
    d = ((qs[:, None, :] - vecs[sample][None, :, :]) ** 2).sum(-1)
    want = sample[np.argmin(d, axis=1)]
    np.testing.assert_array_equal(got, want)



def test_seeded_entry_survives_to_rerank():
    """An entry seed that IS a true top-k neighbor must be returnable by the
    rerank path: init_state keeps the seeds in visited_ids[:, :beam] and the
    first loop iteration (it starts at 1) writes AFTER them, so exact_new_mask
    blocking the seeds' rediscovery loses nothing (round-3 advisor concern)."""
    import jax.numpy as jnp

    from bang_jax.models.traversal import (
        make_exact_distance_fn, rerank_topk, run_traversal,
    )

    rng = np.random.default_rng(42)
    n, d = 400, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    # queries placed ON sample points: the seeded entry IS the true NN
    q_ids = np.asarray([7, 133, 250], np.int32)
    qs = vecs[q_ids] + 1e-4
    norms = (vecs.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    adj = rng.integers(0, n, size=(n, 8)).astype(np.int32)

    vecs_j, qs_j = jnp.asarray(vecs), jnp.asarray(qs)
    dfn = make_exact_distance_fn(qs_j, vecs_j, jnp.asarray(norms))
    entry_ids = jnp.asarray(q_ids)[:, None]  # [Q, 1] seeds
    entry_dists = ((qs - vecs[q_ids]) ** 2).sum(-1)[:, None]
    final = run_traversal(
        jnp.asarray(adj), dfn, medoid=0, q=3, l=16, max_iters=8,
        use_bloom=False, beam=1,
        entry_ids=entry_ids, entry_dists=jnp.asarray(entry_dists),
    )
    # the seeds must still sit in the visited set...
    assert (np.asarray(final.visited_ids[:, 0]) == q_ids).all()
    # ...and the rerank top-1 must be exactly the seeded true NN
    ids, _ = rerank_topk(qs_j, vecs_j, jnp.asarray(norms), final.visited_ids, 1)
    np.testing.assert_array_equal(np.asarray(ids)[:, 0], q_ids)
