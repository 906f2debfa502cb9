"""Large-L operation (the reference's upper range: MAX_L=512, bang.h:20).

Round-1 tuned everything at L=10-64; this exercises the visited-set machinery
at L=256 with the full extra-iteration budget, in both exact-dense and bloom
modes, and checks they agree on recall. The dense mode's per-iteration compare
width grows as L + max_iters*beam (~800 lanes at L=256) — the recall gate here
guards correctness; scripts/exp_large_l.py measures the exact/bloom crossover
on real hardware.
"""

import numpy as np
import pytest

from bang_jax.formats import synthetic
from bang_jax.formats.graph import GraphIndex
from bang_jax.models.exactdistance import search_exact
from bang_jax.models.index import build_device_index
from bang_jax.models.inmemory import search_inmemory
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


@pytest.fixture(scope="module")
def loaded():
    d = synthetic.make_clustered_data(4000, 32, n_clusters=16, seed=9)
    adj, degrees = synthetic.build_knn_graph(d, 24, n_random=4, seed=9)
    pq = synthetic.train_pq(d, 16, seed=9)
    pq.codes = synthetic.encode_pq(d, pq)
    rng = np.random.default_rng(10)
    q = d[rng.integers(0, 4000, 32)] + rng.normal(0, 0.05, (32, 32)).astype(np.float32)
    gt_ids, gt_dists = synthetic.compute_groundtruth(d, q, 10)
    graph = GraphIndex(d, adj, degrees, synthetic.medoid_of(d))
    index = build_device_index(graph=graph, pq=pq)
    return index, q.astype(np.float32), gt_ids, gt_dists


@pytest.mark.parametrize("mode", ["exact", "bloom"])
def test_large_l_exact_variant(loaded, mode):
    index, q, gt_ids, gt_dists = loaded
    params = SearchParams(L=256, k=10, visited_mode=mode, extra_iters=50)
    ids, dists, stats = search_exact(index, q, params)
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 99.0, f"L=256 {mode} recall: {recall}"
    # with L far beyond the graph's reachable frontier the walk must
    # terminate by exhaustion, not the iteration cap
    assert stats.iters < params.max_iters


def test_large_l_inmemory_bloom_matches_exact(loaded):
    index, q, gt_ids, gt_dists = loaded
    r_by_mode = {}
    for mode in ("exact", "bloom"):
        params = SearchParams(L=256, k=10, visited_mode=mode)
        ids, _, _ = search_inmemory(index, q, params)
        r_by_mode[mode] = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert r_by_mode["exact"] >= 99.0, r_by_mode
    # bloom has false positives (skipped expansions) but at BF_ENTRIES cells
    # per query the loss at this scale must be marginal
    assert r_by_mode["bloom"] >= r_by_mode["exact"] - 1.5, r_by_mode


def test_max_l_accepted():
    from bang_jax.constants import MAX_L

    p = SearchParams(L=MAX_L, k=10)
    assert p.max_iters > MAX_L
    with pytest.raises(ValueError):
        SearchParams(L=MAX_L + 1, k=10)
