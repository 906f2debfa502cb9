"""Native Vamana builder: prune invariants + recall advantage over the
kNN+random baseline graph at equal degree."""

import numpy as np
import pytest

from bang_jax.formats import synthetic
from bang_jax.formats.graph import GraphIndex
from bang_jax.formats.vamana import build_vamana_graph
from bang_jax.models.index import build_device_index
from bang_jax.models.exactdistance import search_exact
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


@pytest.fixture(scope="module")
def data():
    d = synthetic.make_clustered_data(3000, 24, n_clusters=12, seed=4)
    rng = np.random.default_rng(5)
    q = d[rng.integers(0, 3000, 64)].astype(np.float32) + rng.normal(
        0, 0.05, (64, 24)
    ).astype(np.float32)
    gt_ids, gt_dists = synthetic.compute_groundtruth(d, q, 10)
    return d, q, gt_ids, gt_dists


def test_vamana_build_and_search(data):
    d, q, gt_ids, gt_dists = data
    adj, degrees, medoid = build_vamana_graph(d, r=20, l_build=32, batch=512, seed=0)
    assert adj.shape == (3000, 20)
    assert (adj >= 0).all() and (adj < 3000).all()

    graph = GraphIndex(d, adj, degrees, medoid)
    index = build_device_index(graph=graph)
    ids, _, stats = search_exact(index, q, SearchParams(L=48, k=10))
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 95.0, f"vamana recall@10: {recall}"


def test_vamana_beats_knn_at_small_L(data):
    """Pruned long-range edges should navigate better at tight budgets."""
    d, q, gt_ids, gt_dists = data
    adj_v, deg_v, medoid_v = build_vamana_graph(d, r=16, l_build=32, batch=512, seed=1)
    adj_k, deg_k = synthetic.build_knn_graph(d, 16, n_random=2, seed=1)

    params = SearchParams(L=20, k=10)
    r_v = calculate_recall(
        gt_ids,
        np.asarray(
            search_exact(
                build_device_index(graph=GraphIndex(d, adj_v, deg_v, medoid_v)), q, params
            )[0]
        ),
        10,
        gt_dists,
    )
    r_k = calculate_recall(
        gt_ids,
        np.asarray(
            search_exact(
                build_device_index(
                    graph=GraphIndex(d, adj_k, deg_k, synthetic.medoid_of(d))
                ),
                q,
                params,
            )[0]
        ),
        10,
        gt_dists,
    )
    assert r_v >= r_k - 2.0, (r_v, r_k)

def test_vamana_warm_start_truncated_seed(data):
    """The init= path used by scripts/build_10m_tuned.py: seed an R=12 build
    with the first 12 columns of an R=20 graph (robust prune emits edges
    nearest-first, so the truncated prefix is the greedy-best subset) and
    verify the warm build at low l_build reaches the quality of a colder,
    more expensive build."""
    d, q, gt_ids, gt_dists = data
    adj20, deg20, medoid = build_vamana_graph(d, r=20, l_build=32, batch=512, seed=0)
    init = (adj20[:, :12].copy(), np.minimum(deg20, 12))
    adj_w, deg_w, _ = build_vamana_graph(
        d, r=12, l_build=16, batch=512, seed=2, n_passes=1, init=init,
        medoid=medoid,
    )
    assert adj_w.shape == (3000, 12)
    assert (deg_w <= 12).all()
    adj_c, deg_c, _ = build_vamana_graph(
        d, r=12, l_build=16, batch=512, seed=2, n_passes=1, medoid=medoid
    )

    def recall_of(adj, deg):
        index = build_device_index(graph=GraphIndex(d, adj, deg, medoid))
        ids, _, _ = search_exact(index, q, SearchParams(L=24, k=10))
        return calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)

    r_warm, r_cold = recall_of(adj_w, deg_w), recall_of(adj_c, deg_c)
    assert r_warm >= r_cold - 1.0, (r_warm, r_cold)
    assert r_warm >= 85.0, r_warm

