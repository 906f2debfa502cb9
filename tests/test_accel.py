"""Accelerated builders must match the numpy reference implementations."""

import numpy as np

from bang_jax.formats import synthetic
from bang_jax.formats.accel import (
    build_knn_graph_jax,
    compute_groundtruth_jax,
    encode_pq_jax,
)


def test_groundtruth_matches_numpy():
    data = synthetic.make_clustered_data(3000, 24, n_clusters=8, seed=0)
    q = data[:50].astype(np.float32) + 0.01
    ids_np, d_np = synthetic.compute_groundtruth(data, q, 5)
    ids_j, d_j = compute_groundtruth_jax(data, q, 5, block=32)
    np.testing.assert_allclose(d_j, d_np, rtol=1e-4, atol=1e-3)
    # ids may differ on exact ties; distances define correctness
    same = (ids_j == ids_np).mean()
    assert same > 0.99


def test_knn_graph_rows_unique():
    data = synthetic.make_clustered_data(1000, 16, n_clusters=4, seed=1)
    adj, degrees = build_knn_graph_jax(data, 12, n_random=2, seed=1, block=128)
    assert adj.shape == (1000, 12)
    assert (degrees == 12).all()
    # rows contain no duplicate non-self ids (self id = padding convention)
    for i in range(0, 1000, 37):
        row = adj[i][adj[i] != i]
        assert len(set(row.tolist())) == len(row)
    # kNN part should match numpy's neighbor sets closely
    adj_np, _ = synthetic.build_knn_graph(data, 12, n_random=2, seed=1)
    overlap = np.mean(
        [len(set(adj[i, :10]) & set(adj_np[i, :10])) / 10 for i in range(200)]
    )
    assert overlap > 0.9, overlap


def test_encode_pq_matches_numpy():
    data = synthetic.make_clustered_data(2000, 20, n_clusters=8, seed=2)
    pq = synthetic.train_pq(data, m=5, seed=2)
    codes_np = synthetic.encode_pq(data, pq)
    codes_j = encode_pq_jax(data, pq, block=512)
    agree = (codes_np == codes_j).mean()
    assert agree > 0.995, agree


def test_pruned_knn_graph_navigates_better():
    """Alpha-pruned kNN graph should match or beat plain kNN recall at a
    tight budget (the pruning keeps diverse/long edges)."""
    import jax.numpy as jnp

    from bang_jax.formats.accel import build_pruned_knn_graph_jax
    from bang_jax.formats.graph import GraphIndex
    from bang_jax.models.index import build_device_index
    from bang_jax.models.exactdistance import search_exact
    from bang_jax.utils.config import SearchParams
    from bang_jax.utils.recall import calculate_recall

    data = synthetic.make_clustered_data(8000, 32, n_clusters=40, seed=9)
    rng = np.random.default_rng(10)
    q = data[rng.integers(0, 8000, 128)].astype(np.float32) + rng.normal(
        0, 0.05, (128, 32)
    ).astype(np.float32)
    gt_ids, gt_dists = synthetic.compute_groundtruth(data, q, 10)

    params = SearchParams(L=24, k=10)

    adj_p, deg_p = build_pruned_knn_graph_jax(data, 16, seed=2, block=512)
    assert (adj_p >= 0).all() and (adj_p < 8000).all()
    r_pruned = calculate_recall(
        gt_ids,
        np.asarray(
            search_exact(
                build_device_index(
                    graph=GraphIndex(data, adj_p, deg_p, synthetic.medoid_of(data))
                ),
                q,
                params,
            )[0]
        ),
        10,
        gt_dists,
    )
    adj_k, deg_k = build_knn_graph_jax(data, 16, n_random=4, seed=2, block=512)
    r_knn = calculate_recall(
        gt_ids,
        np.asarray(
            search_exact(
                build_device_index(
                    graph=GraphIndex(data, adj_k, deg_k, synthetic.medoid_of(data))
                ),
                q,
                params,
            )[0]
        ),
        10,
        gt_dists,
    )
    assert r_pruned >= r_knn - 1.0, (r_pruned, r_knn)
