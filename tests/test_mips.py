"""MIPS (maximum inner product) search via the +1-dim L2 reduction —
GloVe-style workload (SURVEY.md §2: DistFunc MIPS, bang.h:26-33)."""

import numpy as np

from bang_jax.formats import synthetic
from bang_jax.formats.graph import GraphIndex
from bang_jax.formats.preprocess import preprocess_data_mips, preprocess_queries_mips
from bang_jax.models.index import build_device_index
from bang_jax.models.exactdistance import search_exact
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


def test_mips_search_recall():
    rng = np.random.default_rng(0)
    n, d, k = 3000, 32, 10
    # clustered directions with varied norms (GloVe-like structure; pure
    # gaussian data has no navigable neighborhood structure for ANY graph ANN)
    data = synthetic.make_clustered_data(n, d, n_clusters=12, seed=0)
    data *= rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    queries = data[rng.integers(0, n, 64)] + rng.normal(
        0, 0.05, (64, d)
    ).astype(np.float32)

    # gold: true maximum-inner-product neighbors
    ip = queries @ data.T
    gt_ids = np.argsort(-ip, axis=1)[:, :k].astype(np.uint32)

    aug = preprocess_data_mips(data)
    adj, degrees = synthetic.build_knn_graph(aug, 24, n_random=4, seed=1)
    graph = GraphIndex(aug, adj, degrees, synthetic.medoid_of(aug))
    index = build_device_index(graph=graph)

    q_aug = preprocess_queries_mips(queries)
    ids, _, _ = search_exact(index, q_aug, SearchParams(L=64, k=k))
    recall = calculate_recall(gt_ids, np.asarray(ids), k)
    assert recall >= 90.0, f"MIPS recall@10: {recall}"


def test_mips_pq_inmemory_recall():
    """MIPS through the PQ traversal path (inmemory variant).

    The reference handles MIPS inside PQ-table construction by zero-padding
    the augmented dimension up to the chunk boundary
    (BANG_Base/bang_search.cu:1099-1113); here the codebook's chunk padding
    (ops/pq.prepare_pq_codebook) is the equivalent — this test proves the
    equivalence carries end-to-end recall, not just the exactdistance path
    covered above. dim 32+1=33 over m=16 chunks forces uneven chunk offsets.
    m matters: the MIPS unit-ball reduction compresses the distance spread,
    so PQ needs ~2 dims/chunk here (m=8 plateaus at ~85 recall with correct
    tables — measured, not a path bug; the reference similarly runs GloVe
    at CHUNKS=50, parANN.h:135-145)."""
    rng = np.random.default_rng(4)
    from bang_jax.models.inmemory import search_inmemory

    n, d, k = 3000, 32, 10
    data = synthetic.make_clustered_data(n, d, n_clusters=12, seed=0)
    data *= rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    queries = data[rng.integers(0, n, 64)] + rng.normal(
        0, 0.05, (64, d)
    ).astype(np.float32)
    ip = queries @ data.T
    gt_ids = np.argsort(-ip, axis=1)[:, :k].astype(np.uint32)

    aug = preprocess_data_mips(data)  # [n, 33]
    adj, degrees = synthetic.build_knn_graph(aug, 24, n_random=4, seed=1)
    graph = GraphIndex(aug, adj, degrees, synthetic.medoid_of(aug))
    pq = synthetic.train_pq(aug, 16, seed=3)
    pq.codes = synthetic.encode_pq(aug, pq)
    index = build_device_index(graph=graph, pq=pq)

    q_aug = preprocess_queries_mips(queries)
    ids, _, _ = search_inmemory(
        index, q_aug,
        SearchParams(L=96, k=k, beam_width=2, extra_iters=12),
    )
    recall = calculate_recall(gt_ids, np.asarray(ids), k)
    assert recall >= 90.0, f"MIPS PQ-inmemory recall@10: {recall}"


def test_int8_dataset():
    """int8 vectors (SPACEV-style dtype, bang.h:85-87)."""
    data = synthetic.make_clustered_data(2000, 24, n_clusters=8, dtype=np.int8, seed=2)
    queries = data[:50].astype(np.float32)
    gt_ids, gt_dists = synthetic.compute_groundtruth(data, queries, 10)
    adj, degrees = synthetic.build_knn_graph(data, 20, n_random=4, seed=2)
    graph = GraphIndex(data, adj, degrees, synthetic.medoid_of(data))
    index = build_device_index(graph=graph)
    ids, _, _ = search_exact(index, queries, SearchParams(L=48, k=10))
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 95.0, f"int8 recall@10: {recall}"
