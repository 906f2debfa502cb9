"""Serving scheduler: arbitrary query-stream sizes through one compiled batch."""

import numpy as np

from bang_jax.formats import load_bin, load_truthset
from bang_jax.harness.serving import SearchServer
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


def test_server_stream(tiny_index):
    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")

    server = SearchServer(
        prefix, variant="inmemory", batch_size=48, params=SearchParams(L=48, k=10)
    )
    # 100 queries through 48-size batches (2 full + 1 partial)
    ids, dists = server.query(queries[:100])
    assert ids.shape == (100, 10)
    recall = calculate_recall(gt_ids[:100], ids, 10, gt_dists[:100])
    assert recall >= 88.0, recall
    pct = server.latency_percentiles()
    assert pct["p50"] > 0 and pct["p99"] >= pct["p50"]
    server.close()


def test_device_batch_latency_probe(tiny_index):
    from bang_jax.harness.serving import measure_device_batch_latency
    from bang_jax.models.index import device_index_from_files

    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)[:32]
    for variant in ("inmemory", "exactdistance"):
        index = device_index_from_files(prefix, variant=variant)
        ms = measure_device_batch_latency(
            index, queries, SearchParams(L=24, k=10), variant=variant, n_chain=3
        )
        assert np.isfinite(ms) and ms >= 0.0
