"""Streaming index (insert / lazy delete / consolidate) — the FreshVamana-
style mutable-index capability on top of the device-resident build machinery
(models/streaming.py). Beyond the reference (which searches a frozen index);
test thresholds mirror tests/test_vamana.py's build-quality pins."""

import numpy as np
import pytest

from bang_jax.constants import INVALID_ID
from bang_jax.models.streaming import StreamingIndex
from bang_jax.utils.config import SearchParams


N, DIM, R = 3000, 24, 16
PARAMS = SearchParams(L=32, k=10, extra_iters=32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    # clustered data (uniform is pathological for graph ANN at tiny n)
    centers = rng.normal(size=(30, DIM)) * 4.0
    pts = centers[rng.integers(0, 30, N)] + rng.normal(size=(N, DIM))
    queries = centers[rng.integers(0, 30, 200)] + rng.normal(size=(200, DIM))
    return pts.astype(np.float32), queries.astype(np.float32)


def brute_topk(pts, live_ids, queries, k):
    sub = pts[live_ids]
    d = ((queries[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    return live_ids[np.argsort(d, axis=1)[:, :k]]


def recall_against(ids, gt):
    hits = sum(
        len(set(r.tolist()) & set(g.tolist())) for r, g in zip(ids, gt)
    )
    return 100.0 * hits / gt.size


def test_streaming_insert_from_empty(data):
    pts, queries = data
    ix = StreamingIndex(capacity=N + 64, dim=DIM, r=R, l_build=24)
    for s in range(0, N, 500):
        ix.insert(pts[s : s + 500])
    assert ix.n_live == N
    ids, dists = ix.search(queries, PARAMS)
    gt = brute_topk(pts, np.arange(N), queries, 10)
    rec = recall_against(ids, gt)
    assert rec >= 85.0, rec
    # returned distances are exact squared L2
    d0 = ((queries - pts[ids[:, 0]]) ** 2).sum(-1)
    np.testing.assert_allclose(dists[:, 0], d0, rtol=1e-4)


@pytest.fixture(scope="module")
def built(data):
    pts, _ = data
    from bang_jax.formats.vamana import build_vamana_graph

    adj, deg, medoid = build_vamana_graph(
        pts[:2000], r=R, l_build=24, batch=500, verbose=False
    )
    return adj, deg, medoid


def test_insert_after_built(data, built):
    pts, queries = data
    adj, deg, medoid = built
    ix = StreamingIndex.from_built(
        pts[:2000], adj, deg, medoid, capacity=N, l_build=24
    )
    new_ids = []
    for s in range(2000, N, 250):
        new_ids.extend(ix.insert(pts[s : s + 250]).tolist())
    assert new_ids == list(range(2000, N))  # contiguous growth
    ids, _ = ix.search(queries, PARAMS)
    gt = brute_topk(pts, np.arange(N), queries, 10)
    rec = recall_against(ids, gt)
    assert rec >= 85.0, rec
    # late inserts are actually discoverable (not orphaned): queries whose
    # true NN is a new point must mostly find it
    nn = gt[:, 0]
    late = nn >= 2000
    if late.sum() >= 5:
        found = (ids[late] == nn[late, None]).any(axis=1).mean()
        assert found >= 0.7, found


def test_delete_filters_results(data, built):
    pts, queries = data
    adj, deg, medoid = built
    ix = StreamingIndex.from_built(
        pts[:2000], adj, deg, medoid, capacity=N, l_build=24
    )
    gt_all = brute_topk(pts, np.arange(2000), queries, 10)
    victims = np.unique(gt_all[:, 0])[:100]  # delete many true NNs
    ix.delete(victims)
    assert ix.n_live == 2000 - len(victims)
    ids, _ = ix.search(queries, PARAMS)
    assert not np.isin(ids, victims).any(), "tombstone leaked into results"
    live = np.setdiff1d(np.arange(2000), victims)
    gt_live = brute_topk(pts, live, queries, 10)
    rec = recall_against(ids, gt_live)
    assert rec >= 80.0, rec


def test_consolidate_frees_and_repairs(data, built):
    pts, queries = data
    adj, deg, medoid = built
    ix = StreamingIndex.from_built(
        pts[:2000], adj, deg, medoid, capacity=2200, l_build=24
    )
    rng = np.random.default_rng(3)
    victims = rng.choice(2000, 400, replace=False).astype(np.int32)
    ix.delete(victims)
    repaired = ix.consolidate(batch=512)
    assert repaired > 0
    assert sorted(ix.free) == sorted(victims.tolist())
    # no surviving edge points at a tombstone
    import jax

    adj_now = np.asarray(jax.device_get(ix.adj[:2000]))
    live_mask = np.ones(2000, bool)
    live_mask[victims] = False
    live = np.flatnonzero(live_mask)
    assert live_mask[adj_now[live]].all(), "edge into tombstone survived"
    # search quality holds after repair
    ids, _ = ix.search(queries, PARAMS)
    gt_live = brute_topk(pts, live, queries, 10)
    assert recall_against(ids, gt_live) >= 80.0
    # freed slots are recycled by the next insert, and become findable again
    re_ids = ix.insert(pts[victims[:50]])
    assert set(re_ids.tolist()) <= set(victims.tolist())
    assert ix.n_live == 2000 - 400 + 50
    q2 = pts[victims[:20]]
    ids2, _ = ix.search(q2.astype(np.float32), PARAMS)
    self_found = (ids2 == re_ids[:20, None]).any(axis=1).mean()
    assert self_found >= 0.9, self_found


def test_capacity_guard(data):
    pts, _ = data
    ix = StreamingIndex(capacity=100, dim=DIM, r=8, l_build=16)
    ix.insert(pts[:100])
    with pytest.raises(ValueError, match="capacity"):
        ix.insert(pts[100:101])


def test_invalid_padding_when_k_exceeds_live(data):
    pts, _ = data
    ix = StreamingIndex(capacity=64, dim=DIM, r=8, l_build=16)
    ix.insert(pts[:5])
    ids, dists = ix.search(pts[:2], SearchParams(L=16, k=10, extra_iters=16))
    assert (ids != INVALID_ID).sum(axis=1).max() <= 5
    assert np.isinf(dists[:, 5:]).all()
