"""Tests for recall (tie expansion), config validation, timers."""

import numpy as np
import pytest

from bang_jax.utils.config import SearchParams, DATASET_PRESETS
from bang_jax.utils.recall import calculate_recall
from bang_jax.utils.timer import CPUTimer, StageTimers


def test_recall_perfect():
    gt = np.arange(20).reshape(2, 10).astype(np.uint32)
    res = gt.copy()
    assert calculate_recall(gt, res, 10) == 100.0


def test_recall_half():
    gt = np.arange(10)[None, :].astype(np.uint32)
    res = np.concatenate([gt[0, :5], np.arange(100, 105)])[None, :]
    assert calculate_recall(gt, res, 10) == 50.0


def test_recall_tie_expansion():
    # gold entries 9..12 tie at the k-th distance: any of them counts
    # (reference behavior: test_driver.cpp:58-67)
    gt_ids = np.arange(14)[None, :].astype(np.uint32)
    gt_dists = np.concatenate([np.arange(9), [9.0, 9.0, 9.0, 9.0], [20.0]])[None, :]
    res = np.concatenate([np.arange(9), [12]])[None, :]  # returns a tied id
    assert calculate_recall(gt_ids, res, 10, gt_dists) == 100.0
    # without distances, no expansion: id 12 not in top-10 gold
    assert calculate_recall(gt_ids, res, 10) == 90.0


def test_search_params_validation():
    with pytest.raises(ValueError):
        SearchParams(L=0)
    with pytest.raises(ValueError):
        SearchParams(L=600)
    with pytest.raises(ValueError):
        SearchParams(L=10, k=20)
    with pytest.raises(ValueError):
        SearchParams(visited_mode="nope")
    p = SearchParams(L=64, k=10)
    assert p.max_iters == 114


def test_presets():
    assert DATASET_PRESETS["sift1b"].chunks == 74
    assert DATASET_PRESETS["deep1b"].dim == 96


def test_timers():
    t = CPUTimer()
    t.start()
    dt = t.stop()
    assert dt >= 0 and t.total_ms >= dt
    st = StageTimers()
    with st.stage("x"):
        pass
    assert "x" in st.ms and st.report()
    off = StageTimers(enabled=False)
    with off.stage("y"):
        pass
    assert "y" not in off.ms


def test_search_stats_lazy_sync():
    """SearchStats defers the device fetch and caches after one sync."""
    import jax.numpy as jnp

    from bang_jax.models.traversal import SearchStats

    st = SearchStats(jnp.int32(7), jnp.int32(21), jnp.int32(140))
    assert "unsynced" in repr(st)
    assert st.iters == 7  # first access fetches all three in one trip
    assert "unsynced" not in repr(st)
    assert st.n_expanded == 21 and st.n_dist_comps == 140
    # int-constructed stats are considered already fetched
    st2 = SearchStats(3, 4, 5)
    assert st2.iters == 3 and st2.n_dist_comps == 5
