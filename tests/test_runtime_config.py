"""What the program reads from its environment and its device: the compile
cache directory, memory budgets derived from the device's limit, and the
trace reduction."""

import jax
import numpy as np
import pytest

from bang_jax.models import index as index_mod
from bang_jax.utils import cache


@pytest.fixture
def config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_dir_from_env_sets_no_directory(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_updates


def test_cache_dir_default_in_checkout(monkeypatch, tmp_path, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(tmp_path / "jax_cache"))
    path = cache.enable_persistent_cache()
    assert path == str(tmp_path / "jax_cache")
    assert config_updates["jax_compilation_cache_dir"] == path
    assert (tmp_path / "jax_cache").is_dir()


def test_layout_budgets_from_limit():
    nbr, fused = index_mod.layout_budgets(80_000_000_000)
    assert nbr == pytest.approx(index_mod.NEIGHBOR_LAYOUT_SHARE * 80e9)
    assert fused == pytest.approx(index_mod.FUSED_LAYOUT_SHARE * 80e9)
    assert nbr < fused < 80e9


def test_no_reported_limit_means_no_budget():
    # the CPU backend reports no allocator limit
    assert index_mod.device_bytes_limit() is None
    assert index_mod.layout_budgets(None) == (float("inf"), float("inf"))
    from bang_jax.formats.bigbuild import shard_memory_budget

    assert shard_memory_budget() == float("inf")


def test_small_device_limit_selects_plain_layout(tiny_index, monkeypatch):
    """A device too small for the R x layouts gets the plain adjacency +
    codes; a roomy one gets the fused rows."""
    monkeypatch.setattr(index_mod, "device_bytes_limit", lambda device=None: 1_000_000)
    small = index_mod.device_index_from_files(tiny_index["prefix"])
    assert small.fused_rows is None and small.nbr_codes is None
    assert small.adj is not None
    monkeypatch.setattr(index_mod, "device_bytes_limit", lambda device=None: 80 * 10**9)
    roomy = index_mod.device_index_from_files(tiny_index["prefix"])
    assert roomy.fused_rows is not None and roomy.adj is None


@pytest.mark.parametrize("intervals, want", [
    ([(0, 10), (5, 15), (20, 30)], 25),
    ([(0, 10), (2, 3), (10, 12)], 12),
    ([], 0),
])
def test_trace_union_of_intervals(intervals, want):
    from bang_jax.utils.trace import union_ns

    assert union_ns(intervals) == want


def test_device_pq_training_matches_host_quality():
    from bang_jax.formats import synthetic
    from bang_jax.formats.accel import encode_pq_jax, train_pq_jax

    data = synthetic.make_clustered_data(6000, 32, n_clusters=16, dtype=np.uint8, seed=2)

    def error(pq):
        codes = encode_pq_jax(data, pq)
        rec = np.zeros(data.shape, np.float32)
        for c in range(pq.num_chunks):
            lo, hi = pq.chunk_offsets[c], pq.chunk_offsets[c + 1]
            rec[:, lo:hi] = pq.pivots[codes[:, c], lo:hi]
        return float(((data - pq.centroid - rec) ** 2).sum(1).mean())

    dev = synthetic.train_pq(data, 8, seed=2)
    jx = train_pq_jax(data, 8, seed=2)
    assert jx.pivots.shape == dev.pivots.shape
    np.testing.assert_array_equal(jx.chunk_offsets, dev.chunk_offsets)
    assert error(jx) <= 1.05 * error(dev)
