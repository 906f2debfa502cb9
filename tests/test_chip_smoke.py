"""chip_smoke.py's parts that run anywhere: the device check, the host
float64 ground-truth check and the per-shard comparison merge. The smoke
itself runs only on a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from bang_jax.formats.accel import compute_groundtruth_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.check_device(jax.devices())
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit):
        chip_smoke.check_device([])


def test_smoke_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert not os.path.exists(os.path.join(tmp_path, "bench_data"))


def test_groundtruth_check_accepts_device_gt_and_rejects_wrong():
    data, queries = chip_smoke.make_corpus(3000, 20, seed=4)
    gt_ids, gt_d = compute_groundtruth_jax(data, queries.astype(np.float32), 100)
    assert chip_smoke.check_groundtruth(data, queries, gt_ids, gt_d) == 100.0
    bad = gt_ids.copy()
    bad[:, 0] = (bad[:, 0] + 1) % len(data)
    bad_d = gt_d.copy()
    bad_d[0, 0] += 1.0
    with pytest.raises(AssertionError):
        chip_smoke.check_groundtruth(data, queries, gt_ids, bad_d)
    with pytest.raises(RuntimeError):
        chip_smoke.check_groundtruth(data, queries, bad, gt_d)


def test_shards_on_one_device_match_mesh_search():
    """The four-card comparison: each shard searched on one device and
    merged on the host equals the (1, 4)-mesh search."""
    from bang_jax.parallel.partition import build_sharded_index
    from bang_jax.parallel.sharded import make_mesh, search_sharded
    from bang_jax.utils.config import SearchParams

    data, queries = chip_smoke.make_corpus(2000, 24, seed=6)
    si = build_sharded_index(data, n_shards=4, r=16, m=8, seed=6)
    params = SearchParams(L=24, k=10, beam_width=2)
    ids4, _ = search_sharded(make_mesh(1, 4), si, queries, params)
    one = make_mesh(1, 1, devices=jax.devices()[:1])
    parts = [search_sharded(one, chip_smoke.shard_slice(si, s), queries, params)
             for s in range(4)]
    all_ids = np.concatenate([np.asarray(p[0]) for p in parts], axis=1)
    all_d = np.concatenate([np.asarray(p[1]) for p in parts], axis=1)
    ids1 = np.take_along_axis(all_ids, np.argsort(all_d, axis=1, kind="stable"), 1)
    assert chip_smoke.overlap(np.asarray(ids4), ids1) == 1.0
