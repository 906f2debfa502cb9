"""Index bundle validation (load-time sanity parity, SURVEY.md §4.4)."""

import numpy as np

from bang_jax.utils.validate import validate_index


def test_validate_good_index(tiny_index):
    rep = validate_index(tiny_index["prefix"])
    assert rep.ok, rep.errors
    assert rep.n == tiny_index["n"]
    assert rep.chunks == tiny_index["m"]


def test_validate_detects_truncation(tiny_index, tmp_path):
    import shutil

    prefix = tiny_index["prefix"]
    bad = str(tmp_path / "bad")
    for suffix in ("_disk.bin", "_disk_metadata.bin", "_pq_pivots.bin", "_pq_compressed.bin"):
        shutil.copy(prefix + suffix, bad + suffix)
    with open(bad + "_disk.bin", "r+b") as f:
        f.truncate(1000)
    rep = validate_index(bad)
    assert not rep.ok
    assert any("size" in e for e in rep.errors)


def test_validate_missing_metadata(tmp_path):
    rep = validate_index(str(tmp_path / "nope"))
    assert not rep.ok


def test_validate_reports_reachability(tiny_index):
    from bang_jax.utils.validate import validate_index

    rep = validate_index(tiny_index["prefix"])
    assert rep.ok
    assert rep.reachable_fraction > 0.99
