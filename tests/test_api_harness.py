"""Tests for the BANGSearch facade lifecycle and the harness CLI (SURVEY.md
§2 C1/C4 parity)."""

import numpy as np
import pytest

from bang_jax.api import BANGSearch
from bang_jax.formats import load_bin, load_truthset
from bang_jax.formats.preprocess import preprocess_queries_mips
from bang_jax.harness import driver
from bang_jax.utils.recall import calculate_recall


@pytest.mark.parametrize("variant", ["inmemory", "exactdistance", "base"])
def test_facade_lifecycle(tiny_index, variant):
    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)[:64]
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")

    engine = BANGSearch(variant=variant)
    assert engine.bang_load(prefix)
    engine.bang_set_searchparams(10, 64)
    engine.bang_alloc(64)
    engine.bang_init()
    ids, dists = engine.bang_query(queries)
    assert ids.shape == (64, 10) and ids.dtype == np.int64
    assert dists.shape == (64, 10)
    recall = calculate_recall(gt_ids[:64], ids, 10, gt_dists[:64])
    assert recall >= 88.0, f"{variant} facade recall: {recall}"
    engine.bang_free()
    engine.bang_unload()


def test_facade_validates():
    with pytest.raises(ValueError):
        BANGSearch(variant="nope")
    engine = BANGSearch(variant="inmemory")
    with pytest.raises(AssertionError):
        engine.bang_query(np.zeros((1, 4), np.float32))


def test_mips_preprocess_shape():
    q = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    out = preprocess_queries_mips(q)
    assert out.shape == (5, 9)
    np.testing.assert_allclose(np.linalg.norm(out[:, :8], axis=1), 1.0, rtol=1e-5)
    assert (out[:, 8] == 0).all()


def test_driver_single_mode(tiny_index, capsys):
    prefix = tiny_index["prefix"]
    rc = driver.main(
        [
            prefix,
            prefix + "_query.bin",
            prefix + "_gt.bin",
            "64",
            "10",
            "float",
            "l2",
            "--variant", "inmemory",
            "--mode", "single",
            "--L", "48",
            "--reps", "2",
            "--json",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "L\twall_ms\tQPS\trecall\trep" in out
    assert '"L": 48' in out
    # recall in the best row should be solid
    best_lines = [l for l in out.splitlines() if l.endswith("best")]
    assert len(best_lines) == 1
    recall = float(best_lines[0].split("\t")[3])
    assert recall >= 85.0


def test_driver_dataset_preset(tiny_index, capsys):
    """--dataset wires DATASET_PRESETS (the reference's parANN.h #define
    blocks): dim/dtype mismatches warn, auto mode starts at the preset L."""
    prefix = tiny_index["prefix"]
    rc = driver.main(
        [
            prefix, prefix + "_query.bin", prefix + "_gt.bin",
            "32", "10", "float", "l2",
            "--variant", "inmemory", "--mode", "single", "--L", "48",
            "--reps", "1", "--dataset", "sift10k",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "WARNING: index dim 48 != preset sift10k dim 128" in out

    import pytest as _pytest

    with _pytest.raises(SystemExit):
        driver.main(
            [prefix, prefix + "_query.bin", prefix + "_gt.bin",
             "32", "10", "float", "l2", "--dataset", "nope"]
        )


def test_driver_auto_sweep_target(tiny_index, capsys):
    prefix = tiny_index["prefix"]
    rc = driver.main(
        [
            prefix,
            prefix + "_query.bin",
            prefix + "_gt.bin",
            "32",
            "10",
            "float",
            "l2",
            "--variant", "exactdistance",
            "--mode", "auto",
            "--reps", "1",
            "--step", "24",
            "--max-L", "64",
            "--target-recall", "95.0",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("best") >= 1


def test_facade_partial_batch_no_recompile(tiny_index):
    """Batches smaller than bang_alloc's shape are padded, not recompiled."""
    prefix = tiny_index["prefix"]
    import numpy as np

    queries = load_bin(prefix + "_query.bin", np.float32)
    engine = BANGSearch(variant="exactdistance")
    engine.bang_load(prefix)
    engine.bang_set_searchparams(10, 32)
    engine.bang_alloc(64)
    ids_small, d_small = engine.bang_query(queries[:17])
    assert ids_small.shape == (17, 10)
    ids_full, _ = engine.bang_query(queries[:64])
    np.testing.assert_array_equal(ids_small, ids_full[:17])


def test_driver_interactive_mode(tiny_index, capsys, monkeypatch):
    """Interactive L-prompt loop (reference: 'Try Next run? [y|n]')."""
    prefix = tiny_index["prefix"]
    inputs = iter(["32", "q"])
    monkeypatch.setattr("builtins.input", lambda _: next(inputs))
    rc = driver.main(
        [
            prefix, prefix + "_query.bin", prefix + "_gt.bin",
            "32", "10", "float", "l2",
            "--variant", "exactdistance", "--mode", "interactive", "--reps", "1",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("best") == 1


def test_facade_oversized_batch_chunks(tiny_index):
    """Batches larger than the bang_alloc'd shape are split into
    compiled-shape chunks instead of triggering a silent recompile."""
    import numpy as np

    from bang_jax.api import BANGSearch

    s = BANGSearch(variant="inmemory")
    s.bang_load(tiny_index["prefix"])
    s.bang_set_searchparams(10, 24)
    s.bang_alloc(32)
    from bang_jax.formats.bin_io import load_bin_auto

    queries = load_bin_auto(tiny_index["prefix"] + "_query.bin", np.float32)
    queries = queries[:80].astype(np.float32)
    ids, dists = s.bang_query(queries)
    assert ids.shape == (80, 10) and dists.shape == (80, 10)
    ref_ids, _ = s.bang_query(queries[:32])
    np.testing.assert_array_equal(ids[:32], ref_ids)
