"""Multi-parent (beam > 1) expansion: recall parity with beam=1 at equal
expansion budget, fewer sequential iterations, duplicate-free results."""

import numpy as np
import pytest

from bang_jax.formats import load_bin, load_truthset
from bang_jax.models.index import device_index_from_files
from bang_jax.models.exactdistance import search_exact
from bang_jax.models.inmemory import search_inmemory
from bang_jax.utils.config import SearchParams
from bang_jax.utils.recall import calculate_recall


@pytest.fixture(scope="module")
def loaded(tiny_index):
    prefix = tiny_index["prefix"]
    index = device_index_from_files(prefix, variant="inmemory")
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return index, queries, gt_ids, gt_dists


@pytest.mark.parametrize("beam", [2, 4])
def test_beam_exact_recall(loaded, tiny_index, beam):
    _, queries, gt_ids, gt_dists = loaded
    index = device_index_from_files(tiny_index["prefix"], variant="exactdistance")
    ids, _, stats = search_exact(index, queries, SearchParams(L=64, k=10, beam_width=beam))
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 95.0, f"beam={beam} recall: {recall}"
    # sequential iteration count drops ~beam-fold
    _, _, stats1 = search_exact(index, queries, SearchParams(L=64, k=10))
    assert stats.iters < stats1.iters


def test_beam_inmemory_recall_and_unique(loaded):
    index, queries, gt_ids, gt_dists = loaded
    ids, _, _ = search_inmemory(index, queries, SearchParams(L=64, k=10, beam_width=4))
    recall = calculate_recall(gt_ids, np.asarray(ids), 10, gt_dists)
    assert recall >= 90.0, f"beam=4 inmemory recall: {recall}"
    # no duplicate ids within any query's top-k
    arr = np.asarray(ids)
    for row in arr:
        assert len(set(row.tolist())) == len(row)


def test_beam_params_validation():
    with pytest.raises(ValueError):
        SearchParams(beam_width=0)
    with pytest.raises(ValueError):
        SearchParams(beam_width=32)
    p = SearchParams(L=64, k=10, beam_width=4, extra_iters=48)
    assert p.max_iters == 28
