"""PQ lookup kernel (ops/pq_pallas): interpret-mode arithmetic against the
plain XLA lookup, the wrapper's padding and tiling, and the choice of kernel.
The compiled kernel runs only on a GPU (chip_smoke.py checks it there)."""

import jax.numpy as jnp
import numpy as np
import pytest

from bang_jax.ops.pq import pq_lookup
from bang_jax.ops.pq_pallas import pq_lookup_pallas, resolve_pq_impl
from bang_jax.utils.config import SearchParams


def _case(q, m, c, seed=0):
    rng = np.random.default_rng(seed)
    tables = jnp.asarray(rng.normal(size=(q, m, 256)).astype(np.float32))
    codes = jnp.asarray(rng.integers(0, 256, (q, c, m)).astype(np.uint8))
    return tables, codes


@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("m", [8, 32, 64, 120])
def test_kernel_matches_pq_lookup(m, c):
    # Q=37 shares no factor with the queries a program packs at small C*m,
    # and m=120 pads the chunk axis to 128
    tables, codes = _case(37, m, c)
    got = np.asarray(pq_lookup_pallas(tables, codes, interpret=True))
    want = np.asarray(pq_lookup(tables, codes))
    assert got.shape == (37, c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_kernel_packs_queries_that_divide_q():
    """At C=1 (the entry-point distance) a program packs the largest power
    of two of queries that divides Q: 48 queries run as 3 programs of 16."""
    tables, codes = _case(48, 64, 1, seed=2)
    got = np.asarray(pq_lookup_pallas(tables, codes, interpret=True))
    np.testing.assert_allclose(got, np.asarray(pq_lookup(tables, codes)),
                               rtol=1e-5, atol=1e-4)


def test_kernel_wide_candidates_split_over_grid():
    """C*m above one program's lookups (sampled entry points, C=1000)
    splits the candidates over a second grid axis; C pads to 1024."""
    tables, codes = _case(3, 64, 1000, seed=1)
    got = np.asarray(pq_lookup_pallas(tables, codes, interpret=True))
    np.testing.assert_allclose(got, np.asarray(pq_lookup(tables, codes)),
                               rtol=1e-5, atol=1e-4)


def test_resolve_auto_is_xla_on_cpu():
    assert resolve_pq_impl("auto") == "xla"
    assert resolve_pq_impl("xla") == "xla"


def test_explicit_kernel_on_cpu_raises():
    with pytest.raises(ValueError, match="GPU"):
        resolve_pq_impl("pallas")


def test_search_params_pq_impl_values():
    for impl in ("auto", "pallas", "xla"):
        SearchParams(pq_impl=impl)
    with pytest.raises(ValueError):
        SearchParams(pq_impl="pallas_dma")
