"""Tests that need the card: the PQ lookup kernel as compiled for the GPU.
They skip elsewhere (the kernel's arithmetic is tested in interpret mode in
test_pq_kernel.py); chip_smoke.py runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bang_jax.ops.pq import pq_lookup
from bang_jax.ops.pq_pallas import pq_lookup_pallas, resolve_pq_impl

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU form")


@pytest.mark.parametrize("q, m, c", [(1000, 64, 128), (333, 120, 256), (64, 64, 1000)])
def test_compiled_kernel_matches_pq_lookup(gpu, q, m, c):
    rng = np.random.default_rng(q)
    tables = jnp.asarray(np.abs(rng.normal(size=(q, m, 256))).astype(np.float32))
    codes = jnp.asarray(rng.integers(0, 256, (q, c, m)).astype(np.uint8))
    got = np.asarray(pq_lookup_pallas(tables, codes))
    want = np.asarray(jax.jit(pq_lookup)(tables, codes))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_auto_resolves_to_kernel_on_gpu(gpu):
    assert resolve_pq_impl("auto") == "pallas"
