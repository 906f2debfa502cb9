"""PQ lookup-accumulate as a Pallas kernel for the GPU (Triton route).

The Hopper form of the reference's `compute_neighborDist_par` PQ path
(BANG_Base/bang_search.cu:1201-1241), which runs one thread block per query
with that query's [m, 256] distance table in fast memory. Here each program
owns `tile_q` queries: it loads their [C, m] candidate codes as one block and
gathers the table entries of all C*m (candidate, chunk) pairs from the
query's own table, so each 64 KB table (m=64, f32) is read from device memory
once per lookup and every other access hits the SM's L1. Tables stay f32:
only the summation order differs from `ops/pq.pq_lookup`. A program takes at
most _LOOKUPS_PER_PROGRAM lookups: wide candidate sets (sampled entry points)
are split over a second grid axis, small ones pack as many queries as divide
Q, so the [Q, m, 256] tables are never copied to pad Q.

Triton wants power-of-two block shapes, so the wrapper pads the chunk axis
(with zero tables, which add nothing) and the candidate axis (sliced off).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# (candidate, chunk) lookups per program and warps per program: one query at
# C=128, m=64, 16 lookups per thread. On an H100 (1M-point inmemory search,
# PERF.md) 16 warps beat 4 and 8 and tied 32; 8192 lookups beat 4096 and
# 16384.
_LOOKUPS_PER_PROGRAM = 8192
_NUM_WARPS = 16


def resolve_pq_impl(impl: str) -> str:
    """The PQ lookup a search runs: 'auto' is the kernel on a GPU and the XLA
    gather (`ops/pq.pq_lookup`) anywhere else. An explicit 'pallas' off the
    GPU is an error: the kernel is compiled for the card only (tests reach
    it through `pq_lookup_pallas(..., interpret=True)`)."""
    gpu = jax.default_backend() == "gpu"
    if impl == "auto":
        return "pallas" if gpu else "xla"
    if impl == "pallas" and not gpu:
        raise ValueError(
            f"pq_impl='pallas' needs a GPU backend, got {jax.default_backend()!r}"
        )
    return impl


def _lookup_kernel(tables_ref, codes_ref, out_ref):
    # tables_ref [TQ, m, 256] f32; codes_ref [TQ, C, m] u8; out_ref [TQ, C]
    shape = codes_ref.shape
    q_idx = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    chunk = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    codes = codes_ref[...].astype(jnp.int32)
    out_ref[...] = tables_ref[q_idx, chunk, codes].sum(axis=2)


@functools.partial(jax.jit, static_argnames=("interpret",))
def pq_lookup_pallas(
    tables: jnp.ndarray, codes: jnp.ndarray, interpret: bool = False
) -> jnp.ndarray:
    """out[q, c] = sum_j tables[q, j, codes[q, c, j]] — `ops/pq.pq_lookup`'s
    contract. tables: [Q, m, 256] f32; codes: [Q, C, m] u8/int. Returns
    [Q, C] f32."""
    q, m, nc = tables.shape
    c = codes.shape[1]
    mp, cp = pl.next_power_of_2(m), pl.next_power_of_2(c)
    c_blk = min(cp, max(1, _LOOKUPS_PER_PROGRAM // mp))  # candidates/program
    # queries/program: a power of two that divides Q
    tile_q = math.gcd(q, max(1, _LOOKUPS_PER_PROGRAM // (c_blk * mp)))
    tables = tables.astype(jnp.float32)
    codes = codes.astype(jnp.uint8)
    if mp != m:
        tables = jnp.pad(tables, ((0, 0), (0, mp - m), (0, 0)))
    if (cp, mp) != (c, m):
        codes = jnp.pad(codes, ((0, 0), (0, cp - c), (0, mp - m)))
    out = pl.pallas_call(
        _lookup_kernel,
        grid=(q // tile_q, cp // c_blk),
        in_specs=[
            pl.BlockSpec((tile_q, mp, nc), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((tile_q, c_blk, mp), lambda i, j: (i, j, 0)),
        ],
        out_specs=pl.BlockSpec((tile_q, c_blk), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((q, cp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="pq_lookup",
    )(tables, codes)
    return out[:, :c]
