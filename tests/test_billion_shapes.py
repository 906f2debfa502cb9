"""Billion-scale program validation (compile-time, no data).

The reference's headline is SIFT1B on one A100-80GB (Cost_Analysis.pdf p.2;
bang_search.cu:311-328 keeps the 640 GB graph host-side and the PQ codes on
device). Next to tables and search state, 1B x m codes do not fit one
80 GB card, so the billion-point configuration here is the chunk-sharded
Base variant
(parallel/base_tp.py): codes split over the mesh's 'model' axis, one psum
per step. Real 1B arrays don't fit this box either — but the PROGRAM at 1B
shapes is fully determined at trace time, so AOT-lowering it with
ShapeDtypeStructs proves the billion-scale path traces, shards and compiles
exactly as it would on real devices (XLA allocates nothing at compile
time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from bang_jax.models.base import BaseState
from bang_jax.parallel.base_tp import make_base_step_tp

SDS = jax.ShapeDtypeStruct

N = 1_000_000_000  # SIFT1B
D = 128
M = 32  # PQ chunks (codes = 32 GB; 4 GB per device on the 8-device mesh)
R = 64  # reference MAX_R (bang_search.cu:35)
Q = 1024  # one pipelined sub-batch
L = 128
BEAM = 2
MAX_ITERS = L + 50  # reference maxIters headroom (bang_search.cu:53-54)


def _state_sds(q, l, max_iters, beam):
    mi = max_iters * beam
    return BaseState(
        wl_dist=SDS((q, l), jnp.float32),
        wl_ids=SDS((q, l), jnp.int32),
        wl_vis=SDS((q, l), jnp.bool_),
        parent_valid=SDS((q, beam), jnp.bool_),
        visited_ids=SDS((q, mi), jnp.int32),
        l2_dists=SDS((q, mi), jnp.float32),
        bloom=None,
        active=SDS((q,), jnp.bool_),
        it=SDS((), jnp.int32),
    )


@pytest.mark.parametrize("model_axis", [4])
def test_base_tp_step_lowers_at_1b(model_axis):
    devs = np.array(jax.devices()[: 2 * model_axis]).reshape(2, model_axis)
    mesh = Mesh(devs, ("data", "model"))
    step = make_base_step_tp(mesh)
    m_loc = M // model_axis
    lowered = step.lower(
        _state_sds(Q, L, MAX_ITERS, BEAM),
        SDS((Q, BEAM * R), jnp.int32),          # host-gathered neighbor ids
        SDS((Q, BEAM, D), jnp.float32),         # parent FP rows
        SDS((Q, D), jnp.float32),               # queries
        SDS((model_axis, Q, m_loc, 256), jnp.float32),  # sharded PQ tables
        SDS((model_axis, N, m_loc), jnp.uint8),         # sharded codes @ 1B
        use_bloom=False,
        beam=BEAM,
    )
    hlo = lowered.as_text()
    # the chunk-sharded lookup must reduce partial sums across devices
    # (StableHLO spells it all_reduce; optimized HLO all-reduce)
    assert "all_reduce" in hlo or "all-reduce" in hlo, hlo[:800]
    # compile validates buffer assignment and the collective lowering; XLA
    # allocates no data for this (inputs are only shapes)
    compiled = lowered.compile()
    assert compiled is not None


def test_single_chip_base_step_traces_at_1b():
    """The single-chip Base step (models/base.py) also traces at 1B shapes —
    eval_shape proves shape/dtype consistency of the full iteration at the
    reference's scale without allocating the 32 GB code matrix."""
    from bang_jax.models.base import _base_step

    out = jax.eval_shape(
        lambda s, nb, pf, qf, t, c: _base_step(
            s, nb, pf, qf, t, c, use_bloom=True, pq_impl="xla", beam=1
        ),
        _state_sds_bloom(Q, L, MAX_ITERS, 1),
        SDS((Q, R), jnp.int32),
        SDS((Q, 1, D), jnp.float32),
        SDS((Q, D), jnp.float32),
        SDS((Q, M, 256), jnp.float32),
        SDS((N, M), jnp.uint8),
    )
    new_state, parents, cont = out
    assert new_state.wl_ids.shape == (Q, L)
    assert parents.shape == (Q, 1)
    assert cont.shape == ()


def _state_sds_bloom(q, l, max_iters, beam):
    from bang_jax.constants import BF_ENTRIES

    s = _state_sds(q, l, max_iters, beam)
    return s._replace(bloom=SDS((q, BF_ENTRIES), jnp.uint8))
