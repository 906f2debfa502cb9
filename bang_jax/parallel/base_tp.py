"""Chunk-sharded Base variant: host-RAM graph + PQ codes split across chips.

For code matrices larger than one card's memory: at SIFT1B x m=74 the codes
alone are 74 GB, which the reference holds on one 80 GB A100
(bang_search.cu:232-240) and which leaves an 80 GB H100 nothing for tables
and state (a JAX process takes 60 GB of it by default). This keeps the Base
design — graph in host RAM, host-threaded adjacency gather,
software-pipelined sub-batches — and shards the PQ **chunk axis** over the
mesh's 'model' axis: device i holds codes[:, i*m/S:(i+1)*m/S] (18.5 GB per
card on 4 cards) and the matching distance-table slice; each step computes
its partial lookup sum and one `psum` over NVLink yields full distances.
Per-iteration communication is a [Q, C] f32 reduction — independent of m and
N. Everything else (dedup, worklist merge, parent selection) runs
replicated, reusing models/base.py's step core verbatim.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bang_jax.models.base import BaseVariantSearcher, _step_core
from bang_jax.ops.pq import pq_distance_tables, pq_lookup
from bang_jax.ops.pq_pallas import pq_lookup_pallas
from bang_jax.parallel.pq_tp import shard_codes_by_chunk, shard_tables_by_chunk


def make_base_step_tp(mesh: Mesh, pq_impl: str = "xla"):
    """Build the chunk-sharded device step for `mesh` (axes: 'data','model').

    pq_impl selects the per-shard lookup, resolved by the caller
    (ops/pq_pallas.resolve_pq_impl): 'xla' (take_along_axis) or 'pallas'
    (the GPU kernel the single-card path runs, here applied to each card's
    chunk slice inside shard_map). Tables are f32 [S, Q, m/S, 256].
    """
    lookup = pq_lookup_pallas if pq_impl == "pallas" else pq_lookup

    @functools.partial(
        jax.jit, static_argnames=("use_bloom", "beam"), donate_argnums=(0,)
    )
    def step_tp(state, nbrs, parent_fp, queries_f32, tables_sharded,
                codes_sharded, use_bloom, beam):
        def partial_lookup(tables, codes, cand):
            local = codes[0][cand]  # [Q, C, m_local] this card's chunk slice
            return jax.lax.psum(lookup(tables[0], local), "model")

        raw = jax.shard_map(
            partial_lookup,
            mesh=mesh,
            in_specs=(P("model"), P("model"), P()),
            out_specs=P(),
            check_vma=False,
        )(tables_sharded, codes_sharded, nbrs)
        return _step_core(state, nbrs, parent_fp, queries_f32, raw, use_bloom, beam)

    return step_tp


def make_sampled_entry_tp(mesh: Mesh, pq_impl: str = "xla"):
    """Chunk-sharded sampled-entry selector (models/base._sampled_entry_base
    for code matrices that don't fit one chip).

    Ranking samples by PQ distance IS a PQ lookup: d[q, s] = sum over chunks
    of table[q, c, codes[s, c]] — so the selector reuses the step's
    distributed machinery verbatim (per-shard partial lookup over the card's
    chunk slice, one psum over NVLink), then a replicated top-B picks the
    entries. Communication: one [Q, S_samples] f32 reduction per search.
    """
    lookup = pq_lookup_pallas if pq_impl == "pallas" else pq_lookup

    @functools.partial(jax.jit, static_argnames=("n_samples", "b"))
    def entry_tp(tables_sharded, codes_sharded, n_samples, b):
        n = codes_sharded.shape[1]
        q = tables_sharded.shape[1]
        s_n = int(min(n_samples, n))
        stride = max(1, n // s_n)
        ids = (jnp.arange(s_n, dtype=jnp.int32) * stride) % n
        cand = jnp.broadcast_to(ids[None, :], (q, s_n))

        def partial_lookup(tables, codes, cand):
            local = codes[0][cand]  # [Q, S_samples, m_local]
            return jax.lax.psum(lookup(tables[0], local), "model")

        d = jax.shard_map(
            partial_lookup,
            mesh=mesh,
            in_specs=(P("model"), P("model"), P()),
            out_specs=P(),
            check_vma=False,
        )(tables_sharded, codes_sharded, cand)
        if b == 1:
            idx = jnp.argmin(d, axis=1)[:, None]
        else:
            _, idx = jax.lax.top_k(-d, min(b, s_n))
        out = ids[idx]
        if b > out.shape[1]:
            out = jnp.concatenate(
                [out, jnp.broadcast_to(out[:, :1], (out.shape[0], b - out.shape[1]))],
                axis=1,
            )
        return out

    return entry_tp


class ShardedBaseSearcher(BaseVariantSearcher):
    """BaseVariantSearcher with codes/tables chunk-sharded over `mesh`.

    Drop-in: same search() host loop, pipelining, timers and finish path —
    only table preparation and the device step differ.
    """

    def __init__(self, prefix: str, mesh: Mesh, **kwargs):
        # codes stay host-side through the parent init (the whole point of
        # this class is a code matrix too big for ONE card's memory — staging
        # it on one device before sharding would OOM at the target scale);
        # only per-card chunk slices ever touch a device.
        super().__init__(prefix, keep_codes_on_host=True, **kwargs)
        self.mesh = mesh
        s = mesh.shape["model"]
        codes_np = self.codes_np
        m = codes_np.shape[1]
        if m % s:  # pad chunk axis; padded chunks contribute 0 to distances
            pad = s - m % s
            codes_np = np.concatenate(
                [codes_np, np.zeros((codes_np.shape[0], pad), np.uint8)], axis=1
            )
        self._m_padded = codes_np.shape[1]
        self.codes_np = None  # host copy no longer needed
        self.codes_sharded = jax.device_put(
            shard_codes_by_chunk(codes_np, s), NamedSharding(mesh, P("model"))
        )
        self._steps = {}  # pq_impl -> compiled chunk-sharded step
        self._entry_fns = {}  # pq_impl -> compiled chunk-sharded entry selector

    def _prepare_tables(self, sub_queries, pq_impl):
        t = pq_distance_tables(self.codebook, sub_queries)  # [Q, m, 256]
        if self._m_padded != t.shape[1]:  # padded chunks: all-zero tables
            t = jnp.pad(t, ((0, 0), (0, self._m_padded - t.shape[1]), (0, 0)))
        s = self.mesh.shape["model"]
        return jax.device_put(
            shard_tables_by_chunk(t, s), NamedSharding(self.mesh, P("model"))
        )

    def _select_entries(self, sub_q, tables, params, beam, pq_impl):
        if params.entry_mode != "sampled":
            return super()._select_entries(sub_q, tables, params, beam, pq_impl)
        fn = self._entry_fns.get(pq_impl)
        if fn is None:
            fn = self._entry_fns[pq_impl] = make_sampled_entry_tp(self.mesh, pq_impl)
        return [
            fn(t, self.codes_sharded, params.entry_samples, beam) for t in tables
        ]

    def _run_step(self, state, nbrs, parent_fp, queries_f32, tables,
                  use_bloom, pq_impl, beam):
        step = self._steps.get(pq_impl)
        if step is None:
            step = self._steps[pq_impl] = make_base_step_tp(self.mesh, pq_impl)
        return step(
            state, nbrs, parent_fp, queries_f32, tables, self.codes_sharded,
            use_bloom, beam,
        )
