"""BANG_Base variant: billion-scale search with the graph in host RAM.

Reference behavior (BANG_Base/bang_search.cu:569-1068): PQ codes live on the
accelerator; the packed graph (vectors + adjacency) stays in host RAM because
it cannot fit in device memory at billion scale. Each iteration the host
fetches the current parents' adjacency rows and full-precision vectors with a
multithreaded gather and ships them to the device, which filters, computes PQ
distances, merges the worklist, and returns the next parents.

Re-design of the reference's overlap machinery (4 CUDA streams +
speculative compute_parent1/2 prefetch, bang_search.cu:1384-1521):
  * the query batch is split into pipeline sub-batches; while the device steps
    sub-batch B, the host gathers neighbors for sub-batch A (JAX dispatch is
    asynchronous, so `step` launches return immediately and the host gather
    runs concurrently with device compute);
  * instead of streaming parent FP vectors to a device-side [iters, Q, D]
    buffer for a final re-rank kernel (reference d_FPSetCoordsList), the exact
    parent distance is computed the moment the vector arrives and only the
    scalar distance is kept — re-rank memory drops from O(iters*Q*D) to
    O(iters*Q), and the final top-k needs no second gather.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bang_jax.constants import BF_ENTRIES, INVALID_ID
from bang_jax.formats.graph import load_metadata, GRAPH_INDEX_FILE_SUFFIX
from bang_jax.formats.pq import load_pq
from bang_jax.native import gather_parents
from bang_jax.ops.bloom import bloom_insert, bloom_query
from bang_jax.ops.merge import init_worklist, merge_worklist, select_parents_beam
from bang_jax.ops.pq import pq_distance_tables, pq_lookup, prepare_pq_codebook
from bang_jax.ops.visited import exact_new_mask
from bang_jax.utils.config import SearchParams
from bang_jax.utils.timer import StageTimers


class BaseState(NamedTuple):
    wl_dist: jnp.ndarray  # [Q, L]
    wl_ids: jnp.ndarray  # [Q, L]
    wl_vis: jnp.ndarray  # [Q, L]
    parent_valid: jnp.ndarray  # [Q, P]
    visited_ids: jnp.ndarray  # [Q, MI*P]
    l2_dists: jnp.ndarray  # [Q, MI*P] exact distances of expanded nodes
    bloom: Optional[jnp.ndarray]
    active: jnp.ndarray  # [Q]
    it: jnp.ndarray  # scalar i32


def _init_state(
    q: int, l: int, max_iters: int, medoid, use_bloom: bool, beam: int = 1
) -> BaseState:
    """medoid: scalar (shared entry), [Q] per-query entries, or [Q, P<=beam]
    multi-entry beam seeds. Entry distances need no seeding here — the Base
    step computes each parent's exact distance the moment its FP row arrives
    from the host (see _step_core)."""
    entries = jnp.asarray(medoid, jnp.int32)
    if entries.ndim == 0:
        entries = jnp.broadcast_to(entries, (q,))
    if entries.ndim == 1:
        entries = entries[:, None]
    p = entries.shape[1]
    assert p <= beam, f"entry seeds {p} exceed beam width {beam}"
    wl_dist, wl_ids, wl_vis = init_worklist(q, l)
    parent_valid = jnp.zeros((q, beam), jnp.bool_).at[:, :p].set(True)
    visited = jnp.full((q, max_iters * beam), INVALID_ID, jnp.int32)
    visited = visited.at[:, :p].set(entries)
    l2d = jnp.full((q, max_iters * beam), jnp.inf, jnp.float32)
    bloom = None
    if use_bloom:
        bloom = bloom_insert(
            jnp.zeros((q, BF_ENTRIES), jnp.uint8),
            entries,
            jnp.ones((q, p), jnp.bool_),
        )
    return BaseState(
        wl_dist, wl_ids, wl_vis, parent_valid, visited, l2d, bloom,
        jnp.ones((q,), jnp.bool_), jnp.int32(1),
    )


def _step_core(state: BaseState, nbrs, parent_fp, queries_f32, raw, use_bloom, beam):
    """One device iteration given host-gathered neighbors, parent vectors and
    the raw candidate distances `raw` [Q, C] (PQ lookup — single-chip or
    chunk-sharded, see parallel/base_tp.py).

    nbrs: [Q, P*R] (P parents' adjacency rows); parent_fp: [Q, P, D] f32.
    """
    from bang_jax.ops.visited import first_occurrence_mask_blocks

    # Exact distances of the parents being expanded now (their visited slots
    # are (it-1)*P ...); replaces the deferred compute_L2Dist re-rank pass.
    # parent_fp arrives in the index's storage dtype (u8/i8 ship 1 byte/dim
    # over the host link — 4x less H2D than f32); the cast is exact for
    # integer data (values < 2^24) and a no-op for f32 indices.
    parent_fp = parent_fp.astype(jnp.float32)
    pd = ((parent_fp - queries_f32[:, None, :]) ** 2).sum(-1)  # [Q, P]
    l2d = jax.lax.dynamic_update_slice(
        state.l2_dists,
        jnp.where(state.parent_valid & state.active[:, None], pd, jnp.inf),
        (0, (state.it - 1) * beam),
    )
    cand_valid = jnp.repeat(state.parent_valid, nbrs.shape[1] // beam, axis=1)

    if use_bloom:
        new = ~bloom_query(state.bloom, nbrs)
        new = new & cand_valid & state.active[:, None]
        if beam > 1:
            new = new & first_occurrence_mask_blocks(nbrs, beam)
        bloom = bloom_insert(state.bloom, nbrs, new)
    else:
        new = exact_new_mask(nbrs, state.wl_ids, state.visited_ids)
        new = new & cand_valid & state.active[:, None]
        if beam > 1:
            new = new & first_occurrence_mask_blocks(nbrs, beam)
        bloom = state.bloom

    dist = jnp.where(new, raw, jnp.inf)
    wl_dist, wl_ids, wl_vis = merge_worklist(
        state.wl_dist, state.wl_ids, state.wl_vis, dist, nbrs
    )
    parents, parent_valid, active, wl_vis = select_parents_beam(
        wl_dist, wl_ids, wl_vis, beam
    )
    visited = jax.lax.dynamic_update_slice(
        state.visited_ids,
        jnp.where(parent_valid, parents, INVALID_ID),
        (0, state.it * beam),
    )
    new_state = BaseState(
        wl_dist, wl_ids, wl_vis, parent_valid, visited, l2d, bloom, active,
        state.it + 1,
    )
    return new_state, parents, active.any()


@functools.partial(jax.jit, static_argnames=("use_bloom", "pq_impl", "beam"), donate_argnums=(0,))
def _base_step(
    state: BaseState, nbrs, parent_fp, queries_f32, tables, codes, use_bloom,
    pq_impl="xla", beam=1,
):
    """Single-chip step: local PQ lookup + the shared step core."""
    if pq_impl == "pallas":
        from bang_jax.ops.pq_pallas import pq_lookup_pallas

        raw = pq_lookup_pallas(tables, codes[nbrs])
    else:
        raw = pq_lookup(tables, codes[nbrs])
    return _step_core(state, nbrs, parent_fp, queries_f32, raw, use_bloom, beam)


@functools.partial(jax.jit, static_argnames=("n_samples", "b"))
def _sampled_entry_base(queries_f32, codes, codebook, n_samples, b):
    """Per-query top-B entries for the Base variant, [Q, B] int32.

    No full-precision vectors live on the device here (the Base split keeps
    only PQ codes in HBM), so sample vectors are PQ-RECONSTRUCTED from their
    codes and ranked by exact distance in the quantized space — one
    [Q, m*dmax] x [m*dmax, S] contraction, the same cost shape as
    models/entry.py's selector."""
    n = codes.shape[0]
    s = int(min(n_samples, n))
    stride = max(1, n // s)
    ids = (jnp.arange(s, dtype=jnp.int32) * stride) % n
    m = codebook.piv_chunks.shape[0]
    recon = codebook.piv_chunks[
        jnp.arange(m)[None, :], codes[ids].astype(jnp.int32)
    ]  # [S, m, dmax]
    qc = (queries_f32 - codebook.centroid)[:, codebook.dim_idx] * codebook.dim_mask
    cross = jnp.einsum("qmd,smd->qs", qc, recon)
    rs = (recon ** 2).sum(axis=(1, 2))
    d = rs[None, :] - 2.0 * cross  # rank-only (|q|^2 constant per row)
    if b == 1:
        idx = jnp.argmin(d, axis=1)[:, None]
    else:
        _, idx = jax.lax.top_k(-d, min(b, s))
    out = ids[idx]
    if b > out.shape[1]:
        out = jnp.concatenate(
            [out, jnp.broadcast_to(out[:, :1], (out.shape[0], b - out.shape[1]))],
            axis=1,
        )
    return out


@functools.partial(jax.jit, static_argnames=("k",))
def _base_finish(state: BaseState, k: int):
    neg, idx = jax.lax.top_k(-state.l2_dists, k)
    ids = jnp.take_along_axis(state.visited_ids, idx, axis=1)
    return ids, -neg


class BaseVariantSearcher:
    """Host-RAM-graph searcher (the BANGSearch facade's billion-scale engine).

    Only the PQ codes + codebook are device-resident; the packed graph file is
    memory-mapped (or held in RAM) on the host, exactly like the reference's
    `pIndex` (bang_search.cu:311-328).
    """

    def __init__(
        self,
        prefix: str,
        n_pipeline_batches: int = 4,
        n_threads: int = 0,
        mmap: bool = True,
        keep_codes_on_host: bool = False,
    ):
        """keep_codes_on_host: leave the [N, m] code matrix as host numpy
        (self.codes_np) instead of staging it into HBM — required by
        subclasses that shard codes across a mesh (parallel/base_tp.py),
        where the full matrix may exceed one chip's memory."""
        self.meta = load_metadata(prefix + "_disk_metadata.bin")
        path = prefix + GRAPH_INDEX_FILE_SUFFIX
        n, entry_len = self.meta.n, self.meta.entry_len
        if mmap:
            self.raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, entry_len))
        else:
            self.raw = np.fromfile(path, dtype=np.uint8, count=n * entry_len).reshape(
                n, entry_len
            )
        pq = load_pq(prefix)
        if keep_codes_on_host:
            self.codes_np = np.asarray(pq.codes)
            self.codes = None
        else:
            self.codes = jnp.asarray(pq.codes)
        self.codebook = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)
        self.vec_bytes = self.meta.dim * self.meta.numpy_dtype.itemsize
        self.n_pipeline_batches = n_pipeline_batches
        self.n_threads = n_threads
        self.timers = StageTimers(enabled=False)
        self._d2h_async = True  # cleared on first copy_to_host_async failure

    def _prepare_tables(self, sub_queries, pq_impl):
        """Per-sub-batch PQ distance tables [Q, m, 256] f32."""
        return pq_distance_tables(self.codebook, sub_queries)

    def _run_step(self, state, nbrs, parent_fp, queries_f32, tables,
                  use_bloom, pq_impl, beam):
        """One device step (overridden by the chunk-sharded variant)."""
        return _base_step(
            state, nbrs, parent_fp, queries_f32, tables, self.codes,
            use_bloom, pq_impl, beam,
        )

    def _select_entries(self, sub_q, tables, params, beam, pq_impl):
        """Per-sub-batch entry points: the shared medoid, or per-query
        sampled entries (overridden by the chunk-sharded variant, which runs
        the selection as a distributed PQ lookup + psum)."""
        nb = len(sub_q)
        if params.entry_mode != "sampled":
            return [self.meta.medoid] * nb
        if self.codes is None:
            from bang_jax.utils.logging import log_message

            log_message("sampled entry needs device-resident codes; "
                        "using medoid entry")
            return [self.meta.medoid] * nb
        return [
            _sampled_entry_base(
                sq, self.codes, self.codebook, params.entry_samples, beam
            )
            for sq in sub_q
        ]

    def _host_gather(self, parents: np.ndarray):
        """(nbrs [Q, R] i32, vecs [Q, D] in the index's STORAGE dtype).

        Vectors ship unconverted (raw bytes viewed as the storage dtype);
        the device step casts to f32 — for u8/i8 indices that is 4x less
        H2D traffic per iteration and no host-side conversion pass (the
        reference ships raw bytes the same way, bang_search.cu:771-813)."""
        nbrs, vecs = gather_parents(
            self.raw,
            self.meta.entry_len,
            self.vec_bytes,
            self.meta.dim,
            self.meta.degree,
            self.meta.dtype_code,
            parents,
            n_threads=self.n_threads,
            raw_vecs=True,
        )
        return nbrs, vecs.view(self.meta.numpy_dtype)

    def search(self, queries: np.ndarray, params: SearchParams):
        """Batched search. Returns (ids [Q, k] i32, dists [Q, k] f32).

        Stage-timer semantics (per-search, enabled via ENABLE_GPU_STATS):
          host_gather  — host work: threaded adjacency + FP row fetch
          d2h_parents  — ONE batched readback of all in-flight sub-batches'
                         next parents per outer iteration (includes waiting
                         for the slowest sub-batch's device step)
          dispatch     — H2D staging + async device-step enqueue
          wall         — end-to-end search wall clock
        Overlap proof: host_gather + d2h_parents + dispatch > wall means the
        host gather ran concurrently with device compute (the pipeline's
        purpose); host_gather ≈ its share of wall means no overlap.
        """
        queries = np.asarray(queries, dtype=np.float32)
        self.timers.ms.clear()  # per-search stage breakdown
        t_wall = None
        if self.timers.enabled:
            import time as _time

            t_wall = _time.perf_counter()
        q_total = queries.shape[0]
        nb = min(self.n_pipeline_batches, q_total)
        use_bloom = params.visited_mode == "bloom"
        bounds = np.linspace(0, q_total, nb + 1).astype(int)
        slices = [slice(bounds[i], bounds[i + 1]) for i in range(nb)]

        from bang_jax.ops.pq_pallas import resolve_pq_impl

        pq_impl = resolve_pq_impl(params.pq_impl)

        beam = params.beam_width
        sub_q = [jnp.asarray(queries[s]) for s in slices]
        tables = [self._prepare_tables(sq, pq_impl) for sq in sub_q]
        entries = self._select_entries(sub_q, tables, params, beam, pq_impl)
        states = [
            _init_state(
                sq.shape[0], params.L, params.max_iters, entries[i], use_bloom, beam
            )
            for i, sq in enumerate(sub_q)
        ]
        parents_host = [
            np.zeros((sq.shape[0], beam), dtype=np.int32) for sq in sub_q
        ]
        for b_i, ph in enumerate(parents_host):
            e = entries[b_i]
            if getattr(e, "ndim", 0) >= 1:
                ph[:, :] = np.asarray(e)  # [q_b, beam] D2H (small)
            else:
                ph[:, 0] = int(e)
        pending = [None] * nb  # (parents_dev, active_any_dev) in flight
        done = [False] * nb
        self.last_n_steps = 0  # device steps dispatched (all sub-batches)
        self.last_n_d2h = 0  # blocking host-link round trips (readbacks)

        # Software pipeline: the host gather for sub-batch b overlaps the
        # device step of the other sub-batches (async JAX dispatch).
        #
        # Readbacks are STACKED: all in-flight sub-batches' next parents come
        # home in ONE batched device_get per outer iteration (plus an async
        # D2H started right after each dispatch), not one blocking readback
        # per sub-batch — per-readback latency is the serial term the
        # reference hides with speculative prefetch (bang_search.cu:
        # 1384-1521), and it divides by the batch. Device steps per round
        # trip = last_n_steps / last_n_d2h ≈ nb.
        for it in range(1, params.max_iters):
            live = [b for b in range(nb) if not done[b]]
            if not live:
                break
            in_flight = [b for b in live if pending[b] is not None]
            if in_flight:
                with self.timers.stage("d2h_parents"):
                    fetched = jax.device_get([pending[b] for b in in_flight])
                    self.last_n_d2h += 1
                for b, (par, act) in zip(in_flight, fetched):
                    parents_host[b] = np.asarray(par)
                    pending[b] = None
                    if not bool(act):
                        done[b] = True
            for b in live:
                if done[b]:
                    continue
                with self.timers.stage("host_gather"):
                    nbrs, fp = self._host_gather(parents_host[b].reshape(-1))
                q_b = parents_host[b].shape[0]
                with self.timers.stage("dispatch"):
                    states[b], parents_dev, active_dev = self._run_step(
                        states[b],
                        jnp.asarray(nbrs.reshape(q_b, -1)),
                        jnp.asarray(fp.reshape(q_b, beam, -1)),
                        sub_q[b],
                        tables[b],
                        use_bloom,
                        pq_impl,
                        beam,
                    )
                    # start the D2H of the step's outputs NOW so the transfer
                    # overlaps the host gathers of the other sub-batches and
                    # the batched device_get above finds the bytes staged
                    if self._d2h_async:
                        try:
                            parents_dev.copy_to_host_async()
                            active_dev.copy_to_host_async()
                        except Exception:  # backend without async D2H
                            self._d2h_async = False
                pending[b] = (parents_dev, active_dev)
                self.last_n_steps += 1
        # drain in-flight steps
        for b in range(nb):
            if pending[b] is not None:
                jax.block_until_ready(states[b].wl_dist)

        ids = np.empty((q_total, params.k), np.int32)
        dists = np.empty((q_total, params.k), np.float32)
        # dispatch every finish first, then ONE batched readback (2*nb
        # blocking transfers would pay the host-link RPC latency each)
        finished = [_base_finish(states[b], params.k) for b in range(nb)]
        finished = jax.device_get(finished)
        for b, s in enumerate(slices):
            i_b, d_b = finished[b]
            ids[s] = i_b
            dists[s] = d_b
        if t_wall is not None:
            import time as _time

            self.timers.ms["wall"] += (_time.perf_counter() - t_wall) * 1000.0
        return ids, dists
