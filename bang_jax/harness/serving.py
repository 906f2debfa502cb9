"""Serving-mode query scheduler: stream arbitrary-size query batches through
one compiled search program.

The reference is a batch benchmark harness (10K queries in one shot); a
production deployment needs to accept query streams of arbitrary size. This
scheduler compiles the search once for a fixed batch shape and serves
requests by slicing/padding, amortizing compilation and keeping latency
predictable. Latency percentiles are tracked per request.
"""

from __future__ import annotations

import time

import numpy as np

from bang_jax.api import BANGSearch
from bang_jax.utils.config import SearchParams


class SearchServer:
    """Fixed-batch-shape search server over a BANGSearch engine."""

    def __init__(
        self,
        index_prefix: str,
        variant: str = "inmemory",
        batch_size: int = 1024,
        params: SearchParams | None = None,
    ):
        import dataclasses

        self.batch_size = batch_size
        self.params = params or SearchParams()
        self.engine = BANGSearch(variant=variant, dist_func=self.params.dist_func)
        self.engine.bang_load(index_prefix)
        extra = dataclasses.asdict(self.params)
        for consumed in ("L", "k", "dist_func"):
            extra.pop(consumed)
        self.engine.bang_set_searchparams(self.params.k, self.params.L, **extra)
        self.engine.bang_alloc(batch_size)
        self.latencies_ms: list[float] = []

    def query(self, queries: np.ndarray):
        """Search any number of queries; internally runs fixed-size batches.
        Returns (ids [Q, k] int64, dists [Q, k] f32)."""
        queries = np.asarray(queries)
        nq = queries.shape[0]
        k = self.params.k
        ids = np.empty((nq, k), np.int64)
        dists = np.empty((nq, k), np.float32)
        for s in range(0, nq, self.batch_size):
            t0 = time.perf_counter()
            chunk = queries[s : s + self.batch_size]
            i, d = self.engine.bang_query(chunk)
            self.latencies_ms.append((time.perf_counter() - t0) * 1000.0)
            ids[s : s + self.batch_size] = i
            dists[s : s + self.batch_size] = d
        return ids, dists

    def latency_percentiles(self, ps=(50, 90, 99)) -> dict:
        if not self.latencies_ms:
            return {f"p{p}": float("nan") for p in ps}
        arr = np.asarray(self.latencies_ms)
        return {f"p{p}": float(np.percentile(arr, p)) for p in ps}

    def close(self):
        self.engine.bang_free()
        self.engine.bang_unload()


def measure_device_batch_latency(
    index,
    queries: np.ndarray,
    params: SearchParams,
    variant: str = "inmemory",
    n_chain: int = 17,
) -> float:
    """Device time per search batch, measured as the SLOPE of a chained
    on-device loop (ms per search).

    This runs `n_chain` full searches sequentially inside ONE device program
    (each search's queries carry a data dependence on the previous result,
    forcing serialization), times chains of length 1 and n_chain, and
    reports (t_n - t_1) / (n_chain - 1) — constant dispatch and readback
    costs cancel.
    """
    import functools

    import jax
    import jax.numpy as jnp

    if variant == "inmemory":
        from bang_jax.models.inmemory import _search_inmemory_jit as _search
    elif variant == "exactdistance":
        from bang_jax.models.exactdistance import _search_exact_jit as _search
    else:
        raise ValueError(f"device latency probe supports HBM variants, not {variant!r}")

    q = jnp.asarray(np.asarray(queries, np.float32))
    entry_samples = params.entry_samples if params.entry_mode == "sampled" else 0

    # index arrays MUST be jit arguments — captured (closed-over) arrays
    # become HLO constants, inflating the program by GBs
    if variant == "inmemory":
        arrays = (index.adj, index.vectors, index.vector_norms, index.codes,
                  index.nbr_codes, index.codebook, index.fused_rows,
                  index.adj_planes)

        def one_search(arrays, qq):
            adj, vectors, norms, codes, nbr_codes, cb, fused, planes = arrays
            return _search(
                adj, vectors, norms, codes, nbr_codes, cb, qq,
                medoid=index.medoid, l=params.L, k=params.k,
                max_iters=params.max_iters,
                use_bloom=params.visited_mode == "bloom",
                rerank=params.rerank, pq_impl=params.pq_impl,
                beam=params.beam_width, fused_rows=fused,
                entry_samples=entry_samples, adj_planes=planes,
            )
    else:
        arrays = (index.adj, index.vectors, index.vector_norms,
                  index.nbr_vecs, index.nbr_vec_norms, index.fused_vec_rows,
                  index.adj_planes)

        def one_search(arrays, qq):
            adj, vectors, norms, nbr_vecs, nbr_vec_norms, fused, planes = arrays
            return _search(
                adj, vectors, norms, nbr_vecs, nbr_vec_norms, qq,
                medoid=index.medoid, l=params.L, k=params.k,
                max_iters=params.max_iters,
                use_bloom=params.visited_mode == "bloom",
                precision=params.traversal_precision,
                beam=params.beam_width,
                fused_vec_rows=fused,
                entry_samples=entry_samples, adj_planes=planes,
            )

    @functools.partial(jax.jit, static_argnames=("n",))
    def chained(arrays, q, n):
        def body(i, carry):
            qq = q + carry * 0.0  # serialize: depends on previous search
            ids, dists, *_ = one_search(arrays, qq)
            return dists.sum()

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    def timed(n):
        jax.device_get(chained(arrays, q, n))  # compile + warm
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(chained(arrays, q, n))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = timed(1)
    tn = timed(n_chain)
    return max(0.0, (tn - t1) / (n_chain - 1) * 1000.0)


def measure_base_device_step_ms(
    searcher, queries: np.ndarray, params: SearchParams, n_chain: int = 17
) -> float:
    """Device time of ONE Base-variant device step (ms), chained-slope.

    The Base search loop is host-driven (host gathers adjacency between
    steps), so its wall clock mixes host and device time. This chains
    `n_chain` steps inside one program (state carried through
    lax.fori_loop, fixed neighbor input — identical op sequence and shapes
    each iteration) and reports the slope: the pipelined wall time is
    ~max(total host gather, n_steps x this)."""
    import functools

    import jax
    import jax.numpy as jnp

    from bang_jax.models.base import _init_state
    from bang_jax.ops.pq_pallas import resolve_pq_impl

    pq_impl = resolve_pq_impl(params.pq_impl)
    use_bloom = params.visited_mode == "bloom"
    beam = params.beam_width
    q = queries.shape[0]
    queries_f32 = jnp.asarray(np.asarray(queries, np.float32))
    tables = searcher._prepare_tables(queries_f32, pq_impl)
    r = searcher.meta.degree
    rng = np.random.default_rng(0)
    nbrs = jnp.asarray(rng.integers(0, searcher.meta.n, (q, beam * r)).astype(np.int32))
    parent_fp = jnp.zeros((q, beam, searcher.meta.dim), jnp.float32)
    state0 = _init_state(
        q, params.L, params.max_iters, searcher.meta.medoid, use_bloom, beam
    )

    # codes MUST be a jit argument (closed-over device arrays become HLO
    # constants — GBs of program)
    codes = getattr(searcher, "codes", None)
    if codes is not None:
        from bang_jax.models.base import _base_step

        def one_step(st, nbrs, fp, qf, tables, codes):
            return _base_step(st, nbrs, fp, qf, tables, codes, use_bloom,
                              pq_impl, beam)
    else:  # chunk-sharded subclass
        from bang_jax.parallel.base_tp import make_base_step_tp

        codes = searcher.codes_sharded
        step_tp = make_base_step_tp(searcher.mesh, pq_impl)

        def one_step(st, nbrs, fp, qf, tables, codes):
            return step_tp(st, nbrs, fp, qf, tables, codes, use_bloom, beam)

    @functools.partial(jax.jit, static_argnames=("n",))
    def chained(state, nbrs, parent_fp, queries_f32, tables, codes, n):
        def body(i, st):
            st2, _parents, _any = one_step(
                st, nbrs, parent_fp, queries_f32, tables, codes
            )
            return st2._replace(it=st.it)  # keep visited-slot writes in range
        return jax.lax.fori_loop(0, n, body, state).wl_dist.sum()

    def timed(n):
        jax.device_get(chained(state0, nbrs, parent_fp, queries_f32, tables, codes, n))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(
                chained(state0, nbrs, parent_fp, queries_f32, tables, codes, n)
            )
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = timed(1)
    tn = timed(n_chain)
    return max(0.0, (tn - t1) / (n_chain - 1) * 1000.0)
