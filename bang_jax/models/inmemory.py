"""BANG_Inmemory variant: all-HBM graph + PQ traversal + exact re-rank.

Reference behavior (BANG_Inmemory/parANN.cu:77-906): graph and PQ codes live
on the accelerator; traversal distances come from per-query PQ tables; after
the walk, every expanded node is re-ranked with exact L2 against
full-precision vectors and the top-k is returned. Intended for ≤100M-point
datasets. The only per-iteration host round trip in the reference (the
`nextIter` bool, parANN.cu:595) disappears entirely: the loop condition lives
inside `lax.while_loop` on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bang_jax.models.index import DeviceIndex
from bang_jax.models.traversal import (
    make_pq_distance_fn,
    rerank_topk,
    run_traversal,
)
from bang_jax.utils.config import SearchParams


@functools.partial(
    jax.jit,
    static_argnames=("l", "k", "max_iters", "use_bloom", "medoid", "rerank", "pq_impl", "beam", "entry_samples"),
)
def _search_inmemory_jit(
    adj,
    vectors,
    vector_norms,
    codes,
    nbr_codes,
    codebook,
    queries,
    medoid,
    l,
    k,
    max_iters,
    use_bloom,
    rerank,
    pq_impl="auto",
    beam=1,
    fused_rows=None,
    entry_samples=0,
    adj_planes=None,
):
    q = queries.shape[0]
    queries_f32 = queries.astype(jnp.float32)
    if adj_planes is not None:
        # byte-plane adjacency (ops/adjacency): used with nbr_codes so the
        # i32 table never has to be device-resident
        from bang_jax.ops.adjacency import PlaneAdjacency

        adj = PlaneAdjacency(adj_planes)
    elif adj is None and fused_rows is not None:
        # fused-frontier mode keeps NO adjacency table at all (the fused
        # rows carry the ids); make_step only needs R
        from bang_jax.ops.adjacency import FrontierOnlyAdj

        adj = FrontierOnlyAdj(fused_rows.shape[1] // (4 + codes.shape[1]))
    distance_fn = make_pq_distance_fn(
        queries_f32, codebook, codes, impl=pq_impl, nbr_codes=nbr_codes,
        fused_rows=fused_rows,
    )
    entry_ids = entry_dists = None
    if entry_samples:
        # entry selection (and worklist seed distances) by exact distance —
        # vectors are resident for the re-rank anyway; the traversal itself
        # still runs on PQ distances. One exact seed value among PQ
        # estimates only improves the ordering.
        from bang_jax.models.entry import sampled_entry_topb

        entry_ids, entry_dists = sampled_entry_topb(
            queries_f32, vectors, vector_norms, entry_samples, beam
        )
    final = run_traversal(adj, distance_fn, medoid, q, l, max_iters, use_bloom,
                          beam, entry_ids=entry_ids, entry_dists=entry_dists)
    if rerank:
        ids, dists = rerank_topk(
            queries_f32, vectors, vector_norms, final.visited_ids, k
        )
    else:
        ids, dists = final.wl_ids[:, :k], final.wl_dist[:, :k]
    return ids, dists, final.it, final.n_expanded, final.n_dist_comps


def search_inmemory(index: DeviceIndex, queries, params: SearchParams):
    """Batched PQ-traversal search with exact re-rank. Returns (ids [Q,k] i32,
    dists [Q,k] f32 squared L2, SearchStats)."""
    from bang_jax.models.traversal import SearchStats

    ids, dists, iters, n_exp, n_dc = _search_inmemory_jit(
        index.adj,
        index.vectors,
        index.vector_norms,
        index.codes,
        index.nbr_codes,
        index.codebook,
        jnp.asarray(queries),
        medoid=index.medoid,
        l=params.L,
        k=params.k,
        max_iters=params.max_iters,
        use_bloom=params.visited_mode == "bloom",
        rerank=params.rerank,
        pq_impl=params.pq_impl,
        beam=params.beam_width,
        fused_rows=index.fused_rows,
        entry_samples=params.entry_samples if params.entry_mode == "sampled" else 0,
        adj_planes=index.adj_planes,
    )
    # stats stay device-side; SearchStats fetches lazily (one round trip on
    # first access) so back-to-back searches pipeline through the dispatch
    # queue instead of serializing on a scalar readback
    return ids, dists, SearchStats(iters, n_exp, n_dc)
