"""BANG_Exactdistance variant: all-HBM graph, exact-L2 traversal, no PQ.

Reference behavior (BANG_Exactdistance/parANN.cu:90-998): the graph index
lives entirely on the accelerator; traversal distances are exact L2 against
full-precision vectors; there is no re-rank — the distance-sorted worklist
head is the answer (parANN.cu:1273-1276). Intended for ≤100M-point datasets.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bang_jax.models.index import DeviceIndex
from bang_jax.models.traversal import (
    make_exact_distance_fn,
    run_traversal,
)
from bang_jax.utils.config import SearchParams


@functools.partial(
    jax.jit, static_argnames=("l", "k", "max_iters", "use_bloom", "medoid", "precision", "beam", "entry_samples")
)
def _search_exact_jit(
    adj, vectors, vector_norms, nbr_vecs, nbr_vec_norms, queries, medoid, l, k,
    max_iters, use_bloom, precision="highest", beam=1, fused_vec_rows=None,
    entry_samples=0, adj_planes=None,
):
    q = queries.shape[0]
    queries_f32 = queries.astype(jnp.float32)
    if adj is None and adj_planes is not None:
        # byte-plane adjacency (ops/adjacency): indexes built in
        # neighbor_codes mode drop the i32 table entirely
        from bang_jax.ops.adjacency import PlaneAdjacency

        adj = PlaneAdjacency(adj_planes)
    prec = (
        jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    )
    distance_fn = make_exact_distance_fn(
        queries_f32, vectors, vector_norms, precision=prec,
        nbr_vecs=nbr_vecs, nbr_vec_norms=nbr_vec_norms,
        fused_vec_rows=fused_vec_rows,
    )
    entry_ids = entry_dists = None
    if entry_samples:
        from bang_jax.models.entry import sampled_entry_topb

        entry_ids, entry_dists = sampled_entry_topb(
            queries_f32, vectors, vector_norms, entry_samples, beam
        )
    final = run_traversal(adj, distance_fn, medoid, q, l, max_iters, use_bloom,
                          beam, entry_ids=entry_ids, entry_dists=entry_dists)
    return (
        final.wl_ids[:, :k],
        final.wl_dist[:, :k],
        final.it,
        final.n_expanded,
        final.n_dist_comps,
    )


def search_exact(index: DeviceIndex, queries, params: SearchParams):
    """Batched exact-distance search. Returns (ids [Q,k] i32, dists [Q,k] f32,
    SearchStats)."""
    from bang_jax.models.traversal import SearchStats

    ids, dists, iters, n_exp, n_dc = _search_exact_jit(
        index.adj,
        index.vectors,
        index.vector_norms,
        index.nbr_vecs,
        index.nbr_vec_norms,
        jnp.asarray(queries),
        medoid=index.medoid,
        l=params.L,
        k=params.k,
        max_iters=params.max_iters,
        use_bloom=params.visited_mode == "bloom",
        precision=params.traversal_precision,
        beam=params.beam_width,
        fused_vec_rows=index.fused_vec_rows,
        entry_samples=params.entry_samples if params.entry_mode == "sampled" else 0,
        adj_planes=index.adj_planes,
    )
    # stats stay device-side; SearchStats fetches lazily (one round trip on
    # first access) so back-to-back searches pipeline through the dispatch
    # queue instead of serializing on a scalar readback
    return ids, dists, SearchStats(iters, n_exp, n_dc)
