"""The greedy best-first graph traversal as a jit-compiled on-device loop.

This is the re-design of the reference's hot loop (BANG_Base/
bang_search.cu:701-958; BANG_Inmemory/parANN.cu:531-611): state is a pytree of
fixed-shape [Q, ...] arrays, the do/while becomes `lax.while_loop`, the global
`d_nextIter` flag becomes `active.any()`, and the per-iteration kernel
sequence (neighbor fetch → visited filter → distance → sort → merge → parent
select) becomes a fused XLA program over the whole query batch.

Beam width: the reference expands exactly one parent per query per iteration
(SIZEPARENTLIST=2, bang_search.cu:56-58) and notes multi-parent expansion as
future work (:776-778). Here the beam width is a parameter: `beam` parents are
expanded per iteration, which divides the sequential iteration count and
amortizes the per-iteration sort/filter cost. beam=1 reproduces the
reference schedule exactly.

Distances during traversal are squared L2 (the reference never takes square
roots; DiskANN ground truth is squared as well).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from bang_jax.constants import BF_ENTRIES, INVALID_ID
from bang_jax.ops.bloom import bloom_insert, bloom_query
from bang_jax.ops.l2 import l2_distance_to_candidates
from bang_jax.ops.merge import init_worklist, merge_worklist, select_parents_beam
from bang_jax.ops.pq import pq_distance_tables, pq_lookup
from bang_jax.ops.visited import exact_new_mask, first_occurrence_mask_blocks


class TraversalState(NamedTuple):
    wl_dist: jnp.ndarray  # [Q, L] f32
    wl_ids: jnp.ndarray  # [Q, L] i32
    wl_vis: jnp.ndarray  # [Q, L] bool
    parents: jnp.ndarray  # [Q, P] i32 — selected last iteration, expanded next
    parent_valid: jnp.ndarray  # [Q, P] bool
    visited_ids: jnp.ndarray  # [Q, MI*P] i32 — expansion order, INVALID padding
    bloom: Optional[jnp.ndarray]  # [Q, BF] u8 or None (exact dedup mode)
    active: jnp.ndarray  # [Q] bool
    it: jnp.ndarray  # scalar i32
    n_expanded: jnp.ndarray  # scalar — total parents expanded
    n_dist_comps: jnp.ndarray  # scalar — total candidate distances computed
    # (the Exactdistance reference reports this counter: parANN.cu:495-502)


class SearchStats:
    """Search statistics (reference: iteration prints + the Exactdistance
    distance-computation counter, parANN.cu:971-972).

    Counters are held as DEVICE scalars and fetched lazily on first attribute
    access, so back-to-back searches are not serialized on a scalar readback.
    `sync()` forces the fetch (timing code calls it to mark end-to-end
    completion)."""

    __slots__ = ("_iters", "_n_expanded", "_n_dist_comps", "_fetched")

    def __init__(self, iters, n_expanded, n_dist_comps):
        self._iters = iters
        self._n_expanded = n_expanded
        self._n_dist_comps = n_dist_comps
        self._fetched = isinstance(iters, int)

    def sync(self) -> "SearchStats":
        if not self._fetched:
            i, ne, nd = jax.device_get(
                (self._iters, self._n_expanded, self._n_dist_comps)
            )  # ONE round trip for all three scalars
            self._iters, self._n_expanded, self._n_dist_comps = (
                int(i), int(ne), int(nd),
            )
            self._fetched = True
        return self

    @property
    def iters(self) -> int:
        return self.sync()._iters

    @property
    def n_expanded(self) -> int:
        return self.sync()._n_expanded

    @property
    def n_dist_comps(self) -> int:
        return self.sync()._n_dist_comps

    def __repr__(self):
        if self._fetched:
            return (f"SearchStats(iters={self._iters}, "
                    f"n_expanded={self._n_expanded}, "
                    f"n_dist_comps={self._n_dist_comps})")
        return "SearchStats(<device, unsynced>)"


def init_state(
    q: int, l: int, max_iters: int, medoid, use_bloom: bool, beam: int = 1,
    medoid_dist=None,
) -> TraversalState:
    """medoid may be a scalar (the classic shared entry point), a [Q] int32
    array of per-query entries, or a [Q, P] array (P <= beam) seeding P beam
    slots per query (see run_traversal entry_ids). medoid_dist must match
    the entry shape ([Q] or [Q, P]). The worklist seed slots need no
    ordering: merge_worklist fully sorts concat(worklist, candidates)."""
    entries = jnp.asarray(medoid, jnp.int32)
    if entries.ndim == 0:
        entries = jnp.broadcast_to(entries, (q,))
    if entries.ndim == 1:
        entries = entries[:, None]
    p = entries.shape[1]
    assert p <= beam, f"entry seeds {p} exceed beam width {beam}"
    wl_dist, wl_ids, wl_vis = init_worklist(q, l)
    if medoid_dist is not None:
        # seed the worklist with the (already-visited) entry points so that
        # no-rerank paths can return them when one is a true nearest neighbor
        seed_d = jnp.asarray(medoid_dist).reshape(q, p)
        wl_dist = wl_dist.at[:, :p].set(seed_d)
        wl_ids = wl_ids.at[:, :p].set(entries)
        wl_vis = wl_vis.at[:, :p].set(True)
    parents = jnp.zeros((q, beam), dtype=jnp.int32).at[:, :p].set(entries)
    parent_valid = jnp.zeros((q, beam), dtype=jnp.bool_).at[:, :p].set(True)
    visited = jnp.full((q, max_iters * beam), INVALID_ID, dtype=jnp.int32)
    visited = visited.at[:, :p].set(entries)
    bloom = None
    if use_bloom:
        bloom = bloom_insert(
            jnp.zeros((q, BF_ENTRIES), jnp.uint8),
            entries,
            jnp.ones((q, p), jnp.bool_),
        )
    active = jnp.ones((q,), jnp.bool_)
    zero = jnp.int64(0) if jax.config.jax_enable_x64 else jnp.int32(0)
    return TraversalState(
        wl_dist, wl_ids, wl_vis, parents, parent_valid, visited, bloom, active,
        jnp.int32(1), zero, zero,
    )


def make_step(adj: jnp.ndarray, distance_fn, use_bloom: bool, beam: int = 1):
    """Build the per-iteration body.
    `distance_fn(cand_ids [Q, C], parents [Q, P]) -> [Q, C] f32`.

    When distance_fn exposes `frontier_fn(parents) -> (cand_ids, raw_dists)`
    (the fused frontier-row layout), the adjacency gather disappears: one
    gather per parent yields both the candidate ids and their PQ distances.

    `adj` may be a [N, R] int32 table or a callable `parents -> [Q, P*R] i32`
    with an `.r` attribute (ops/adjacency.PlaneAdjacency — the byte-plane
    layout of neighbor_codes mode).
    """
    if callable(adj):
        r = adj.r
        fetch_adj = adj
    else:
        r = adj.shape[1]

        def fetch_adj(parents):
            return adj[parents].reshape(parents.shape[0], beam * r)

    frontier_fn = getattr(distance_fn, "frontier_fn", None)

    def step(state: TraversalState) -> TraversalState:
        q = state.parents.shape[0]
        if frontier_fn is not None:
            cand, raw = frontier_fn(state.parents)  # ONE fused gather
        else:
            cand = fetch_adj(state.parents)  # adjacency gather [Q, beam*R]
            raw = None
        cand_valid = jnp.repeat(state.parent_valid, r, axis=1)

        if use_bloom:
            new = ~bloom_query(state.bloom, cand)
        else:
            new = exact_new_mask(cand, state.wl_ids, state.visited_ids)
        new = new & cand_valid & state.active[:, None]
        if beam > 1:
            # parents expanded together may share neighbors — keep first lane
            new = new & first_occurrence_mask_blocks(cand, beam)
        if use_bloom:
            bloom = bloom_insert(state.bloom, cand, new)
        else:
            bloom = state.bloom

        if raw is None:
            raw = distance_fn(cand, state.parents)
        dist = jnp.where(new, raw, jnp.inf)
        wl_dist, wl_ids, wl_vis = merge_worklist(
            state.wl_dist, state.wl_ids, state.wl_vis, dist, cand
        )
        parents, parent_valid, active, wl_vis = select_parents_beam(
            wl_dist, wl_ids, wl_vis, beam
        )
        visited = jax.lax.dynamic_update_slice(
            state.visited_ids,
            jnp.where(parent_valid, parents, INVALID_ID),
            (0, state.it * beam),
        )
        return TraversalState(
            wl_dist, wl_ids, wl_vis, parents, parent_valid, visited, bloom, active,
            state.it + 1,
            state.n_expanded + state.parent_valid.sum(dtype=state.n_expanded.dtype),
            state.n_dist_comps + new.sum(dtype=state.n_dist_comps.dtype),
        )

    return step


def run_traversal(
    adj: jnp.ndarray,
    distance_fn,
    medoid: int,
    q: int,
    l: int,
    max_iters: int,
    use_bloom: bool,
    beam: int = 1,
    entry_ids=None,
    entry_dists=None,
) -> TraversalState:
    """Run the full on-device while_loop; returns the final state.

    entry_ids [Q] or [Q, P<=beam] (optional): per-query entry points
    replacing the shared medoid (sampled-entry mode — see models/entry.py);
    [Q, P] seeds P beam slots with diverse entries. entry_dists (same shape)
    supplies their worklist-seed distances; REQUIRED with entry_ids. The
    reference always enters at the medoid
    (bang_search.cu:466-506); starting nearer saves traversal iterations,
    the workload's unit of cost.
    """
    step = make_step(adj, distance_fn, use_bloom, beam)
    if entry_ids is None:
        entry = jnp.full((q, 1), medoid, jnp.int32)
        entry_dists = distance_fn(entry, None)  # one-off entry distance
    else:
        entry = entry_ids if entry_ids.ndim == 2 else entry_ids[:, None]
        assert entry_dists is not None, "entry_ids requires entry_dists"
    state = init_state(q, l, max_iters, entry, use_bloom, beam, entry_dists)
    return jax.lax.while_loop(
        lambda s: (s.it < max_iters) & s.active.any(),
        step,
        state,
    )


def make_exact_distance_fn(
    queries_f32, vectors, vector_norms, precision=None,
    nbr_vecs=None, nbr_vec_norms=None, fused_vec_rows=None,
):
    """Traversal distance: exact squared L2 read from device-resident vectors
    (BANG_Exactdistance behavior, parANN.cu:1139-1179).

    vectors may be an f32 table packed as a u8 bit-view [N, 4*D] (see
    ops/l2.decode_row_gather). Scattered paths recompute candidate norms on
    the fly instead of paying a second scattered gather for vector_norms.

    nbr_vecs [N, R, D] (optional): neighbor-aligned vector layout —
    candidates fetched per PARENT as contiguous R*D rows (same trick as
    nbr_codes; R x the vector memory). nbr_vec_norms rides the same
    parent-gather pattern.

    fused_vec_rows [N, 8R + R*D] u8 (optional, u8 data): fused exact-frontier
    rows (ops/l2.pack_exact_frontier_rows) — attaches a `frontier_fn` so ONE
    gather per parent yields candidate ids, norms AND vectors (the
    traversal's adjacency gather disappears entirely)."""
    from bang_jax.ops.l2 import decode_exact_frontier_rows, decode_row_gather

    d = queries_f32.shape[-1]

    def distance_fn(cand_ids, parents=None):
        if nbr_vecs is not None and parents is not None:
            q = cand_ids.shape[0]
            vecs = decode_row_gather(
                nbr_vecs[parents].reshape(q, -1, nbr_vecs.shape[-1]), d
            )
            norms = (
                nbr_vec_norms[parents].reshape(q, -1)
                if nbr_vec_norms is not None else None
            )
        else:
            # scattered path: recompute norms from the gathered rows (exact
            # for u8 data: values < 2^24 in f32)
            vecs = decode_row_gather(vectors[cand_ids], d)  # [Q, C, D] gather
            norms = None
        return l2_distance_to_candidates(queries_f32, vecs, norms, precision=precision)

    if fused_vec_rows is not None:
        r = fused_vec_rows.shape[1] // (8 + d)

        def frontier_fn(parents):
            rows = fused_vec_rows[parents]  # [Q, P, 8R+R*D] ONE gather
            ids, norms, vecs = decode_exact_frontier_rows(rows, r, d)
            dists = l2_distance_to_candidates(
                queries_f32, vecs, norms, precision=precision
            )
            return ids, dists

        distance_fn.frontier_fn = frontier_fn

    return distance_fn


def make_pq_distance_fn(
    queries_f32, codebook, codes, impl: str = "auto", nbr_codes=None,
    fused_rows=None,
):
    """Traversal distance: PQ table lookup over gathered 8-bit codes
    (BANG_Base/Inmemory behavior). Tables are built once per batch.

    impl: "pallas" (the GPU kernel, ops/pq_pallas), "xla" (take_along_axis,
    ops/pq.pq_lookup) or "auto" (see ops/pq_pallas.resolve_pq_impl).

    nbr_codes [N, R*m] u8 (optional): neighbor-aligned code layout —
    candidate codes are fetched per PARENT as one contiguous R*m-byte row
    instead of R scattered m-byte rows.

    fused_rows [N, R*(4+m)] u8 (optional, preferred): fused frontier rows
    (ops/pq.pack_frontier_rows) — attaches a `frontier_fn` so the traversal
    fetches ids AND distances with ONE gather per parent.
    """
    from bang_jax.ops.pq import frontier_decode_xla
    from bang_jax.ops.pq_pallas import pq_lookup_pallas, resolve_pq_impl

    lookup = pq_lookup_pallas if resolve_pq_impl(impl) == "pallas" else pq_lookup
    tables = pq_distance_tables(codebook, queries_f32)
    m = codebook.num_chunks

    def fetch_codes(cand_ids, parents):
        if nbr_codes is not None and parents is not None:
            q = cand_ids.shape[0]
            return nbr_codes[parents].reshape(q, -1, m)  # aligned row gather
        return codes[cand_ids]  # [Q, C, m] scattered gather

    def distance_fn(cand_ids, parents=None):
        return lookup(tables, fetch_codes(cand_ids, parents))

    if fused_rows is not None:
        r = fused_rows.shape[1] // (4 + m)

        def frontier_fn(parents):
            # [Q, beam, r*(4+m)] ONE gather, then decode + lookup
            ids, cand_codes = frontier_decode_xla(fused_rows[parents], m, r)
            return ids, lookup(tables, cand_codes)

        distance_fn.frontier_fn = frontier_fn

    return distance_fn


def rerank_topk(
    queries_f32: jnp.ndarray,
    vectors: jnp.ndarray,
    vector_norms: jnp.ndarray,
    visited_ids: jnp.ndarray,
    k: int,
    precision=None,
):
    """Exact re-rank of all expanded nodes, then top-k.

    Replaces the reference's compute_L2Dist + compute_NearestNeighbours pair
    (bang_search.cu:1254-1368): one gathered batched matmul for the distances
    and `lax.top_k` instead of a per-query merge sort.
    Returns (ids [Q, k] i32, dists [Q, k] f32 squared L2).

    vectors may be a u8-packed f32 table (ops/l2.decode_row_gather); norms
    are recomputed from the gathered rows (cheaper than a scattered gather
    of vector_norms, and f32-exact like the reference's re-rank).
    """
    from bang_jax.ops.l2 import decode_row_gather

    safe_ids = jnp.maximum(visited_ids, 0)
    vecs = decode_row_gather(vectors[safe_ids], queries_f32.shape[-1])  # [Q, MI, D]
    d = l2_distance_to_candidates(queries_f32, vecs, None, precision=precision)
    d = jnp.where(visited_ids == INVALID_ID, jnp.inf, d)
    neg, idx = jax.lax.top_k(-d, k)
    ids = jnp.take_along_axis(visited_ids, idx, axis=1)
    return ids, -neg
