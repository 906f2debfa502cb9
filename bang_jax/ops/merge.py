"""Worklist (best-L set) maintenance: sorted merge and parent selection.

Re-design of the reference's three cooperative kernels —
`compute_BestLSets_par_sort_msort` (per-query parallel merge sort of the R+1
candidates, BANG_Base/bang_search.cu:1533-1585), `compute_BestLSets_par_merge`
(shared-memory merge into the length-L worklist, :1605-1715), and
`compute_parent1/2` (next-parent selection, :1384-1521) — as two fixed-shape
XLA ops:

  * merge_worklist: a single stable `lax.sort` of concat(worklist, candidates)
    by distance with (id, visited) carried as co-sorted operands, sliced to L.
    One sort subsumes both the candidate msort and the worklist merge.
  * select_parents_beam: the next `beam` parents are the first unvisited
    worklist entries (top-k over the unvisited mask of the distance-sorted
    list); they are marked visited in place, and a query stays active while
    any unvisited entry remains — the reference's `d_nextIter` global flag is
    `active.any()`. beam=1 reproduces the reference's single-parent schedule.

Empty slots carry id INVALID_ID, distance +inf, visited=True, so they sort to
the tail and are never selected.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from bang_jax.constants import INVALID_ID

# Merge implementation: "sort" (one stable (L+C)-lane 3-operand lax.sort) or
# "ranked" (merge-path: sort only the C candidates, then dense compare+reduce
# rank computation + per-row gathers — no cross-lane shuffles over L+C lanes;
# bit-identical results). Selected at trace time; override per-process via
# BANG_MERGE_IMPL for measurement (scripts/profile_base_step.py times both).
_MERGE_IMPL = os.environ.get("BANG_MERGE_IMPL", "sort")


def init_worklist(q: int, l: int):
    """Empty worklist state: (+inf distances, INVALID_ID, visited=True)."""
    return (
        jnp.full((q, l), jnp.inf, dtype=jnp.float32),
        jnp.full((q, l), INVALID_ID, dtype=jnp.int32),
        jnp.ones((q, l), dtype=jnp.bool_),
    )


def merge_worklist(
    wl_dist: jnp.ndarray,
    wl_ids: jnp.ndarray,
    wl_vis: jnp.ndarray,
    cand_dist: jnp.ndarray,
    cand_ids: jnp.ndarray,
    impl: str | None = None,
):
    """Merge candidates into the sorted worklist, keeping the best L.

    cand_dist must already be +inf for filtered-out lanes. Returns the new
    (wl_dist, wl_ids, wl_vis), each [Q, L]. The worklist side is always
    sorted (init_worklist's all-inf state trivially; every merge output by
    construction) — both implementations rely on that invariant.
    """
    if (impl or _MERGE_IMPL) == "ranked":
        return merge_worklist_ranked(wl_dist, wl_ids, wl_vis, cand_dist, cand_ids)
    l = wl_dist.shape[1]
    keys = jnp.concatenate([wl_dist, cand_dist], axis=1)
    ids = jnp.concatenate([wl_ids, cand_ids], axis=1)
    vis = jnp.concatenate([wl_vis, jnp.zeros_like(cand_ids, dtype=jnp.bool_)], axis=1)
    sk, si, sv = jax.lax.sort((keys, ids, vis), dimension=1, num_keys=1, is_stable=True)
    sk, si, sv = sk[:, :l], si[:, :l], sv[:, :l]
    # Slots holding INVALID_ID must stay non-selectable.
    sv = sv | (si == INVALID_ID)
    return sk, si, sv


def merge_worklist_ranked(
    wl_dist: jnp.ndarray,
    wl_ids: jnp.ndarray,
    wl_vis: jnp.ndarray,
    cand_dist: jnp.ndarray,
    cand_ids: jnp.ndarray,
):
    """Merge-path formulation of merge_worklist (bit-identical output).

    A full sort of the L+C entries x 3 operands re-sorts the worklist side,
    which is ALREADY sorted. Here only the C candidates are sorted (C << L,
    2 operands), and the merged order is computed with dense compare+reduce
    ranks — elementwise work plus three per-row aligned gathers:

      rank_wl[i] = i + #{j: cd[j] <  wl[i]}   (ties -> worklist, preserving
      rank_c[j]  = j + #{i: wl[i] <= cd[j]}    the stable concat-sort order)

    Output slot k then takes wl[k - f(k)] where f(k) = #{j: rank_c[j] < k}
    counts the candidates placed before k, falling back to the candidate at
    sorted position f(k) when that worklist item's rank isn't k (merge-path).
    """
    q, l = wl_dist.shape
    c = cand_dist.shape[1]
    iota_l = jnp.arange(l, dtype=jnp.int32)[None]
    cd, ci = jax.lax.sort(
        (cand_dist, cand_ids), dimension=1, num_keys=1, is_stable=True
    )
    cnt_wl = (cd[:, None, :] < wl_dist[:, :, None]).sum(-1, dtype=jnp.int32)
    rank_wl = iota_l + cnt_wl  # [Q, L]
    cnt_c = (wl_dist[:, :, None] <= cd[:, None, :]).sum(1, dtype=jnp.int32)
    rank_c = jnp.arange(c, dtype=jnp.int32)[None] + cnt_c  # [Q, C]
    # f[k] = candidates placed before output slot k; g[k] = k - f[k] is the
    # worklist index that fills slot k when a candidate doesn't.
    f = (rank_c[:, None, :] < iota_l[:, :, None]).sum(-1, dtype=jnp.int32)
    g = iota_l - f  # 0 <= g <= k < L (ranks are distinct)
    f_s = jnp.minimum(f, c - 1)  # f == C only when from_wl is True
    from_wl = jnp.take_along_axis(rank_wl, g, axis=1) == iota_l
    out_d = jnp.where(from_wl, jnp.take_along_axis(wl_dist, g, axis=1),
                      jnp.take_along_axis(cd, f_s, axis=1))
    out_i = jnp.where(from_wl, jnp.take_along_axis(wl_ids, g, axis=1),
                      jnp.take_along_axis(ci, f_s, axis=1))
    out_v = from_wl & jnp.take_along_axis(wl_vis, g, axis=1)
    out_v = out_v | (out_i == INVALID_ID)
    return out_d, out_i, out_v


def select_parents_beam(
    wl_dist: jnp.ndarray, wl_ids: jnp.ndarray, wl_vis: jnp.ndarray, beam: int
):
    """Pick the first `beam` unvisited worklist entries per query and mark
    them visited.

    Multi-parent expansion — the reference expands one parent per iteration
    and notes wider expansion as future work (bang_search.cu:776-778); here
    a wider beam amortizes the per-iteration sort/filter cost and divides the
    sequential iteration count. beam=1 reproduces the reference schedule.

    Returns (parents [Q, beam] i32 — 0-filled where invalid; valid [Q, beam]
    bool; active [Q] bool; updated wl_vis).
    """
    q, l = wl_vis.shape
    unvis = ~wl_vis
    pos = jax.lax.broadcasted_iota(jnp.int32, (q, l), 1)
    # keys: earlier unvisited slots first; visited slots sink below -(l+1)
    key = jnp.where(unvis, -pos, jnp.int32(-(l + 2)))
    topk, topi = jax.lax.top_k(key, beam)
    valid = topk > jnp.int32(-(l + 2))
    parents = jnp.take_along_axis(wl_ids, topi, axis=1)
    parents = jnp.where(valid, parents, 0)
    rows = jnp.broadcast_to(jnp.arange(q, dtype=jnp.int32)[:, None], (q, beam))
    mark_idx = jnp.where(valid, topi, l)  # out-of-bounds lanes dropped
    wl_vis = wl_vis.at[rows, mark_idx].set(True, mode="drop")
    active = valid[:, 0]
    return parents, valid, active, wl_vis
