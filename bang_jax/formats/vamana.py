"""Native Vamana graph construction — fully device-resident, batched.

The reference relies on the external DiskANN `build_disk_index` for offline
graph construction (README.md:42-58) — the graph build itself is not part of
the reference codebase. This module supplies a self-contained equivalent so
the framework covers the whole pipeline: a batched Vamana builder in the
DiskANN style (greedy-search candidate collection + alpha robust prune +
reverse-edge insertion).

Design: the ENTIRE per-batch insert — greedy search over the
evolving graph, robust prune, adjacency scatter, reverse-edge append, and the
re-prune of overflowing targets — is ONE jit-compiled program with the
adjacency donated in place. The host only streams batch ids down (B*4 bytes)
and never reads anything back until the build finishes, so batches pipeline
through the dispatch queue and the build runs at device speed (the previous
design shipped every touched adjacency row over the host link each batch,
which dominated build time ~50x).

Algorithm (standard Vamana):
  1. start from a random (R/2)-regular graph (slack absorbs reverse edges);
  2. for each point p (in batches): greedy-search p from the medoid over the
     current graph, collect the visited set V;
  3. adj[p] = RobustPrune(p, V ∪ adj[p], alpha, R) — greedily keep the
     nearest candidate c, discard every candidate c' with
     alpha * d(c, c') <= d(p, c');
  4. for each kept edge (p -> c): append the reverse edge c -> p into c's
     degree slack; targets that overflow R get a device re-prune (capped at
     k_overflow targets per batch; excess reverse edges are dropped and
     counted);
  5. run n_passes passes (alpha = 1.0 for all but the last).
"""

from __future__ import annotations

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("r", "alpha"))
def _robust_prune_batch(p_vecs, cand_vecs, cand_dists, cand_valid, r, alpha):
    """Batched alpha-RNG robust prune.

    p_vecs: [B, D]; cand_vecs: [B, C, D] f32; cand_dists: [B, C] squared L2
    to p; cand_valid: [B, C]. Returns (sel_idx [B, r] int32 positions into the
    candidate axis, sel_valid [B, r] bool).
    """
    b, c, _ = cand_vecs.shape
    alive = cand_valid
    big = jnp.inf

    def body(i, carry):
        alive, sel_idx, sel_valid = carry
        d = jnp.where(alive, cand_dists, big)
        pick = jnp.argmin(d, axis=1)  # [B]
        valid = jnp.take_along_axis(alive, pick[:, None], axis=1)[:, 0]
        sel_idx = sel_idx.at[:, i].set(jnp.where(valid, pick, -1))
        sel_valid = sel_valid.at[:, i].set(valid)
        # occlusion rule: drop candidates closer to the pick than (scaled) to p
        pick_vec = jnp.take_along_axis(cand_vecs, pick[:, None, None], axis=1)[:, 0]
        d_cc = ((cand_vecs - pick_vec[:, None, :]) ** 2).sum(-1)  # [B, C]
        occluded = alpha * d_cc <= cand_dists
        alive = alive & ~occluded & (
            jax.lax.broadcasted_iota(jnp.int32, (b, c), 1) != pick[:, None]
        )
        return alive, sel_idx, sel_valid

    sel_idx = jnp.full((b, r), -1, jnp.int32)
    sel_valid = jnp.zeros((b, r), jnp.bool_)
    _, sel_idx, sel_valid = jax.lax.fori_loop(
        0, r, body, (alive, sel_idx, sel_valid)
    )
    return sel_idx, sel_valid


def _prune_ids(vectors, norms, p_ids, cand, r, alpha):
    """In-jit robust prune of a raw candidate id list (dups/self/negatives
    tolerated). Returns (rows [B, r] int32 self-padded, degrees [B] int32)."""
    from bang_jax.ops.l2 import l2_distance_to_candidates

    # row-sort ids; mask duplicates (adjacent after sort), self, and padding
    cs = jnp.sort(cand, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros_like(cs[:, :1], dtype=bool), cs[:, 1:] == cs[:, :-1]], axis=1
    )
    valid = (cs >= 0) & (cs != p_ids[:, None]) & ~dup
    safe = jnp.maximum(cs, 0)

    p_vecs = vectors[p_ids].astype(jnp.float32)
    cand_vecs = vectors[safe].astype(jnp.float32)
    cand_d = l2_distance_to_candidates(p_vecs, cand_vecs, norms[safe])
    cand_d = jnp.where(valid, cand_d, jnp.inf)
    sel_idx, sel_valid = _robust_prune_batch(p_vecs, cand_vecs, cand_d, valid, r, alpha)
    rows = jnp.where(
        sel_valid,
        jnp.take_along_axis(safe, jnp.maximum(sel_idx, 0), axis=1),
        p_ids[:, None],
    ).astype(jnp.int32)
    return rows, sel_valid.sum(axis=1).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("r", "alpha", "l", "max_iters", "k_overflow", "max_in"),
    donate_argnums=(0, 1),
)
def _insert_batch(
    adj, degrees, vectors, norms, p_ids, medoid,
    r, alpha, l, max_iters, k_overflow, max_in, extra_cand=None,
):
    """Insert a batch of points: search + prune + scatter + reverse edges.
    One device program; adj/degrees are donated and updated in place.
    Returns (adj, degrees, n_dropped_reverse_edges).

    extra_cand [B, P] (optional): additional candidate ids joined into the
    prune pool — streaming inserts pass intra-batch nearest peers here so a
    batch inserted into a small graph links to its own points, not just the
    medoid's neighborhood (models/streaming.py)."""
    from bang_jax.models.traversal import make_exact_distance_fn, run_traversal

    n = adj.shape[0]
    b = p_ids.shape[0]
    q_vecs = vectors[p_ids].astype(jnp.float32)
    dist_fn = make_exact_distance_fn(q_vecs, vectors, norms)
    final = run_traversal(adj, dist_fn, medoid, b, l, max_iters, use_bloom=False)

    # Vamana candidate pool: the visited set of the greedy search + old edges
    pool = [final.visited_ids, adj[p_ids]]
    if extra_cand is not None:
        pool.append(extra_cand)
    cand = jnp.concatenate(pool, axis=1)
    new_rows, new_deg = _prune_ids(vectors, norms, p_ids, cand, r, alpha)
    adj = adj.at[p_ids].set(new_rows)
    degrees = degrees.at[p_ids].set(new_deg)

    # ---- reverse edges (p -> c becomes c -> p), all on device ----
    src = jnp.repeat(p_ids, r)  # [B*r]
    dst = new_rows.reshape(-1)
    valid = dst != src  # self-padding rows produce dst == src
    # skip targets that already list src (would waste a slot forever)
    already = (adj[dst] == src[:, None]).any(axis=1)
    valid &= ~already

    key = jnp.where(valid, dst, n)  # invalid edges sort to the end
    order = jnp.argsort(key)
    dsts = key[order]
    srcs = src[order]
    edge_valid = dsts < n
    pos = jnp.arange(b * r, dtype=jnp.int32)
    isnew = jnp.concatenate(
        [jnp.ones((1,), bool), dsts[1:] != dsts[:-1]], axis=0
    )
    first = jax.lax.associative_scan(jnp.maximum, jnp.where(isnew, pos, 0))
    rank = pos - first  # rank of each edge within its dst group
    slot = degrees[jnp.minimum(dsts, n - 1)] + rank
    fits = edge_valid & (slot < r)
    # (dst, slot) pairs are unique within the batch -> conflict-free scatter
    adj = adj.at[jnp.where(fits, dsts, n), jnp.clip(slot, 0, r - 1)].set(
        srcs, mode="drop"
    )
    degrees = degrees.at[jnp.where(fits, dsts, n)].add(1, mode="drop")

    # ---- overflowing targets: re-prune current edges + incoming ----
    ovf = edge_valid & (slot >= r)
    ovf_ids = jnp.unique(jnp.where(ovf, dsts, n), size=k_overflow, fill_value=n)
    row = jnp.minimum(jnp.searchsorted(ovf_ids, dsts), k_overflow - 1)
    col = slot - r
    # guard: the edge's dst actually made it into the capped unique set
    inc_ok = ovf & (ovf_ids[row] == dsts) & (col < max_in)
    inc = (
        jnp.full((k_overflow, max_in), -1, jnp.int32)
        .at[jnp.where(inc_ok, row, k_overflow), jnp.clip(col, 0, max_in - 1)]
        .set(srcs, mode="drop")
    )
    t_valid = ovf_ids < n
    safe_t = jnp.minimum(ovf_ids, n - 1).astype(jnp.int32)
    cand_t = jnp.concatenate([adj[safe_t], inc], axis=1)  # [K, r+max_in]
    t_rows, t_deg = _prune_ids(vectors, norms, safe_t, cand_t, r, alpha)
    adj = adj.at[jnp.where(t_valid, ovf_ids, n)].set(t_rows, mode="drop")
    degrees = degrees.at[jnp.where(t_valid, ovf_ids, n)].set(t_deg, mode="drop")

    n_dropped = (ovf & ~inc_ok).sum()
    return adj, degrees, n_dropped


def _squared_norms_host(vectors: np.ndarray, block: int = 1_000_000) -> np.ndarray:
    out = np.empty(vectors.shape[0], np.float32)
    for s in range(0, vectors.shape[0], block):
        v = vectors[s : s + block].astype(np.float64)
        out[s : s + block] = (v * v).sum(-1).astype(np.float32)
    return out


def build_vamana_graph(
    vectors: np.ndarray,
    r: int = 32,
    l_build: int = 48,
    alpha: float = 1.44,  # on SQUARED distances; == DiskANN's 1.2 on plain
    batch: int = 1024,
    seed: int = 0,
    n_passes: int = 2,
    k_overflow: int | None = None,
    verbose: bool = True,
    medoid: int | None = None,
    return_device: bool = False,
    init: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Build a Vamana graph. Returns (adj [N, r] self-padded, degrees, medoid).

    The build is itself a device workload: each batch runs as one jit program
    (search over the evolving graph + prune + reverse edges) with the
    adjacency donated in place; the host never blocks on the device inside a
    pass, so dispatches pipeline. Scales to 10M+ points on one device.

    vectors may be a host numpy array OR an already-device-resident jnp array
    (the sharded pipeline in formats/bigbuild.py assembles shard vectors on
    device, sparing a host round trip).
    Pass `medoid` explicitly in that case. return_device=True skips the final
    adjacency download and returns device arrays.
    """
    is_device = not isinstance(vectors, np.ndarray)
    if medoid is None:
        from bang_jax.formats.synthetic import medoid_of

        assert not is_device, "pass medoid= explicitly for device-resident vectors"
        medoid = medoid_of(vectors)

    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    if init is not None:
        # Warm start from an existing graph (DiskANN-style incremental
        # build): a single warm pass behaves like the second pass of a
        # 2-pass build — the greedy searches navigate real structure from
        # batch one — and, unlike n_passes, it also supports DEGREE
        # upgrades (e.g. seeding an R=64 build from an R=32 graph; the
        # extra slots are slack for reverse edges). init rows must follow
        # this module's convention: real edges first, self-padding after.
        adj0, deg0 = init
        r_in = adj0.shape[1]
        assert r_in <= r, f"init degree {r_in} exceeds target r={r}"
        adj = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r)).copy()
        adj[:, :r_in] = adj0
        degrees = np.minimum(deg0.astype(np.int32), r_in)
        # Enforce the convention regardless of what the caller passed: slots
        # >= degree become self-padding (packed _disk.bin rows are ZERO-padded
        # — leaving those zeros in would add spurious edges to node 0).
        pad = np.arange(r, dtype=np.int32)[None, :] >= degrees[:, None]
        np.copyto(adj, np.arange(n, dtype=np.int32)[:, None], where=pad)
    else:
        # start at half degree: the slack absorbs reverse-edge appends so
        # that only overflowing nodes need a device re-prune (DiskANN's
        # scheme)
        r0 = max(1, r // 2)
        adj = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r)).copy()
        adj[:, :r0] = rng.integers(0, n, size=(n, r0), dtype=np.int32)
        self_hit = adj[:, :r0] == np.arange(n, dtype=np.int32)[:, None]
        adj[:, :r0][self_hit] = (adj[:, :r0][self_hit] + 1) % n
        degrees = np.full(n, r0, np.int32)

    adj_dev = jnp.asarray(adj)
    deg_dev = jnp.asarray(degrees)
    del adj, degrees
    if is_device:
        vec_dev = vectors
        # cast INSIDE the jit: XLA fuses it into the reduction (a separate
        # .astype would materialize an f32 copy of the whole table)
        norms_dev = jax.jit(
            lambda v: (v.astype(jnp.float32) ** 2).sum(-1)
        )(vec_dev)
    else:
        vec_dev = jnp.asarray(vectors)
        norms_dev = jnp.asarray(_squared_norms_host(vectors))
    medoid_dev = jnp.int32(medoid)

    batch = min(batch, max(256, n))
    if k_overflow is None:
        k_overflow = max(512, batch)
    max_in = r
    max_iters = l_build + 16

    alphas = [1.0] * (n_passes - 1) + [float(alpha)]
    t_start = time.time()
    order = np.arange(n)
    dropped = None
    for pass_i, a in enumerate(alphas):
        rng.shuffle(order)
        n_batches = -(-n // batch)
        for bi, s in enumerate(range(0, n, batch)):
            p_ids = order[s : s + batch]
            if len(p_ids) < batch:  # keep one compiled shape
                # pad with OTHER ids from the shuffled order (cycling the
                # short remainder would re-insert the same points several
                # times in one batch: each copy gets a distinct reverse-edge
                # slot, permanently eating degree slack). Distinct whenever
                # batch <= n; wraps only for datasets smaller than a batch.
                p_ids = np.resize(order, s + batch)[s : s + batch]
            adj_dev, deg_dev, dropped = _insert_batch(
                adj_dev, deg_dev, vec_dev, norms_dev,
                jnp.asarray(p_ids.astype(np.int32)), medoid_dev,
                r=r, alpha=a, l=l_build, max_iters=max_iters,
                k_overflow=k_overflow, max_in=max_in,
            )
            if verbose and bi % 100 == 0:
                # the scalar fetch is the only sync point (progress heartbeat)
                print(
                    f"[vamana] pass {pass_i} batch {bi}/{n_batches} "
                    f"dropped_rev={int(jax.device_get(dropped))} "
                    f"t={time.time() - t_start:.0f}s",
                    file=sys.stderr, flush=True,
                )
    if verbose:
        jax.block_until_ready(deg_dev)
        print(
            f"[vamana] built n={n} r={r} in {time.time() - t_start:.0f}s",
            file=sys.stderr, flush=True,
        )
    if return_device:
        return adj_dev, deg_dev, medoid
    adj = np.asarray(jax.device_get(adj_dev))
    degrees = np.asarray(jax.device_get(deg_dev))
    return adj, degrees, medoid
