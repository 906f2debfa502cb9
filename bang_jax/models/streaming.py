"""Streaming (mutable) index: online inserts, lazy deletes, consolidation.

Beyond the reference: BANG searches a frozen DiskANN index — graph
construction is an offline external step (reference README.md:42-58) and no
reference component mutates a loaded index. Production serving needs index
freshness, so this module adds FreshVamana-style streaming updates (the
public FreshDiskANN algorithm: insert = incremental Vamana insert; delete =
tombstone + deferred repair) on top of the device-resident build machinery:

  * insert — `formats/vamana._insert_batch` IS an online insert (greedy
    search over the live graph + alpha robust prune + reverse edges, one
    donated-in-place jit program). Capacity is pre-allocated so every shape
    stays static; freed slots are recycled before the high-water mark grows.
  * delete — tombstones. Traversal still routes THROUGH deleted nodes
    (eagerly unlinking them would disconnect the graph); search results
    filter them on device.
  * consolidate — repairs every row that points at a tombstone by robust-
    pruning the union of its live edges and its deleted neighbors'
    neighborhoods (the FreshDiskANN repair rule), batched on device, then
    frees the tombstone slots for reuse and re-elects the medoid if it was
    deleted.

Static-shape discipline: `deleted` doubles as the "not live" mask —
empty slots start deleted=True, insert clears the flag, delete sets it —
so search-side filtering and consolidation need exactly one [capacity]
bool gather and no dynamic shapes anywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bang_jax.constants import INVALID_ID
from bang_jax.formats.vamana import _insert_batch, _prune_ids
from bang_jax.utils.config import SearchParams


@functools.partial(
    jax.jit, static_argnames=("l", "k", "max_iters", "beam")
)
def _search_streaming_jit(
    adj, vectors, norms, deleted, queries, medoid, l, k, max_iters, beam
):
    from bang_jax.models.traversal import make_exact_distance_fn, run_traversal

    q = queries.shape[0]
    queries_f32 = queries.astype(jnp.float32)
    dist_fn = make_exact_distance_fn(
        queries_f32, vectors, norms, precision=jax.lax.Precision.HIGHEST
    )
    final = run_traversal(
        adj, dist_fn, medoid, q, l, max_iters, use_bloom=False, beam=beam
    )
    # Tombstones occupy worklist slots during traversal (they must: routing
    # through them preserves connectivity) but are filtered from the answer.
    wl_ids, wl_dist = final.wl_ids, final.wl_dist
    dead = deleted[jnp.maximum(wl_ids, 0)] | (wl_ids == INVALID_ID)
    d = jnp.where(dead, jnp.inf, wl_dist)
    neg, idx = jax.lax.top_k(-d, k)
    ids = jnp.take_along_axis(wl_ids, idx, axis=1)
    ids = jnp.where(jnp.isinf(neg), INVALID_ID, ids)
    return ids, -neg, final.it


@functools.partial(
    jax.jit, static_argnames=("r", "alpha"), donate_argnums=(0, 1)
)
def _repair_batch(adj, degrees, vectors, norms, deleted, row_ids, r, alpha):
    """Repair rows that point at tombstones (one consolidation batch).

    Candidate pool per row = its live edges + the full neighborhoods of its
    deleted edges (tombstones masked); alpha robust prune picks <= r. Rows
    with no deleted edges (or themselves deleted) pass through untouched.
    """
    rows = adj[row_ids]  # [B, R]
    self_pad = rows == row_ids[:, None]
    nbr_deleted = deleted[rows] & ~self_pad
    needs = nbr_deleted.any(axis=1) & ~deleted[row_ids]

    b = rows.shape[0]
    # deleted neighbors' neighborhoods (only where the edge was deleted)
    expanded = adj[rows].reshape(b, -1)  # [B, R*R]
    exp_mask = jnp.repeat(nbr_deleted, rows.shape[1], axis=1)
    expanded = jnp.where(exp_mask, expanded, -1)
    kept = jnp.where(nbr_deleted | self_pad, -1, rows)
    cand = jnp.concatenate([kept, expanded], axis=1)
    # tombstones never re-enter adjacency
    cand = jnp.where(deleted[jnp.maximum(cand, 0)], -1, cand)

    new_rows, new_deg = _prune_ids(vectors, norms, row_ids, cand, r, alpha)
    adj = adj.at[row_ids].set(jnp.where(needs[:, None], new_rows, rows))
    degrees = degrees.at[row_ids].set(
        jnp.where(needs, new_deg, degrees[row_ids])
    )
    return adj, degrees, needs.sum()


@functools.partial(jax.jit, static_argnames=("p",))
def _batch_peers(vecs, ids, p):
    """Top-p intra-batch nearest peer ids per batch point ([B, p] i32).

    One [B, B] matmul; self excluded. Joined into the insert candidate
    pool so simultaneous inserts can link to each other."""
    v = vecs.astype(jnp.float32)
    n2 = (v ** 2).sum(-1)
    d = n2[:, None] + n2[None, :] - 2.0 * (v @ v.T)
    d = d.at[jnp.diag_indices(d.shape[0])].set(jnp.inf)
    _, idx = jax.lax.top_k(-d, p)
    return ids[idx]


@jax.jit
def _elect_medoid(vectors, norms, deleted):
    """Nearest live point to the live centroid (device reduction)."""
    live = ~deleted
    cnt = jnp.maximum(live.sum(), 1)
    centroid = jnp.where(
        live[:, None], vectors.astype(jnp.float32), 0.0
    ).sum(0) / cnt
    d = norms - 2.0 * (vectors.astype(jnp.float32) @ centroid)
    return jnp.argmin(jnp.where(live, d, jnp.inf)).astype(jnp.int32)


class StreamingIndex:
    """Mutable exact-traversal index with a fixed capacity.

    All arrays are device-resident at full capacity; `deleted` marks both
    tombstones and never-used slots, so "live" is exactly `~deleted`.
    """

    def __init__(self, capacity: int, dim: int, r: int = 32,
                 dtype=np.float32, l_build: int = 48, alpha: float = 1.44,
                 k_overflow: int = 512):
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.r = int(r)
        self.l_build = int(l_build)
        self.alpha = float(alpha)
        self.k_overflow = int(k_overflow)
        self.vectors = jnp.zeros((capacity, dim), dtype)
        self.norms = jnp.zeros((capacity,), jnp.float32)
        iota = jnp.arange(capacity, dtype=jnp.int32)
        self.adj = jnp.broadcast_to(iota[:, None], (capacity, r)).copy()
        self.degrees = jnp.zeros((capacity,), jnp.int32)
        self.deleted = jnp.ones((capacity,), jnp.bool_)  # empty == deleted
        self.medoid = 0
        self.hwm = 0  # high-water mark (ids ever allocated)
        self.free: list[int] = []  # consolidated slots, ready for reuse
        self.n_tombstones = 0

    @classmethod
    def from_built(cls, vectors: np.ndarray, adj: np.ndarray,
                   degrees: np.ndarray, medoid: int, capacity: int,
                   **kwargs) -> "StreamingIndex":
        """Wrap an offline-built graph (e.g. build_vamana_graph output) in a
        mutable index with room to grow."""
        n, dim = vectors.shape
        r = adj.shape[1]
        assert capacity >= n, "capacity below the built index size"
        ix = cls(capacity, dim, r, dtype=vectors.dtype, **kwargs)
        ix.vectors = ix.vectors.at[:n].set(jnp.asarray(vectors))
        ix.norms = ix.norms.at[:n].set(
            (jnp.asarray(vectors, jnp.float32) ** 2).sum(-1)
        )
        ix.adj = ix.adj.at[:n].set(jnp.asarray(adj, jnp.int32))
        ix.degrees = ix.degrees.at[:n].set(jnp.asarray(degrees, jnp.int32))
        ix.deleted = ix.deleted.at[:n].set(False)
        ix.medoid = int(medoid)
        ix.hwm = n
        return ix

    @property
    def n_live(self) -> int:
        return self.hwm - len(self.free) - self.n_tombstones

    def _alloc(self, b: int) -> np.ndarray:
        reuse = min(b, len(self.free))
        ids = self.free[:reuse]
        self.free = self.free[reuse:]
        grow = b - reuse
        if self.hwm + grow > self.capacity:
            raise ValueError(
                f"capacity exceeded: {self.hwm}+{grow} > {self.capacity} "
                "(consolidate() frees tombstone slots)"
            )
        ids += list(range(self.hwm, self.hwm + grow))
        self.hwm += grow
        return np.asarray(ids, np.int32)

    def insert(self, batch: np.ndarray) -> np.ndarray:
        """Insert a batch of vectors; returns their assigned ids [B] i32.

        Each sub-batch is one donated jit program (greedy search over the
        live graph + robust prune + reverse edges —
        formats/vamana._insert_batch) with two streaming-specific additions:
        intra-batch nearest peers join the candidate pool (a batch landing
        in a small graph must link to its own points, not only the medoid's
        neighborhood), and while the graph is smaller than the batch the
        insert ramps in doubling chunks so early points see real structure.
        """
        batch = np.asarray(batch)
        assert batch.ndim == 2 and batch.shape[1] == self.dim, batch.shape
        out = []
        s = 0
        while s < batch.shape[0]:
            chunk = max(64, self.n_live)  # doubling ramp; one shape at scale
            sub = batch[s : s + chunk]
            out.append(self._insert_chunk(sub))
            s += len(sub)
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _insert_chunk(self, batch: np.ndarray) -> np.ndarray:
        b = batch.shape[0]
        first = self.n_live == 0
        ids_np = self._alloc(b)
        ids = jnp.asarray(ids_np)
        vecs = jnp.asarray(batch, self.vectors.dtype)
        self.vectors = self.vectors.at[ids].set(vecs)
        self.norms = self.norms.at[ids].set(
            (vecs.astype(jnp.float32) ** 2).sum(-1)
        )
        # recycled slots: scrub the previous tenant's adjacency so it can't
        # leak into the candidate pool
        self.adj = self.adj.at[ids].set(
            jnp.broadcast_to(ids[:, None], (b, self.r))
        )
        self.degrees = self.degrees.at[ids].set(0)
        self.deleted = self.deleted.at[ids].set(False)
        if first:
            self.medoid = int(ids_np[0])
        peers = _batch_peers(vecs, ids, min(8, max(1, b - 1)))
        self.adj, self.degrees, _dropped = _insert_batch(
            self.adj, self.degrees, self.vectors, self.norms, ids,
            jnp.int32(self.medoid),
            r=self.r, alpha=self.alpha, l=self.l_build,
            max_iters=self.l_build + 16,
            k_overflow=min(self.k_overflow, max(256, b)), max_in=self.r,
            extra_cand=peers,
        )
        return ids_np

    def delete(self, ids: np.ndarray) -> None:
        """Tombstone a batch of ids (lazy: slots free on consolidate())."""
        ids = np.asarray(ids, np.int32)
        self.deleted = self.deleted.at[jnp.asarray(ids)].set(True)
        self.n_tombstones += len(ids)

    def search(self, queries: np.ndarray, params: SearchParams):
        """Returns (ids [Q, k] i32 — INVALID_ID padded, dists [Q, k] f32).

        Tombstones are routed through but filtered from results; they occupy
        worklist slots, so at a high tombstone fraction raise L or
        consolidate() (FreshDiskANN recommends repairing at ~10-20%).
        """
        ids, dists, _ = _search_streaming_jit(
            self.adj, self.vectors, self.norms, self.deleted,
            jnp.asarray(queries), jnp.int32(self.medoid),
            l=params.L, k=params.k, max_iters=params.max_iters,
            beam=params.beam_width,
        )
        return np.asarray(ids), np.asarray(dists)

    def consolidate(self, batch: int = 512) -> int:
        """Repair edges into tombstones and free their slots; returns the
        number of rows repaired."""
        # Repaired counts stay ON DEVICE inside the loop: a blocking scalar
        # readback per batch costs a full host-link round trip (~390 of them
        # at hwm=200K dominated the measured 11.2 s consolidate in round 4);
        # collecting the device scalars and fetching once makes the loop a
        # pure dispatch pipeline.
        ns = []
        for s in range(0, self.hwm, batch):
            row_ids = np.arange(s, min(s + batch, self.hwm), dtype=np.int32)
            if len(row_ids) < batch:  # keep one compiled shape
                row_ids = np.resize(row_ids, batch)
            self.adj, self.degrees, n = _repair_batch(
                self.adj, self.degrees, self.vectors, self.norms,
                self.deleted, jnp.asarray(row_ids),
                r=self.r, alpha=self.alpha,
            )
            ns.append(n)
        repaired = int(np.sum(jax.device_get(ns))) if ns else 0
        # free the tombstone slots (nothing points at them now)
        dead = np.flatnonzero(
            np.asarray(jax.device_get(self.deleted[: self.hwm]))
        )
        in_free = set(self.free)
        freed = [int(i) for i in dead if i not in in_free]
        self.free.extend(freed)
        self.n_tombstones = 0
        if freed and self.medoid in set(freed) and self.n_live > 0:
            self.medoid = int(jax.device_get(
                _elect_medoid(self.vectors, self.norms, self.deleted)
            ))
        return repaired
