"""Index partitioning for multi-chip search.

The reference is single-GPU (SURVEY.md §2.3: no NCCL/MPI anywhere); scaling
past one device is an extension. The design: shard the *dataset*
across devices — each chip holds an independent sub-index (its own navigable
graph + PQ codes over a contiguous node range, sharing one PQ codebook), every
chip searches its shard for all queries in its data-parallel row, and the
per-shard top-k results are merged with an all-gather + top-k. This is the
standard sharded-IVF/graph pattern: recall matches a monolithic index when
per-shard k equals the final k, at the cost of S searches of N/S-point graphs
(sub-linear iteration counts make this favorable, and device memory — 80 GB
per H100, as on the reference's A100, of which a JAX process takes 60 GB by
default — is the binding constraint at billion scale).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from bang_jax.formats import synthetic
from bang_jax.ops.pq import PQCodebook, prepare_pq_codebook


class ShardedIndex(NamedTuple):
    """Stacked per-shard index arrays; leading axis = shard (sharded over the
    'model' mesh axis at dispatch)."""

    adj: np.ndarray  # [S, n_loc, R] int32 (local ids, self-padded)
    vectors: np.ndarray  # [S, n_loc, D]
    vector_norms: np.ndarray  # [S, n_loc] f32
    codes: Optional[np.ndarray]  # [S, n_loc, m] uint8 or None
    codebook: Optional[PQCodebook]  # replicated
    medoids: np.ndarray  # [S] int32 local medoid ids
    id_base: np.ndarray  # [S] int32 global id offset of each shard
    nbr_codes: Optional[np.ndarray] = None  # [S, n_loc, R*m] u8 — per-shard
    # neighbor-aligned code rows (the tuned single-chip gather layout,
    # models/index.py nbr_codes), so the sharded path runs at the same op
    # point as one chip
    fused_rows: Optional[np.ndarray] = None  # [S, n_loc, R*(4+m)] u8 —
    # per-shard fused frontier rows (ids + codes in ONE gather/parent, the
    # single-chip preferred layout when R % 64 == 0; local ids, offset by
    # id_base at merge)

    @property
    def n_shards(self) -> int:
        return self.adj.shape[0]

    @property
    def n_local(self) -> int:
        return self.adj.shape[1]


def build_sharded_index(
    vectors: np.ndarray,
    n_shards: int,
    r: int = 32,
    m: int | None = 16,
    seed: int = 0,
    neighbor_codes: bool = False,
    fused_frontier: bool = False,
) -> ShardedIndex:
    """Partition `vectors` contiguously into `n_shards` sub-indices.

    m=None skips PQ (exact-distance shards). One PQ codebook is trained on the
    full dataset and shared (replicated) across shards.
    """
    n, _d = vectors.shape
    assert n % n_shards == 0, "pad the dataset to a multiple of n_shards"
    n_loc = n // n_shards

    codebook = None
    codes_full = None
    if m is not None:
        from bang_jax.formats.accel import encode_pq_jax, train_pq_jax

        pq = train_pq_jax(vectors, m, seed=seed)
        codes_full = encode_pq_jax(vectors, pq)
        codebook = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)

    adj = np.empty((n_shards, n_loc, r), np.int32)
    norms = np.empty((n_shards, n_loc), np.float32)
    medoids = np.empty(n_shards, np.int32)
    for s in range(n_shards):
        part = vectors[s * n_loc : (s + 1) * n_loc]
        a, _deg = synthetic.build_knn_graph(part, r, n_random=max(2, r // 8), seed=seed + s)
        adj[s] = a
        v64 = part.astype(np.float64)
        norms[s] = (v64 * v64).sum(-1).astype(np.float32)
        medoids[s] = synthetic.medoid_of(part)

    codes_sh = None if codes_full is None else codes_full.reshape(n_shards, n_loc, -1)
    nbr_codes = None
    if neighbor_codes and codes_sh is not None:
        # flat [n_loc, R*m] per shard — the single-device layout
        # (models/index.py build_device_index)
        nbr_codes = np.stack(
            [codes_sh[s][adj[s]].reshape(n_loc, -1) for s in range(n_shards)]
        )
    fused_rows = None
    if fused_frontier and codes_sh is not None:
        from bang_jax.ops.pq import pack_frontier_rows

        # per-shard fused rows carry LOCAL neighbor ids (adj is shard-local);
        # search_sharded offsets the merged top-k by id_base
        fused_rows = np.stack(
            [pack_frontier_rows(adj[s], codes_sh[s]) for s in range(n_shards)]
        )
    return ShardedIndex(
        adj=adj,
        vectors=vectors.reshape(n_shards, n_loc, -1),
        vector_norms=norms,
        codes=codes_sh,
        codebook=codebook,
        medoids=medoids,
        id_base=(np.arange(n_shards, dtype=np.int32) * n_loc),
        nbr_codes=nbr_codes,
        fused_rows=fused_rows,
    )
