"""Product-Quantization ops: distance-table construction and code lookup.

Re-design of the reference kernels:
  - `populate_pqDist_par` (BANG_Base/bang_search.cu:1083-1130): one 256-thread
    block per query computing, for each chunk c and center j,
    sum_{d in chunk c} (pivot[j,d] - (q[d] - centroid[d]))^2.
    Here this becomes one batched einsum over all queries at once,
    using the norm expansion ||p||^2 - 2 p.q' + ||q'||^2 on zero-padded
    per-chunk layouts (padding contributes (0-0)^2 = 0).
  - `compute_neighborDist_par` PQ path (bang_search.cu:1201-1241): 8 threads
    per neighbor accumulating table[c, code[c]] with a warp reduction. Here:
    a flat per-query gather (take-along-axis over the fused (chunk, center)
    axis) summed over chunks; the GPU kernel lives in ops/pq_pallas.py.

Fused frontier rows (`pack_frontier_rows`) put each node's neighbor ids and
their PQ codes in ONE u8 row, so the traversal fetches both with one gather
per parent; `frontier_decode_xla` unpacks the gathered rows.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PQCodebook(NamedTuple):
    """Device-ready padded-chunk codebook.

    piv_chunks: [m, 256, dmax] f32 — per-chunk pivot coords, zero-padded.
    piv_norms:  [m, 256] f32 — per-chunk squared pivot norms.
    dim_idx:    [m, dmax] i32 — source dim of each padded slot (clipped).
    dim_mask:   [m, dmax] f32 — 1 for real dims, 0 for padding.
    centroid:   [D] f32.
    """

    piv_chunks: jnp.ndarray
    piv_norms: jnp.ndarray
    dim_idx: jnp.ndarray
    dim_mask: jnp.ndarray
    centroid: jnp.ndarray

    @property
    def num_chunks(self) -> int:
        return self.piv_chunks.shape[0]


def prepare_pq_codebook(
    pivots: np.ndarray, centroid: np.ndarray, chunk_offsets: np.ndarray
) -> PQCodebook:
    """Convert the DiskANN codebook layout ([256, D] + offsets) to padded chunks."""
    offsets = np.asarray(chunk_offsets, dtype=np.int64)
    m = len(offsets) - 1
    sizes = offsets[1:] - offsets[:-1]
    dmax = int(sizes.max())
    dim_idx = np.minimum(
        offsets[:-1, None] + np.arange(dmax)[None, :], pivots.shape[1] - 1
    ).astype(np.int32)
    dim_mask = (np.arange(dmax)[None, :] < sizes[:, None]).astype(np.float32)
    piv_chunks = (
        pivots.T[dim_idx].transpose(0, 2, 1) * dim_mask[:, None, :]
    ).astype(np.float32)
    # pivots.T is [D, 256]; pivots.T[dim_idx] is [m, dmax, 256]
    piv_norms = (piv_chunks * piv_chunks).sum(-1).astype(np.float32)
    assert piv_chunks.shape == (m, 256, dmax)
    return PQCodebook(
        piv_chunks=jnp.asarray(piv_chunks),
        piv_norms=jnp.asarray(piv_norms),
        dim_idx=jnp.asarray(dim_idx),
        dim_mask=jnp.asarray(dim_mask),
        centroid=jnp.asarray(centroid, dtype=jnp.float32),
    )


def pq_distance_tables(codebook: PQCodebook, queries: jnp.ndarray) -> jnp.ndarray:
    """Per-query PQ distance tables: [Q, m, 256] f32.

    queries: [Q, D] float32 (already MIPS-transformed if applicable).
    """
    qc = (queries.astype(jnp.float32) - codebook.centroid)[:, codebook.dim_idx]
    qc = qc * codebook.dim_mask  # [Q, m, dmax], zero-padded
    # cross[q, c, j] = sum_t qc[q,c,t] * piv[c,j,t]
    # Tables are built once per batch; full f32 precision costs nothing and
    # keeps PQ distances bit-comparable across backends.
    cross = jnp.einsum(
        "qct,cjt->qcj",
        qc,
        codebook.piv_chunks,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    q_norms = (qc * qc).sum(-1)  # [Q, m]
    return codebook.piv_norms[None] - 2.0 * cross + q_norms[:, :, None]


def pq_lookup(tables: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Accumulate PQ distances: out[q, r] = sum_c tables[q, c, codes[q, r, c]].

    tables: [Q, m, 256] f32; codes: [Q, R, m] uint8/int32 (gathered per
    candidate). Returns [Q, R] f32.
    """
    q, m, nc = tables.shape
    flat = tables.reshape(q, m * nc)
    idx = codes.astype(jnp.int32) + (jnp.arange(m, dtype=jnp.int32) * nc)[None, None, :]
    vals = jnp.take_along_axis(flat[:, None, :], idx, axis=2)
    return vals.sum(-1)


def pack_frontier_rows(adj: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Fused frontier table [N, 4R + m*R] u8 (host-side numpy).

    Per node:
      [ id byte-plane 0 (R bytes) | plane 1 | plane 2 | plane 3 |
        chunk-major codes: chunk 0's R codes | ... | chunk m-1's R codes ]

    adj: [N, R] int32 (self-padded); codes: [N, m] u8. The row fuses what the
    traversal would otherwise fetch with two gathers (adjacency row +
    neighbor-aligned codes).
    """
    n, r = adj.shape
    m = codes.shape[1]
    id_planes = (
        np.ascontiguousarray(adj, dtype=np.int32)
        .view(np.uint8).reshape(n, r, 4).transpose(0, 2, 1).reshape(n, 4 * r)
    )
    nbr_codes = codes[adj]  # [N, R, m]
    codes_cm = np.ascontiguousarray(nbr_codes.transpose(0, 2, 1)).reshape(n, m * r)
    return np.concatenate([id_planes, codes_cm], axis=1)


def frontier_decode_xla(rows: jnp.ndarray, m: int, r: int):
    """Decode gathered fused frontier rows [Q, P, 4r + m*r] u8 (P parents per
    query) into candidate ids [Q, P*r] int32 and their codes [Q, P*r, m] u8 —
    the inputs of a PQ lookup."""
    q, p = rows.shape[:2]
    idb = rows[:, :, : 4 * r].astype(jnp.int32).reshape(q, p, 4, r)
    ids = (
        idb[:, :, 0] | (idb[:, :, 1] << 8) | (idb[:, :, 2] << 16)
        | (idb[:, :, 3] << 24)
    ).reshape(q, p * r)
    cd = rows[:, :, 4 * r :].reshape(q, p, m, r)
    return ids, jnp.swapaxes(cd, 2, 3).reshape(q, p * r, m)
