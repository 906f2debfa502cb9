"""Exact squared-L2 distance ops (matmul path).

Re-design of the reference's exact-distance kernels
(`compute_neighborDist_par` exact variant, BANG_Exactdistance/parANN.cu:
1139-1179, and the re-rank `compute_L2Dist`, BANG_Base/bang_search.cu:
1254-1299): instead of 8-thread warp reductions per neighbor, distances are
computed for all (query, candidate) pairs at once via the norm expansion
||v||^2 - 2 q.v + ||q||^2, whose cross term is a batched matmul.
Candidate squared norms are precomputed once per index load.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def squared_norms(vectors: jnp.ndarray, block: int | None = None) -> jnp.ndarray:
    """[N] f32 squared norms of the dataset (precomputed at load)."""
    v = vectors.astype(jnp.float32)
    return (v * v).sum(-1)


def decode_row_gather(raw: jnp.ndarray, dim: int) -> jnp.ndarray:
    """Undo a u8 bit-view packing of an f32 vector table after a row gather.

    Indices store vectors in their native dtype, so this is a passthrough in
    practice; it stays as a guard for u8-packed f32 tables.
    """
    if raw.dtype == jnp.uint8 and raw.shape[-1] == 4 * dim:
        return jax.lax.bitcast_convert_type(
            raw.reshape(*raw.shape[:-1], dim, 4), jnp.float32
        )
    return raw


def pack_exact_frontier_rows(adj, vectors, norms, n_blocks: int = 8):
    """Fused exact-frontier table [N, 8R + R*D] u8 (device-resident build).

    Per node, byte-contiguous:
      [ neighbor-id byte-planes 0..3 (R bytes each) |
        neighbor-||v||^2 f32 byte-planes 0..3 (R bytes each) |
        neighbor vectors, row-major R*D u8 ]

    The exactdistance traversal otherwise pays THREE scattered gathers per
    iteration (adjacency ids, neighbor-aligned vectors, neighbor norms); this
    row makes the whole frontier ONE gather. u8 datasets only (vectors
    are stored as raw bytes; f32 datasets would triple the row and lose the
    aligned-row advantage).

    Built on device in `n_blocks` donated chunks: materializing vectors[adj]
    for all N at once would need row-bytes + output ~= 2x the table next to
    the index arrays.
    """
    import functools

    n, r = adj.shape
    d = vectors.shape[1]
    assert vectors.dtype == jnp.uint8, "fused exact rows require u8 vectors"
    row_bytes = 8 * r + r * d

    @functools.partial(jax.jit, donate_argnums=(0,))
    def fill_block(out, adj_b, vectors, norms, start):
        idp = jnp.concatenate(
            [((adj_b >> (8 * k)) & 0xFF).astype(jnp.uint8) for k in range(4)], axis=1
        )
        ni = jax.lax.bitcast_convert_type(norms[adj_b], jnp.int32)
        nrp = jnp.concatenate(
            [((ni >> (8 * k)) & 0xFF).astype(jnp.uint8) for k in range(4)], axis=1
        )
        vb = vectors[adj_b].reshape(adj_b.shape[0], r * d)
        block = jnp.concatenate([idp, nrp, vb], axis=1)
        return jax.lax.dynamic_update_slice(out, block, (start, 0))

    out = jnp.zeros((n, row_bytes), jnp.uint8)
    bs = min(n, -(-n // n_blocks))
    # equal-size blocks + dynamic start -> ONE compiled program for every
    # block. The final block is clamped to start at n-bs (read and write use
    # the SAME start, so the overlap with the previous block just rewrites
    # identical rows).
    for s0 in range(0, n, bs):
        s = min(s0, n - bs)
        out = fill_block(
            out, jax.lax.dynamic_slice_in_dim(adj, s, bs), vectors,
            norms, jnp.int32(s),
        )
    return out


def decode_exact_frontier_rows(rows, r: int, d: int):
    """(ids [Q, P*R] i32, norms [Q, P*R] f32, vecs [Q, P*R, D] u8) from
    gathered fused rows [Q, P, 8R + R*D] u8 — cheap byte math that XLA
    fuses into the gather consumer."""
    q, p, _ = rows.shape
    idb = rows[:, :, : 4 * r].astype(jnp.int32).reshape(q, p, 4, r)
    ids = (
        idb[:, :, 0] | (idb[:, :, 1] << 8) | (idb[:, :, 2] << 16)
        | (idb[:, :, 3] << 24)
    ).reshape(q, p * r)
    nb = rows[:, :, 4 * r : 8 * r].astype(jnp.int32).reshape(q, p, 4, r)
    norms = jax.lax.bitcast_convert_type(
        (nb[:, :, 0] | (nb[:, :, 1] << 8) | (nb[:, :, 2] << 16)
         | (nb[:, :, 3] << 24)),
        jnp.float32,
    ).reshape(q, p * r)
    vecs = rows[:, :, 8 * r :].reshape(q, p * r, d)
    return ids, norms, vecs


def l2_distance_to_candidates(
    queries: jnp.ndarray,
    cand_vectors: jnp.ndarray,
    cand_norms: jnp.ndarray | None = None,
    precision=None,
) -> jnp.ndarray:
    """Squared L2 of each query to its own candidate rows.

    queries: [Q, D] f32; cand_vectors: [Q, C, D] (any dtype, cast to f32);
    cand_norms: [Q, C] f32 precomputed ||v||^2, or None to compute here.
    precision: lax.Precision for the cross term — HIGHEST by default (exact
    distances must rank correctly); traversal-only callers may relax it.
    Returns [Q, C] f32.
    """
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    q = queries.astype(jnp.float32)
    v = cand_vectors.astype(jnp.float32)
    if cand_norms is None:
        cand_norms = (v * v).sum(-1)
    cross = jnp.einsum(
        "qd,qcd->qc",
        q,
        v,
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    q_norms = (q * q).sum(-1, keepdims=True)
    return jnp.maximum(cand_norms - 2.0 * cross + q_norms, 0.0)
