"""Byte-plane adjacency: the [N, R] int32 neighbor table stored as
[N, 4R] uint8 (plane-major: all R low bytes, then the next plane, ...).

Each parent's row is one contiguous 4R-byte read. The plane layout matches
the id section of the fused frontier rows (ops/pq.pack_frontier_rows), so the
decode is the same shift-or (reference behavior: the adjacency fetch of
BANG's traversal loop, BANG_Base/bang_search.cu:701-760, which reads packed
u32 neighbor ids from the host-RAM graph).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_adj_planes_np(adj: np.ndarray) -> np.ndarray:
    """[N, R] int32 -> [N, 4R] u8 plane-major (host-side numpy)."""
    n, r = adj.shape
    return (
        np.ascontiguousarray(adj, dtype=np.int32)
        .view(np.uint8).reshape(n, r, 4).transpose(0, 2, 1).reshape(n, 4 * r)
    )


def pack_adj_planes(adj_blk: jnp.ndarray) -> jnp.ndarray:
    """[B, R] int32 -> [B, 4R] u8 plane-major (on device, for chunked
    builds where the full i32 table never becomes HBM-resident)."""
    b, r = adj_blk.shape
    by = jax.lax.bitcast_convert_type(adj_blk, jnp.uint8)  # [B, R, 4] LE
    return jnp.swapaxes(by, 1, 2).reshape(b, 4 * r)


def decode_adj_planes(rows: jnp.ndarray) -> jnp.ndarray:
    """[..., 4R] u8 plane-major rows -> [..., R] int32 neighbor ids."""
    r = rows.shape[-1] // 4
    idb = rows.astype(jnp.int32)
    p0 = idb[..., 0 * r : 1 * r]
    p1 = idb[..., 1 * r : 2 * r]
    p2 = idb[..., 2 * r : 3 * r]
    p3 = idb[..., 3 * r : 4 * r]
    return p0 | (p1 << 8) | (p2 << 16) | (p3 << 24)


class PlaneAdjacency:
    """Callable adjacency for run_traversal: gathers 4R-byte u8 plane rows
    and decodes the ids. Duck-types the `[parents] -> ids` contract of
    a plain [N, R] i32 table (make_step checks callable())."""

    def __init__(self, planes: jnp.ndarray):
        self.planes = planes  # [N, 4R] u8
        self.r = planes.shape[1] // 4

    def __call__(self, parents: jnp.ndarray) -> jnp.ndarray:
        q = parents.shape[0]
        rows = self.planes[parents]  # [Q, P, 4R] u8 — ONE row gather
        return decode_adj_planes(rows).reshape(q, -1)  # [Q, P*R] i32


class FrontierOnlyAdj:
    """Adjacency stand-in for fused-frontier indexes: the fused rows carry
    the neighbor ids, so no adjacency table is HBM-resident at all. make_step
    only reads `.r` when a frontier_fn is attached; the fetch contract is
    never traced."""

    def __init__(self, r: int):
        self.r = r

    def __call__(self, parents):  # pragma: no cover - unreachable by design
        raise RuntimeError(
            "fused-frontier index has no adjacency table; the traversal must "
            "use distance_fn.frontier_fn"
        )
