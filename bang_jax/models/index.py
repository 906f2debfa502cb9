"""Device-resident index container (the analog of GPUInstance + IndexLoad,
BANG_Base/bang_search.cuh:53-135).

All arrays live in device memory as one pytree; what is populated depends on the
variant:
  - exactdistance: vectors + vector_norms + adj (no PQ)
  - inmemory:      vectors (for re-rank) + adj + PQ codebook + codes
  - base:          PQ codebook + codes only (graph + vectors stay in host RAM)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from bang_jax.formats.graph import load_graph_index
from bang_jax.formats.pq import load_pq
from bang_jax.ops.pq import PQCodebook, prepare_pq_codebook


class DeviceIndex(NamedTuple):
    """Device-resident search index (struct of arrays; static metadata on host)."""

    adj: Optional[jnp.ndarray]  # [N, R] int32, self-padded
    vectors: Optional[jnp.ndarray]  # [N, D] original dtype
    vector_norms: Optional[jnp.ndarray]  # [N] f32 squared norms
    codes: Optional[jnp.ndarray]  # [N, m] uint8 PQ codes
    nbr_codes: Optional[jnp.ndarray]  # [N, R*m] u8 — neighbors' codes, row-
    # aligned per parent, stored flat (gather-efficient CAGRA-style layout;
    # R x the code memory)
    adj_planes: Optional[jnp.ndarray]  # [N, 4R] u8 — byte-plane adjacency
    # (ops/adjacency), built with nbr_codes; replaces `adj` (None) in
    # neighbor_codes mode
    fused_rows: Optional[jnp.ndarray]  # [N, R*(4+m)] u8 — fused frontier rows
    # (id byte-planes + chunk-major neighbor codes): ONE gather per parent
    # yields both candidate ids and their codes (ops/pq.pack_frontier_rows)
    nbr_vecs: Optional[jnp.ndarray]  # [N, R, D] — neighbors' vectors (same
    # layout trick for the exactdistance variant; R x the vector memory)
    nbr_vec_norms: Optional[jnp.ndarray]  # [N, R] f32
    codebook: Optional[PQCodebook]
    medoid: int  # static
    n: int  # static
    dim: int  # static
    fused_vec_rows: Optional[jnp.ndarray] = None  # [N, 8R + R*D] u8 — fused
    # exact-frontier rows (id + norm byte-planes + u8 neighbor vectors): ONE
    # gather per parent replaces the adj + nbr_vecs + norms triple
    # (ops/l2.pack_exact_frontier_rows); u8 datasets only


def build_device_index(
    graph=None,
    pq=None,
    with_vectors: bool = True,
    with_adj: bool = True,
    medoid: int | None = None,
    neighbor_codes: bool = False,
    neighbor_vectors: bool = False,
    fused_frontier: bool = False,
    fused_exact_frontier: bool = False,
) -> DeviceIndex:
    """Assemble a DeviceIndex from host-side containers (GraphIndex, PQData).

    neighbor_codes=True materializes nbr_codes[N, R, m] (each node's
    neighbors' PQ codes, contiguous). Per-iteration candidate-code fetches
    then gather R*m-byte aligned rows instead of R scattered m-byte rows.
    Costs R x the code memory (4 GB at N=1M, m=64).
    """
    adj = vectors = norms = codes = codebook = None
    nbr_codes = nbr_vecs = nbr_vec_norms = fused_rows = None
    n = dim = 0
    if graph is not None:
        n, dim = graph.n, graph.dim
        medoid = graph.medoid if medoid is None else medoid
        if with_adj and not neighbor_codes and not fused_frontier:
            # neighbor_codes / fused_frontier modes never keep the i32 table
            # on the device (byte-plane or fused rows replace it) AND build
            # from the host copy, so skip the upload entirely
            adj = jnp.asarray(graph.adj, dtype=jnp.int32)
        elif with_adj and fused_frontier and (
            neighbor_vectors or fused_exact_frontier
        ):  # pragma: no cover - exact-variant layouts still need the table
            adj = jnp.asarray(graph.adj, dtype=jnp.int32)
        if with_vectors:
            # vectors stay in their NATIVE dtype
            vectors = jnp.asarray(graph.vectors)
            v64 = graph.vectors.astype(np.float64)
            norms = jnp.asarray((v64 * v64).sum(-1).astype(np.float32))
    if pq is not None:
        codebook = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)
        if pq.codes is not None:
            codes = jnp.asarray(pq.codes)
            if n == 0:
                n = pq.codes.shape[0]
        if dim == 0:
            dim = pq.dim
    import jax

    adj_planes = None
    if neighbor_codes:
        assert codes is not None and (adj is not None or graph is not None)
        # Built in row BLOCKS, so per-block transients stay ~256 MB and the
        # output is written in place (donated). neighbor_codes mode replaces
        # the [N, R] i32 adjacency with byte-plane rows (ops/adjacency),
        # decoded after each parent-row gather.
        from bang_jax.ops.adjacency import pack_adj_planes

        adj_host = graph.adj if graph is not None else np.asarray(adj)
        n_rows, r = adj_host.shape
        m = codes.shape[1]
        blk = min(n_rows, max(4096, (256 * 1024**2) // max(1, r * 128)))

        @jax.jit
        def _build_block(c, a_blk):
            g = c[a_blk].reshape(a_blk.shape[0], -1)  # [B, R*m] u8
            return g, pack_adj_planes(a_blk)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def _write_block(oc, op, g, pl, s):
            oc = jax.lax.dynamic_update_slice(oc, g, (s, 0))
            op = jax.lax.dynamic_update_slice(op, pl, (s, 0))
            return oc, op

        nbr_codes = jnp.zeros((n_rows, r * m), jnp.uint8)
        adj_planes = jnp.zeros((n_rows, 4 * r), jnp.uint8)
        starts = list(range(0, n_rows - blk + 1, blk))
        if n_rows % blk:
            # one compiled shape: the final block ENDS at n_rows and overlaps
            # the previous one — overlapped rows are rewritten with identical
            # values (both blocks gather the same source rows)
            starts.append(n_rows - blk)
        for s in starts:
            a_blk = jnp.asarray(np.asarray(adj_host[s : s + blk], np.int32))
            g, pl = _build_block(codes, a_blk)
            nbr_codes, adj_planes = _write_block(
                nbr_codes, adj_planes, g, pl, jnp.int32(s)
            )
        adj = None  # the padded i32 table is never HBM-resident in this mode
    if fused_frontier:
        assert graph is not None and pq is not None and pq.codes is not None
        adj_host = graph.adj
        n_rows, r = adj_host.shape
        # Built ON DEVICE in row blocks (same scheme as the nbr_codes build
        # above): only the [B, R] i32 adjacency blocks cross H2D and the row
        # assembly (byte-plane ids + chunk-major gathered codes, the
        # ops/pq.pack_frontier_rows layout) runs on the device into a donated
        # buffer.
        from bang_jax.ops.adjacency import pack_adj_planes

        m = codes.shape[1]
        row_w = 4 * r + m * r
        blk = min(n_rows, max(4096, (256 * 1024**2) // max(1, r * 128)))

        @jax.jit
        def _build_fused(c, a_blk):
            planes = pack_adj_planes(a_blk)  # [B, 4R] u8, plane-major LE
            g = c[a_blk]  # [B, R, m] u8
            cm = jnp.swapaxes(g, 1, 2).reshape(a_blk.shape[0], m * r)
            return jnp.concatenate([planes, cm], axis=1)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def _write_fused(buf, rows_blk, s):
            return jax.lax.dynamic_update_slice(buf, rows_blk, (s, 0))

        fused_rows = jnp.zeros((n_rows, row_w), jnp.uint8)
        starts = list(range(0, n_rows - blk + 1, blk))
        if n_rows % blk:
            starts.append(n_rows - blk)  # final block overlaps, same values
        for s in starts:
            a_blk = jnp.asarray(np.asarray(adj_host[s : s + blk], np.int32))
            fused_rows = _write_fused(
                fused_rows, _build_fused(codes, a_blk), jnp.int32(s)
            )
    if neighbor_vectors:
        assert adj is not None and vectors is not None
        nbr_vecs = jax.jit(lambda v, a: v[a])(vectors, adj)
        nbr_vec_norms = jax.jit(lambda nn, a: nn[a])(norms, adj)
    fused_vec_rows = None
    if fused_exact_frontier:
        assert adj is not None and vectors is not None
        from bang_jax.ops.l2 import pack_exact_frontier_rows

        fused_vec_rows = pack_exact_frontier_rows(adj, vectors, norms)
    assert medoid is not None, "medoid required"
    return DeviceIndex(
        fused_vec_rows=fused_vec_rows,
        adj=adj,
        vectors=vectors,
        vector_norms=norms,
        codes=codes,
        nbr_codes=nbr_codes,
        adj_planes=adj_planes,
        fused_rows=fused_rows,
        nbr_vecs=nbr_vecs,
        nbr_vec_norms=nbr_vec_norms,
        codebook=codebook,
        medoid=int(medoid),
        n=int(n),
        dim=int(dim),
    )


def free_device_index(index) -> None:
    """Deterministically release an index's device buffers.

    `del index` alone only drops the Python reference — XLA keeps the device
    allocations alive until garbage collection runs AND no jit cache entry
    pins them. Benchmarks that load several multi-GB indices back to back
    must free explicitly or later allocations see a shrunken memory pool.
    """
    import jax

    for leaf in jax.tree.leaves(index):
        if hasattr(leaf, "delete"):
            try:
                leaf.delete()
            except Exception:
                pass  # already deleted / donated


# Shares of the device memory limit that the R x expansion layouts may take.
# The fused frontier rows REPLACE both nbr_codes and the adjacency (no i32
# table is resident in fused mode), so their share is the larger; what is
# left holds the vectors, codes, per-batch tables and search state.
NEIGHBOR_LAYOUT_SHARE = 0.675
FUSED_LAYOUT_SHARE = 0.75


def layout_budgets(bytes_limit: int | None) -> tuple[float, float]:
    """(neighbor-aligned, fused) layout budgets in bytes for a device whose
    allocator limit is `bytes_limit`. A device that reports no limit (the
    CPU backend) gets no budget: both are infinite and the layouts are
    chosen by shape alone."""
    if bytes_limit is None:
        return float("inf"), float("inf")
    return NEIGHBOR_LAYOUT_SHARE * bytes_limit, FUSED_LAYOUT_SHARE * bytes_limit


def device_bytes_limit(device=None) -> int | None:
    """The allocator's limit on `device` (default: the first device), or
    None where the backend reports none."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("bytes_limit")


def device_index_from_files(
    prefix: str,
    variant: str = "inmemory",
    neighbor_codes: bool | None = None,
    neighbor_vectors: bool | None = None,
) -> DeviceIndex:
    """Load an index bundle from `<prefix>_*` files for the given variant.

    neighbor_codes (inmemory) / neighbor_vectors (exactdistance) control the
    gather-efficient neighbor-aligned layouts; None auto-enables each when its
    R x expansion fits the device's budget (layout_budgets).
    """
    nbr_budget, fused_budget = layout_budgets(device_bytes_limit())
    if variant == "exactdistance":
        graph = load_graph_index(prefix)
        if neighbor_vectors is None:
            nv = graph.n * graph.r * graph.dim * graph.vectors.dtype.itemsize
            neighbor_vectors = nv <= nbr_budget
        # the fused exact-frontier row (build_device_index
        # fused_exact_frontier=True) stays opt-in; auto-selection is nbr_vecs
        return build_device_index(
            graph=graph, pq=None, neighbor_vectors=bool(neighbor_vectors)
        )
    if variant == "inmemory":
        graph = load_graph_index(prefix)
        pq = load_pq(prefix)
        fused = False
        if neighbor_codes is None:
            # prefer the fused frontier rows (one gather/parent for ids +
            # codes) when the R x expansion fits; otherwise fall back to the
            # flat nbr_codes layout
            fused = graph.n * graph.r * (4 + pq.num_chunks) <= fused_budget
            nc = graph.n * graph.r * pq.num_chunks
            neighbor_codes = (not fused) and nc <= nbr_budget
        return build_device_index(
            graph=graph, pq=pq, neighbor_codes=bool(neighbor_codes),
            fused_frontier=fused,
        )
    raise ValueError(f"unknown variant for device index: {variant!r}")
