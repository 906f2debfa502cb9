"""Graph diagnostics and warmup: BFS reachability from the medoid.

The reference uses a CPU BFS from the medoid to pick ~1M nodes whose PQ codes
a warmup kernel touches to heat GPU caches (ENABLE_CACHE_WARMUP,
BANG_Exactdistance/parANN.cu:1772-1853). From JAX there is no
program-visible cache to warm — the analogs are (a) ahead-of-time
compilation (done by bang_alloc) and (b) paging device-resident arrays once.
This module keeps the BFS itself: it doubles as an index sanity check
(reachable fraction from the medoid bounds attainable recall).
"""

from __future__ import annotations

import collections

import numpy as np


def bfs_rows(row_fn, n: int, start: int, max_nodes: int | None = None) -> np.ndarray:
    """Breadth-first order of nodes reachable from `start` (≤ max_nodes),
    reading adjacency rows through `row_fn(u) -> iterable of neighbor ids`.
    Level-synchronous with vectorized dedup so mmap-backed graphs stay fast."""
    seen = np.zeros(n, dtype=bool)
    seen[start] = True
    order = [np.asarray([start], dtype=np.int32)]
    frontier = order[0]
    total = 1
    limit = n if max_nodes is None else max_nodes
    while len(frontier) and total < limit:
        nxt = np.unique(np.concatenate([np.asarray(row_fn(int(u)), dtype=np.int64)
                                        for u in frontier]))
        nxt = nxt[(nxt >= 0) & (nxt < n)]
        nxt = nxt[~seen[nxt]]
        if len(nxt) == 0:
            break
        if total + len(nxt) > limit:
            nxt = nxt[: limit - total]
        seen[nxt] = True
        frontier = nxt.astype(np.int32)
        order.append(frontier)
        total += len(frontier)
    return np.concatenate(order)


def bfs_from(adj: np.ndarray, start: int, max_nodes: int | None = None) -> np.ndarray:
    """Breadth-first order of nodes reachable from `start` (≤ max_nodes)."""
    return bfs_rows(lambda u: adj[u], adj.shape[0], start, max_nodes)


def reachable_fraction(adj: np.ndarray, medoid: int, sample_cap: int = 2_000_000) -> float:
    """Fraction of (up to sample_cap) nodes reachable from the medoid."""
    order = bfs_from(adj, medoid, max_nodes=sample_cap)
    return len(order) / min(adj.shape[0], sample_cap)


def _mmap_row_fn(searcher):
    """Adjacency-row accessor over a BaseVariantSearcher's packed host graph
    (record layout: [FP vec | degree u32 | nbrs u32*R], graph.py)."""
    vec_nbytes = searcher.vec_bytes
    r = searcher.meta.degree

    def row_fn(u):
        rec = np.asarray(searcher.raw[u])
        deg = int(rec[vec_nbytes : vec_nbytes + 4].view("<u4")[0])
        return rec[vec_nbytes + 4 :].view("<u4")[: min(deg, r)]

    return row_fn


def warmup_touch(index, n_nodes: int = 1_000_000) -> int:
    """ENABLE_CACHE_WARMUP analog: BFS-discover nodes and touch their
    device-resident PQ codes / vectors once (pages HBM, warms the jit path).
    Accepts either a DeviceIndex (adj on device) or a BaseVariantSearcher
    (graph in host RAM — BFS walks the mmap; the reference's analog is the
    CPU BFS in BANG_Exactdistance/parANN.cu:1772-1853). Returns the number
    of nodes touched."""
    import jax
    import jax.numpy as jnp

    adj = getattr(index, "adj", None)
    planes = None
    if adj is None and getattr(index, "adj_planes", None) is not None:
        # neighbor_codes-mode indexes store adjacency as byte planes. Decode
        # HOST-SIDE: the BFS consumes a numpy array anyway, and a device
        # decode would materialize the [N, R] i32 table (plus shift/or
        # temporaries) that the byte-plane layout exists to avoid.
        planes = np.asarray(jax.device_get(index.adj_planes))
    elif (
        adj is None
        and getattr(index, "fused_rows", None) is not None
        and getattr(index, "codes", None) is not None
    ):
        # fused-frontier indexes keep no adjacency table at all; the id
        # byte-planes are the first 4R bytes of each fused row. Slice on
        # device (so only [N, 4R] crosses D2H, not the m*R code payload)
        # and decode host-side as above.
        r = index.fused_rows.shape[1] // (4 + index.codes.shape[1])
        planes_dev = jax.jit(lambda f: f[:, : 4 * r])(index.fused_rows)
        planes = np.asarray(jax.device_get(planes_dev))
        planes_dev.delete()
    if planes is not None:
        n, r4 = planes.shape
        r = r4 // 4
        p = planes.astype(np.int32)
        adj = (p[:, :r] | (p[:, r:2*r] << 8) | (p[:, 2*r:3*r] << 16)
               | (p[:, 3*r:] << 24))
        del planes, p
    if adj is not None:
        order = bfs_from(np.asarray(adj), index.medoid, max_nodes=n_nodes)
    elif getattr(index, "raw", None) is not None:
        order = bfs_rows(
            _mmap_row_fn(index), index.meta.n, index.meta.medoid, max_nodes=n_nodes
        )
    else:
        return 0
    ids = jnp.asarray(order)
    touched = 0
    for arr in (getattr(index, "codes", None), getattr(index, "vectors", None)):
        if arr is not None:
            jax.block_until_ready(arr[ids].sum())
            touched = len(order)
    return touched
