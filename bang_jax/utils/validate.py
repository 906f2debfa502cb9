"""Index validation — the reference's load-time sanity asserts, systematized.

Reference checks: first/last adjacency entries in range
(BANG_Base/bang_search.cu:330-346), R == MAX_R (:190), file-size checks in
every loader (bang_search.cuh:299-311), PQ section count (:246-251). Here:
one callable that validates a whole on-disk index bundle and returns a
report, used by the facade on load and available standalone.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from bang_jax.constants import PQ_NUM_CENTERS
from bang_jax.formats.graph import (
    GRAPH_INDEX_FILE_SUFFIX,
    GRAPH_METADATA_FILE_SUFFIX,
    load_metadata,
)
from bang_jax.formats.pq import PQ_COMPRESSED_FILE_SUFFIX, PQ_PIVOTS_FILE_SUFFIX, load_pq


@dataclasses.dataclass
class ValidationReport:
    ok: bool
    errors: list
    warnings: list
    n: int = 0
    dim: int = 0
    degree: int = 0
    chunks: int = 0
    reachable_fraction: float = -1.0  # of min(n, reach_cap) nodes, from medoid


def validate_index(
    prefix: str,
    with_pq: bool = True,
    sample: int = 10000,
    reach_cap: int = 50_000,
) -> ValidationReport:
    """Validate an index bundle at `prefix`. Checks metadata consistency,
    adjacency id ranges, degree bounds, medoid range, PQ shape agreement,
    and BFS reachability from the medoid (capped at reach_cap nodes so a
    disconnected index surfaces here instead of as mystery recall after a
    long benchmark; reach_cap=0 skips it)."""
    errors, warnings = [], []

    meta_path = prefix + GRAPH_METADATA_FILE_SUFFIX
    graph_path = prefix + GRAPH_INDEX_FILE_SUFFIX
    if not os.path.exists(meta_path):
        return ValidationReport(False, [f"missing {meta_path}"], [])
    meta = load_metadata(meta_path)

    expected_entry = meta.dim * meta.numpy_dtype.itemsize + 4 + 4 * meta.degree
    if meta.entry_len != expected_entry:
        errors.append(
            f"entry_len {meta.entry_len} != dim*dsize+4+4*R = {expected_entry}"
        )
    actual_size = os.path.getsize(graph_path) if os.path.exists(graph_path) else -1
    if actual_size != meta.n * meta.entry_len:
        errors.append(
            f"graph file size {actual_size} != n*entry_len = {meta.n * meta.entry_len}"
        )
    if not (0 <= meta.medoid < meta.n):
        errors.append(f"medoid {meta.medoid} out of range [0, {meta.n})")

    if not errors:
        # sample rows straight off the memory-mapped record file — decoding
        # the whole adjacency would materialize n*R*4 bytes (256 GB at 1B)
        raw = np.memmap(graph_path, dtype=np.uint8, mode="r", shape=(meta.n, meta.entry_len))
        vec_nbytes = meta.dim * meta.numpy_dtype.itemsize
        rng = np.random.default_rng(0)
        rows = np.sort(rng.integers(0, meta.n, min(sample, meta.n)))
        recs = np.asarray(raw[rows])  # copies only the sampled records
        degrees = recs[:, vec_nbytes : vec_nbytes + 4].copy().view("<u4").reshape(-1)
        nbrs = (
            recs[:, vec_nbytes + 4 :].copy().view("<u4").reshape(len(rows), meta.degree)
        )
        col = np.arange(meta.degree)[None, :]
        valid = col < np.minimum(degrees, meta.degree)[:, None]
        adj_sample = np.where(valid, nbrs, rows[:, None].astype(np.uint32))
        if adj_sample.max() >= meta.n:
            errors.append("adjacency ids out of range in sampled rows")
        if (degrees > meta.degree).any():
            errors.append("degree exceeds R in sampled rows")
        if (degrees == 0).any():
            warnings.append("zero-degree nodes present (unreachable)")
        srt = np.sort(adj_sample.astype(np.int64), axis=1)
        dup_rows = (
            ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != rows[:, None])).any(1).sum()
        )
        if dup_rows:
            errors.append(f"{dup_rows} sampled rows contain duplicate neighbor ids")

    reach = -1.0
    if not errors and reach_cap:
        from bang_jax.utils.graph_tools import bfs_rows

        raw = np.memmap(graph_path, dtype=np.uint8, mode="r", shape=(meta.n, meta.entry_len))
        vec_nbytes = meta.dim * meta.numpy_dtype.itemsize

        def row_fn(u):
            rec = np.asarray(raw[u])
            deg = int(rec[vec_nbytes : vec_nbytes + 4].view("<u4")[0])
            return rec[vec_nbytes + 4 :].view("<u4")[: min(deg, meta.degree)]

        order = bfs_rows(row_fn, meta.n, meta.medoid, max_nodes=reach_cap)
        reach = len(order) / min(meta.n, reach_cap)
        if reach < 0.5:
            warnings.append(
                f"only {reach:.1%} of the first {min(meta.n, reach_cap)} nodes "
                "reachable from medoid — recall will suffer"
            )

    chunks = 0
    if with_pq:
        piv_path = prefix + PQ_PIVOTS_FILE_SUFFIX
        code_path = prefix + PQ_COMPRESSED_FILE_SUFFIX
        if not os.path.exists(piv_path) or not os.path.exists(code_path):
            warnings.append("PQ files missing (exactdistance-only index)")
        else:
            pq = load_pq(prefix)
            chunks = pq.num_chunks
            if pq.pivots.shape != (PQ_NUM_CENTERS, meta.dim):
                errors.append(
                    f"pivots shape {pq.pivots.shape} != (256, {meta.dim})"
                )
            if int(pq.chunk_offsets[-1]) != meta.dim:
                errors.append(
                    f"chunk offsets end {pq.chunk_offsets[-1]} != dim {meta.dim}"
                )
            if (np.diff(pq.chunk_offsets.astype(np.int64)) <= 0).any():
                errors.append("chunk offsets not strictly increasing")
            if pq.codes is not None and pq.codes.shape[0] != meta.n:
                errors.append(
                    f"codes rows {pq.codes.shape[0]} != n {meta.n}"
                )

    return ValidationReport(
        ok=not errors,
        errors=errors,
        warnings=warnings,
        n=meta.n,
        dim=meta.dim,
        degree=meta.degree,
        chunks=chunks,
        reachable_fraction=reach,
    )
