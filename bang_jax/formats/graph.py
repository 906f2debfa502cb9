"""Packed Vamana graph index format (reader/writer) and in-memory container.

On-disk formats (byte-compatible with the reference's converter output):

`<prefix>_disk.bin` — N fixed-length records, one per node:
    [vector: dim * dtype_size bytes][degree: uint32][neighbors: R * uint32]
  neighbors are sorted ascending and zero-padded beyond `degree`.
  Record length == metadata.entry_len.
  Reference producer: BANG_Base/bang_preprocess.py:75-110; consumer layout:
  BANG_Base/bang_search.cu:330-346 (record arithmetic).

`<prefix>_disk_metadata.bin` — packed struct, little-endian:
    {uint64 medoid, uint64 entry_len, uint32 dtype_code, uint32 dim,
     uint32 degree, uint32 n}
  Reference: BANG_Base/bang_search.cuh:42-50 (GraphMedataData) and
  bang_preprocess.py:42-51,116.

In memory we keep a struct-of-arrays `GraphIndex`:
  vectors [N, D], adj [N, R] int32 padded with the node's own id (self-loops
  are naturally removed by visited-set filtering during search), degrees [N].
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from bang_jax.constants import DTYPE_CODE_TO_NUMPY, NUMPY_TO_DTYPE_CODE

GRAPH_INDEX_FILE_SUFFIX = "_disk.bin"
GRAPH_METADATA_FILE_SUFFIX = "_disk_metadata.bin"

_METADATA_STRUCT = struct.Struct("<QQIIII")


@dataclasses.dataclass
class GraphMetadata:
    medoid: int
    entry_len: int
    dtype_code: int
    dim: int
    degree: int
    n: int

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(DTYPE_CODE_TO_NUMPY[self.dtype_code])


def save_metadata(path: str | os.PathLike, meta: GraphMetadata) -> None:
    with open(path, "wb") as f:
        f.write(
            _METADATA_STRUCT.pack(
                meta.medoid, meta.entry_len, meta.dtype_code, meta.dim, meta.degree, meta.n
            )
        )


def load_metadata(path: str | os.PathLike) -> GraphMetadata:
    with open(path, "rb") as f:
        fields = _METADATA_STRUCT.unpack(f.read(_METADATA_STRUCT.size))
    return GraphMetadata(*fields)


@dataclasses.dataclass
class GraphIndex:
    """Struct-of-arrays graph index (host memory, numpy)."""

    vectors: np.ndarray  # [N, D] of dtype
    adj: np.ndarray  # [N, R] int32, padded with self-id
    degrees: np.ndarray  # [N] int32
    medoid: int

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def r(self) -> int:
        return self.adj.shape[1]

    def metadata(self) -> GraphMetadata:
        dtype_code = NUMPY_TO_DTYPE_CODE[self.vectors.dtype.name]
        entry_len = self.dim * self.vectors.dtype.itemsize + 4 + 4 * self.r
        return GraphMetadata(
            medoid=self.medoid,
            entry_len=entry_len,
            dtype_code=dtype_code,
            dim=self.dim,
            degree=self.r,
            n=self.n,
        )


def save_graph_index(
    prefix: str | os.PathLike, index: GraphIndex, block: int = 4_000_000,
    log=None,
) -> None:
    """Write `<prefix>_disk.bin` + `<prefix>_disk_metadata.bin`.

    Streams in `block`-row chunks: a monolithic writer peaks at ~8x the
    adjacency bytes in temporaries (argsort indices are int64), which at
    100M x R=32 would approach the host's whole RAM. `log` reports progress
    after each block (at 100M the write takes minutes)."""
    prefix = str(prefix)
    meta = index.metadata()
    n, dim, r = index.n, index.dim, index.r

    with open(prefix + GRAPH_INDEX_FILE_SUFFIX, "wb") as f:
        for s in range(0, n, block):
            if log:
                log(f"disk.bin block {s // block}/{-(-n // block)}")
            e = min(s + block, n)
            nb = e - s
            vec_bytes = (
                np.ascontiguousarray(index.vectors[s:e]).view(np.uint8).reshape(nb, -1)
            )
            # Neighbor block: sorted valid entries first, zero padding after.
            degrees = index.degrees[s:e].astype(np.int64)
            adj = index.adj[s:e]
            order = np.argsort(
                np.where(
                    np.arange(r)[None, :] < degrees[:, None], adj,
                    np.iinfo(np.int32).max,
                ),
                axis=1,
                kind="stable",
            )
            sorted_adj = np.take_along_axis(adj, order, axis=1).astype("<u4")
            pad_mask = np.arange(r)[None, :] >= degrees[:, None]
            sorted_adj[pad_mask] = 0

            records = np.empty((nb, meta.entry_len), dtype=np.uint8)
            records[:, : vec_bytes.shape[1]] = vec_bytes
            off = vec_bytes.shape[1]
            records[:, off : off + 4] = (
                degrees.astype("<u4")[:, None].view(np.uint8).reshape(nb, 4)
            )
            records[:, off + 4 :] = sorted_adj.view(np.uint8).reshape(nb, 4 * r)
            records.tofile(f)
    save_metadata(prefix + GRAPH_METADATA_FILE_SUFFIX, meta)


def load_graph_index(prefix: str | os.PathLike, mmap: bool = False) -> GraphIndex:
    """Load `<prefix>_disk.bin` + metadata into a GraphIndex.

    With mmap=True the packed record file is memory-mapped (host-RAM graph for
    the billion-scale Base variant); vectors are strided views into it, while
    adjacency/degrees are decoded copies (their int32 columns are unaligned in
    the packed record). For billion-scale use, BaseVariantSearcher reads the
    raw mmap directly and never calls this with mmap=True.
    """
    prefix = str(prefix)
    meta = load_metadata(prefix + GRAPH_METADATA_FILE_SUFFIX)
    path = prefix + GRAPH_INDEX_FILE_SUFFIX
    n, dim, r = meta.n, meta.dim, meta.degree
    dtype = meta.numpy_dtype
    vec_nbytes = dim * dtype.itemsize

    expected = n * meta.entry_len
    actual = os.path.getsize(path)
    if actual < expected:
        raise ValueError(f"{path}: too small ({actual} < {expected}) for metadata {meta}")

    if mmap:
        raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, meta.entry_len))
    else:
        raw = np.fromfile(path, dtype=np.uint8, count=expected).reshape(n, meta.entry_len)

    vectors = raw[:, :vec_nbytes].view(dtype)
    degrees = raw[:, vec_nbytes : vec_nbytes + 4].copy().view("<u4").reshape(n).astype(np.int32)
    adj = raw[:, vec_nbytes + 4 :].copy().view("<u4").reshape(n, r).astype(np.int32)

    # Replace padding beyond degree with the node's own id: self-loops are
    # filtered for free by the visited set during search (the parent is always
    # already visited when its adjacency row is expanded).
    pad_mask = np.arange(r)[None, :] >= degrees[:, None]
    self_ids = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r))
    adj[pad_mask] = self_ids[pad_mask]

    if not mmap:
        vectors = np.ascontiguousarray(vectors)

    # Load-time sanity, like the reference's first/last-neighbor asserts
    # (BANG_Base/bang_search.cu:330-346). Raise (not assert): must survive
    # python -O, and a corrupt index should fail loudly at load time.
    if n > 0:
        if not (0 <= adj[0, 0] < n) or not (0 <= adj[-1, -1] < n):
            raise ValueError(
                f"{path}: adjacency entries out of range "
                f"(first={adj[0, 0]}, last={adj[-1, -1]}, n={n}) — corrupt index?"
            )

    return GraphIndex(vectors=vectors, adj=adj, degrees=degrees, medoid=meta.medoid)
