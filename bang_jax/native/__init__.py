"""ctypes bindings for the native host-gather library, with numpy fallback.

The shared library is built on demand (`make` in this directory); if the
toolchain or binary is unavailable, `gather_parents` falls back to a
vectorized numpy implementation with identical semantics.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libbang_host.so")
_lib = None
_build_failed = False


def _stale() -> bool:
    """True when the .so predates the C++ source (ABI/semantics may differ)."""
    try:
        return os.path.getmtime(_LIB_PATH) < os.path.getmtime(
            os.path.join(_DIR, "host_gather.cpp")
        )
    except OSError:
        return True


def _load_lib(build: bool = True):
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB_PATH) or _stale()) and build and not _build_failed:
        try:
            subprocess.run(
                ["make", "-s"], cwd=_DIR, check=True, capture_output=True, timeout=120
            )
        except Exception:
            _build_failed = True
            return None
    if not os.path.exists(_LIB_PATH) or _stale():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.bang_gather_parents.restype = None
    lib.bang_gather_parents.argtypes = [
        ctypes.c_void_p,  # index_buf
        ctypes.c_uint64,  # entry_len
        ctypes.c_uint32,  # vec_bytes
        ctypes.c_uint32,  # d
        ctypes.c_uint32,  # r
        ctypes.c_int,  # dtype_code
        ctypes.c_void_p,  # parents
        ctypes.c_int64,  # q
        ctypes.c_void_p,  # out_nbrs
        ctypes.c_void_p,  # out_vecs
        ctypes.c_int,  # n_threads
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def gather_parents_native(
    raw: np.ndarray,
    entry_len: int,
    vec_bytes: int,
    d: int,
    r: int,
    dtype_code: int,
    parents: np.ndarray,
    out_nbrs: np.ndarray,
    out_vecs: np.ndarray | None,
    n_threads: int,
) -> bool:
    """Run the native gather; returns False if the library is unavailable."""
    lib = _load_lib()
    if lib is None:
        return False
    parents = np.ascontiguousarray(parents, dtype=np.int32)
    assert out_nbrs.flags.c_contiguous and out_nbrs.dtype == np.int32
    lib.bang_gather_parents(
        raw.ctypes.data if isinstance(raw, np.ndarray) else raw,
        entry_len,
        vec_bytes,
        d,
        r,
        dtype_code,
        parents.ctypes.data,
        len(parents),
        out_nbrs.ctypes.data,
        out_vecs.ctypes.data if out_vecs is not None else None,
        n_threads,
    )
    return True


def gather_parents_numpy(
    raw: np.ndarray,
    entry_len: int,
    vec_bytes: int,
    d: int,
    r: int,
    dtype_code: int,
    parents: np.ndarray,
    out_nbrs: np.ndarray,
    out_vecs: np.ndarray | None,
) -> None:
    """Vectorized numpy fallback over the packed record buffer."""
    from bang_jax.constants import DTYPE_CODE_TO_NUMPY

    recs = raw.reshape(-1, entry_len)[parents]  # [Q, entry_len] u8 copy
    degrees = recs[:, vec_bytes : vec_bytes + 4].copy().view("<u4").reshape(-1)
    nbrs = (
        recs[:, vec_bytes + 4 : vec_bytes + 4 + 4 * r]
        .copy()
        .view("<i4")
        .reshape(-1, r)
    )
    pad = np.arange(r)[None, :] >= np.minimum(degrees, r)[:, None]
    out_nbrs[...] = np.where(pad, parents[:, None].astype(np.int32), nbrs)
    if out_vecs is not None:
        if dtype_code == 3:  # raw mode: unconverted vector bytes
            out_vecs[...] = recs[:, :vec_bytes]
        else:
            dtype = np.dtype(DTYPE_CODE_TO_NUMPY[dtype_code])
            out_vecs[...] = recs[:, :vec_bytes].copy().view(dtype).astype(np.float32)


def gather_parents(
    raw,
    entry_len,
    vec_bytes,
    d,
    r,
    dtype_code,
    parents,
    n_threads: int = 0,
    with_vecs: bool = True,
    raw_vecs: bool = False,
):
    """Gather adjacency rows + parent vectors for a parent batch.

    Returns (nbrs [Q, r] int32 padded with parent id, vecs). vecs is
    [Q, d] f32, or with raw_vecs=True the UNCONVERTED [Q, vec_bytes] u8
    vector bytes (the caller views them as the index dtype and casts on
    device — 4x less H2D for u8/i8 data), or None if with_vecs=False.
    """
    q = len(parents)
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    # don't spawn more threads than 256-row work blocks (thread churn beats
    # the memcpy cost for small parent batches)
    n_threads = max(1, min(n_threads, q // 256 or 1))
    out_nbrs = np.empty((q, r), dtype=np.int32)
    out_vecs = None
    if with_vecs:
        out_vecs = (
            np.empty((q, vec_bytes), dtype=np.uint8)
            if raw_vecs else np.empty((q, d), dtype=np.float32)
        )
    code = 3 if raw_vecs else dtype_code
    parents = np.ascontiguousarray(parents, dtype=np.int32)
    ok = gather_parents_native(
        raw, entry_len, vec_bytes, d, r, code, parents, out_nbrs, out_vecs, n_threads
    )
    if not ok:
        gather_parents_numpy(
            raw, entry_len, vec_bytes, d, r, code, parents, out_nbrs, out_vecs
        )
    return out_nbrs, out_vecs
