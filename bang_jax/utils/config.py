"""Search configuration and dataset presets.

The reference hard-codes per-dataset settings as compile-time `#define` blocks
(BANG_Inmemory/parANN.h:38-158, BANG_Exactdistance/parANN.h + compile.sh sed
templating); here they are plain data. L and k are runtime parameters (as in
BANG_Base, bang_search.cu:561-567) that select a jit-compile specialization.
"""

from __future__ import annotations

import dataclasses

from bang_jax.constants import (
    DEFAULT_EXTRA_ITERS,
    ENUM_DIST_L2,
    MAX_L,
)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Runtime search parameters (reference: BANG_Base/bang_search.cuh:154-159).

    All fields are static under jit — changing them triggers a recompile,
    mirroring the reference's per-(L, k) kernel configuration.
    """

    L: int = 64  # worklist (beam) length
    k: int = 10  # neighbors to return
    dist_func: int = ENUM_DIST_L2
    extra_iters: int = DEFAULT_EXTRA_ITERS
    visited_mode: str = "exact"  # "exact" (worklist∪visited compare) | "bloom"
    beam_width: int = 1  # parents expanded per iteration (1 = reference schedule)
    rerank: bool = True  # exact re-rank of visited nodes (PQ variants)
    pq_impl: str = "auto"  # "auto" | "pallas" (GPU kernel) | "xla"
    traversal_precision: str = "highest"  # exact-path cross term: "highest"|"default"
    capabilities: int = 0  # ENABLE_GPU_STATS | ENABLE_CACHE_WARMUP bitmask
    # "medoid" = reference behavior (one shared entry, bang_search.cu:466);
    # "sampled" = per-query entry via one [Q, S] matmul over a strided
    # sample (models/entry.py) — saves traversal iterations
    entry_mode: str = "medoid"
    entry_samples: int = 1024  # sample size S when entry_mode == "sampled"

    def __post_init__(self):
        if not (1 <= self.L <= MAX_L):
            raise ValueError(f"L must be in [1, {MAX_L}], got {self.L}")
        if self.k > self.L:
            raise ValueError(f"k ({self.k}) must be <= L ({self.L})")
        if self.visited_mode not in ("exact", "bloom"):
            raise ValueError(f"unknown visited_mode {self.visited_mode!r}")
        if self.pq_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown pq_impl {self.pq_impl!r}")
        if self.traversal_precision not in ("highest", "default"):
            raise ValueError(f"unknown traversal_precision {self.traversal_precision!r}")
        if not (1 <= self.beam_width <= 16):
            raise ValueError(f"beam_width must be in [1, 16], got {self.beam_width}")
        if self.entry_mode not in ("medoid", "sampled"):
            raise ValueError(f"unknown entry_mode {self.entry_mode!r}")
        if self.entry_samples < 1:
            raise ValueError("entry_samples must be >= 1")

    @property
    def max_iters(self) -> int:
        # Reference: maxIters = L + NAX_EXTRA_ITERATION (bang_search.cu:53, 370)
        # = the total expansion budget; a wider beam spends it in fewer
        # sequential iterations.
        return -(-(self.L + self.extra_iters) // self.beam_width)


@dataclasses.dataclass(frozen=True)
class DatasetPreset:
    """Per-dataset constants (reference parANN.h `#define` blocks, as data)."""

    name: str
    dtype: str
    dim: int
    n: int
    chunks: int
    default_L: int = 64


# Mirrors BANG_Inmemory/parANN.h:38-158 and BANG_Exactdistance/parANN.h:38-197.
DATASET_PRESETS = {
    p.name: p
    for p in [
        DatasetPreset("sift1m", "uint8", 128, 1_000_000, 32),
        DatasetPreset("gist1m", "float32", 960, 1_000_000, 120),
        DatasetPreset("glove200", "float32", 201, 1_183_514, 50),
        DatasetPreset("nytimes", "float32", 256, 290_000, 64),
        DatasetPreset("mnist8m", "uint8", 784, 8_100_000, 98),
        DatasetPreset("sift100m", "uint8", 128, 100_000_000, 64),
        DatasetPreset("deep100m", "float32", 96, 100_000_000, 48),
        DatasetPreset("sift1b", "uint8", 128, 1_000_000_000, 74),
        DatasetPreset("deep1b", "float32", 96, 1_000_000_000, 48),
        DatasetPreset("spacev1b", "int8", 100, 1_000_000_000, 50),
        DatasetPreset("sift10k", "float32", 128, 10_000, 32),
    ]
}
