"""bang_jax — billion-scale graph-ANN search in JAX.

From-scratch JAX/XLA/Pallas re-design of the capabilities of
karthik86248/BANG-Billion-Scale-ANN: batched greedy best-first search over
Vamana graphs with Product-Quantization distance tables, per-query visited-set
filtering, and exact-distance re-ranking, in three variants (host-RAM-streamed
graph, fully device-resident graph, exact-distance traversal).

Subpackages (formats/utils are numpy-only; everything else imports JAX):
  formats/  — index file formats, DiskANN converter, synthetic builder
  ops/      — PQ tables & lookup, visited-set filters, worklist merge, L2
  models/   — the three search variants as jit-compiled programs
  parallel/ — multi-chip sharding (query-DP, node-sharded, chunk-sharded PQ)
  utils/    — config, recall, timers, logging
  harness/  — CLI driver with L-sweep / recall / QPS reporting
"""

from bang_jax.constants import (  # noqa: F401
    MAX_R,
    MAX_L,
    ENUM_DIST_L2,
    ENUM_DIST_MIPS,
)

__version__ = "0.1.0"

_LAZY = {
    "BANGSearch": ("bang_jax.api", "BANGSearch"),
    "SearchParams": ("bang_jax.utils.config", "SearchParams"),
}


def __getattr__(name):
    # Lazy re-exports keep `import bang_jax.formats` free of the JAX import.
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'bang_jax' has no attribute {name!r}")
