"""Build the tuned 10M bundle (R=32 graph + m=32 PQ) STANDALONE.

scripts/build_10m_tuned.py derives this bundle from the R=64/m=64 source
bundle (warm-started graph, shared vectors/queries/GT) — the cheaper path
when the source exists. Without it, building the source first just to
derive the tuned bundle doubles the device time; this script builds the
tuned bundle directly with bench.build_bundle.

Data compatibility: build_bundle's dataset/queries/GT depend only on
(n, dim, seed, query_noise) — NOT on R/m — so this bundle's vectors,
queries and ground truth are byte-identical to what the source-bundle path
produces, and a later source rebuild stays consistent.

The tuned point is the scale-matched headline comparable (reference:
SIFT1B on A100 = 117,647 QPS @ 0.9 recall, Cost_Analysis.pdf p.2).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bang_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()

import bench

prefix = bench.prefix_for("synth", 10_000_000, 128, 32, 32, "vamana")
bench.build_bundle(
    prefix, 10_000_000, 128, 32, 32, "vamana", 10_000,
    l_build=48, build_batch=8192,
)
print(prefix)
