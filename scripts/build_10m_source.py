"""Build the 10M R=64/m=64 source bundle (bench scale10m row).

The round-4 machine reset wiped bench_data/; this rebuilds the 10M bundle
that bench.py's scale10m row and scripts/build_10m_tuned.py (the R=32/m=32
HBM-budget conversion) both key off. Identical recipe to bench.build_bundle
at the scale10m parameters (bench.py:737-740) so cached artifacts are
byte-compatible with what the bench expects.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bang_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()

import bench

prefix = bench.prefix_for("synth", 10_000_000, 128, 64, 64, "vamana")
bench.build_bundle(
    prefix, 10_000_000, 128, 64, 64, "vamana", 10_000,
    l_build=48, build_batch=8192,
)
print(prefix)
