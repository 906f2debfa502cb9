"""One parameterized evaluation runner: a single audited code path for
large-scale evidence.

Sweeps one bundle with one engine variant over an L grid via bench.py's
measurement machinery (stage timers, recall with distance-tie expansion,
device-step probes, pipelined QPS) and writes a JSON artifact.

Examples:
  # tuned 10M inmemory sweep (reuses the source bundle's queries + GT)
  python scripts/run_eval.py \
      --prefix bench_data/synth_v2_n10000000_d128_r32_m32_vamana \
      --queries-from bench_data/synth_v2_n10000000_d128_r64_m64_vamana \
      --variant inmemory --grid 14 16 20 25 30 40 60 90 --refine \
      --neighbor-codes --out bench_data/scale10m_tuned.json

  # 100M R=64 Base sweep + sampled-entry probe
  python scripts/run_eval.py \
      --prefix bench_data/synthg_v1_n100000000_d128_r64_m32_shardvamana \
      --variant base --grid 40 60 100 150 220 --beam 2 --extra 24 \
      --no-mmap --probe-sampled-entry --out BASE100M_R64.json
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bang_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()

import bench
from bang_jax.formats.bin_io import load_bin_auto, load_truthset


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prefix", required=True, help="bundle path prefix")
    ap.add_argument("--queries-from", default=None,
                    help="bundle prefix to take _query.bin/_gt.bin from "
                         "(default: --prefix; tuned bundles reuse the "
                         "source bundle's vectors => same queries + GT)")
    ap.add_argument("--variant", default="base",
                    choices=("base", "inmemory", "exactdistance"))
    ap.add_argument("--grid", type=int, nargs="+", default=(30, 45, 60, 90))
    ap.add_argument("--nq", type=int, default=10_000)
    ap.add_argument("--beam", type=int, default=2)
    ap.add_argument("--extra", type=int, default=24)
    ap.add_argument("--n-pipeline", type=int, default=8)
    ap.add_argument("--mmap", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="mmap the packed graph instead of loading to RAM "
                         "(base variant; the reference holds it in RAM)")
    ap.add_argument("--entry-mode", default="medoid",
                    choices=("medoid", "sampled"))
    ap.add_argument("--probe-sampled-entry", action="store_true",
                    help="after the sweep, re-run the chosen L with "
                         "entry_mode=sampled and attach the delta")
    ap.add_argument("--refine", action="store_true",
                    help="frontier refinement around the recall knee "
                         "(inmemory/exactdistance sweeps)")
    ap.add_argument("--neighbor-codes", action="store_true",
                    help="force the neighbor-aligned nbr_codes layout")
    ap.add_argument("--note", default=None, help="free-form provenance note")
    ap.add_argument("--out", required=True, help="output JSON artifact path")
    args = ap.parse_args()

    prefix = os.path.abspath(args.prefix)
    qsrc = os.path.abspath(args.queries_from or args.prefix)
    nq = args.nq

    if args.variant == "base":
        queries = load_bin_auto(qsrc + "_query.bin", np.uint8).astype(
            np.float32)[:nq]
        gt_ids, gt_dists = load_truthset(qsrc + "_gt.bin")
        row = bench.sweep_base(
            prefix, queries, gt_ids[:nq], gt_dists[:nq], grid=tuple(args.grid),
            beam=args.beam, extra=args.extra, n_pipeline=args.n_pipeline,
            mmap=args.mmap, entry_mode=args.entry_mode,
        )
        if args.probe_sampled_entry and row:
            try:
                row_s = bench.sweep_base(
                    prefix, queries, gt_ids[:nq], gt_dists[:nq],
                    grid=(row["L"],), beam=args.beam, extra=args.extra,
                    n_pipeline=args.n_pipeline, mmap=args.mmap,
                    entry_mode="sampled",
                )
                row["sampled_entry"] = {
                    k: row_s.get(k) for k in
                    ("recall", "qps_wall", "n_device_steps",
                     "projected_pcie_qps", "device_step_ms",
                     "steps_per_round_trip")
                }
            except Exception as e:  # noqa: BLE001 — artifact must still land
                row["sampled_entry"] = {"error": str(e)}
    else:
        queries, gt_ids, gt_dists = bench.load_bundle(qsrc, nq)
        index_kwargs = {}
        if args.neighbor_codes:
            index_kwargs["neighbor_codes"] = True
        row = bench.sweep_variant(
            prefix, args.variant, queries, gt_ids, gt_dists,
            grid=tuple(args.grid), refine=args.refine,
            index_kwargs=index_kwargs or None,
        )

    meta_path = prefix + "_disk_metadata.bin"
    if os.path.exists(meta_path):
        from bang_jax.formats.graph import load_metadata

        m = load_metadata(meta_path)
        row["n_points"] = int(m.n)
        row["graph_degree"] = int(m.degree)
    row["num_queries"] = nq
    row["bundle"] = os.path.basename(prefix)
    if args.note:
        row["note"] = args.note
    with open(args.out, "w") as f:
        json.dump(row, f, indent=1)
    print("[run_eval] " + json.dumps(row)[:400], flush=True)


if __name__ == "__main__":
    main()
