"""Egress-gated real-dataset pipeline: download -> convert -> index -> smoke.

Reference workflow parity (README.md:42-58 + ReadMe.pdf): the reference
expects DiskANN-built indices over the public corpora (SIFT1M / GIST1M from
corpus-texmex.irisa.fr, SIFT1B/bigann subsets from big-ann-benchmarks). This
script reproduces the end-to-end path with this framework's own builder:

  1. download the corpus archives (skipped gracefully when the environment
     has no egress — every step after download works from local files);
  2. convert fvecs/bvecs/ivecs -> DiskANN-style .bin (formats/texmex.py);
  3. build a Vamana graph + PQ on the accelerator (formats/vamana.py);
  4. run the harness driver and report recall/QPS against the corpus's own
     ground truth.

Usage:
  python scripts/get_real_data.py sift1m [--dir bench_data/real] [--skip-download]
"""

import argparse
import os
import subprocess
import sys
import tarfile
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATASETS = {
    "siftsmall": {  # 10K points — the reference's smoke-test scale (ReadMe.pdf p.3)
        "url": "ftp://ftp.irisa.fr/local/texmex/corpus/siftsmall.tar.gz",
        "base": "siftsmall/siftsmall_base.fvecs",
        "query": "siftsmall/siftsmall_query.fvecs",
        "gt": "siftsmall/siftsmall_groundtruth.ivecs",
        "r": 32, "m": 32, "L": 40,
    },
    "sift1m": {
        "url": "ftp://ftp.irisa.fr/local/texmex/corpus/sift.tar.gz",
        "base": "sift/sift_base.fvecs",
        "query": "sift/sift_query.fvecs",
        "gt": "sift/sift_groundtruth.ivecs",
        "r": 64, "m": 64, "L": 40,
    },
    "gist1m": {
        "url": "ftp://ftp.irisa.fr/local/texmex/corpus/gist.tar.gz",
        "base": "gist/gist_base.fvecs",
        "query": "gist/gist_query.fvecs",
        "gt": "gist/gist_groundtruth.ivecs",
        "r": 64, "m": 120, "L": 64,
    },
}


def fetch(url: str, dest: str) -> bool:
    if os.path.exists(dest):
        return True
    print(f"[real] downloading {url}", flush=True)
    try:
        with urllib.request.urlopen(url, timeout=30) as r, open(dest + ".part", "wb") as f:
            while True:
                chunk = r.read(1 << 22)
                if not chunk:
                    break
                f.write(chunk)
        os.rename(dest + ".part", dest)
        return True
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        print(f"[real] download unavailable ({e}); skipping — rerun where "
              f"egress is allowed, or drop the archive at {dest}", flush=True)
        return False


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", choices=sorted(DATASETS))
    p.add_argument("--dir", default="bench_data/real")
    p.add_argument("--skip-download", action="store_true")
    p.add_argument("--num-queries", type=int, default=1000)
    args = p.parse_args()
    cfg = DATASETS[args.dataset]
    os.makedirs(args.dir, exist_ok=True)
    archive = os.path.join(args.dir, os.path.basename(cfg["url"]))

    if not args.skip_download and not fetch(cfg["url"], archive):
        return 0  # graceful no-egress skip
    if not os.path.exists(os.path.join(args.dir, cfg["base"])):
        if not os.path.exists(archive):
            print(f"[real] archive missing: {archive}", flush=True)
            return 0
        print(f"[real] extracting {archive}", flush=True)
        with tarfile.open(archive) as t:
            t.extractall(args.dir, filter="data")

    from bang_jax.formats import texmex
    from bang_jax.formats.bin_io import load_bin
    from bang_jax.formats.graph import GraphIndex, save_graph_index
    from bang_jax.formats.pq import save_pq
    from bang_jax.formats import synthetic
    from bang_jax.formats.accel import encode_pq_jax
    from bang_jax.formats.vamana import build_vamana_graph
    from bang_jax.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    prefix = os.path.join(args.dir, args.dataset)
    import numpy as np

    if not os.path.exists(prefix + "_gt.bin"):
        texmex.groundtruth_to_truthset(os.path.join(args.dir, cfg["gt"]), prefix + "_gt.bin")
        texmex.to_bin(os.path.join(args.dir, cfg["query"]), prefix + "_query.bin")
    if not os.path.exists(prefix + "_disk.bin"):
        data = texmex.read_vecs(os.path.join(args.dir, cfg["base"])).astype(np.float32)
        print(f"[real] building index over {data.shape}", flush=True)
        adj, degrees, medoid = build_vamana_graph(
            data, r=cfg["r"], l_build=48, batch=4096, seed=0
        )
        save_graph_index(prefix, GraphIndex(data, adj, degrees, medoid))
        pq = synthetic.train_pq(data, cfg["m"], seed=0)
        pq.codes = encode_pq_jax(data, pq)
        save_pq(prefix, pq)

    # NOTE: TexMex ground truth carries no distances; recall is computed
    # without tie expansion (ids only) — marginally stricter than the
    # reference's tie-expanded recall.
    cmd = [
        sys.executable, "-m", "bang_jax.harness.driver",
        prefix, prefix + "_query.bin", prefix + "_gt.bin",
        str(args.num_queries), "10", "float", "l2",
        "--variant", "inmemory", "--mode", "auto",
        "--target-recall", "90", "--reps", "2", "--step", "12",
    ]
    print("[real] " + " ".join(cmd), flush=True)
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
