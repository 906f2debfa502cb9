"""Build the memory-budget-tuned 10M bundle: R=32 graph + m=32 PQ.

Rationale: the scattered PQ path gathers Q*beam*R tiny [m]-byte code rows
per iteration. The neighbor-aligned layouts (ONE row per parent) need
N*R*m bytes of device memory: 40 GB at the R=64/m=64 build, but 10 GB at
R=32/m=32 — the same RAM-budget knob
DiskANN's `-B` flag turns (README.md:49: PQ chunks are chosen by memory
budget, e.g. 74 chunks for SIFT1B on an 80 GB A100).

Reuses the existing 10M bundle's vectors (sliced out of its packed
_disk.bin) and its queries + exact ground truth (same data ⇒ same GT);
builds only the R=32 Vamana graph and the m=32 PQ on device.
"""

import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bang_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()

from bang_jax.formats import synthetic
from bang_jax.formats.accel import encode_pq_jax
from bang_jax.formats.graph import GraphIndex, load_metadata, save_graph_index
from bang_jax.formats.pq import save_pq
from bang_jax.formats.vamana import build_vamana_graph

CACHE = os.path.join(REPO, "bench_data")
SRC = os.path.join(CACHE, "synth_v2_n10000000_d128_r64_m64_vamana")
DST = os.path.join(CACHE, "synth_v2_n10000000_d128_r32_m32_vamana")
R, M, L_BUILD, BATCH = 32, 32, 48, 16384

t0 = time.time()


def log(msg):
    print(f"[10mtuned] {msg} t={time.time()-t0:.0f}s", file=sys.stderr, flush=True)


meta = load_metadata(SRC + "_disk_metadata.bin")
n, d = meta.n, meta.dim
log(f"source: N={n} D={d} entry_len={meta.entry_len}")

raw = np.memmap(SRC + "_disk.bin", dtype=np.uint8, mode="r",
                shape=(n, meta.entry_len))
data = np.ascontiguousarray(raw[:, :d])  # [N, D] u8 vector planes
del raw
log("vectors extracted from packed source")

if not os.path.exists(DST + "_disk.bin"):
    # Warm start from the source bundle's R=64 graph. The packed _disk.bin
    # stores each row's valid edges sorted ascending BY ID with zero padding
    # after (formats/graph.py save_graph_index) — so taking the first R
    # columns keeps an arbitrary (smallest-id) R-subset of real edges, not a
    # nearest-first prefix. That's still a far-better-than-random seed: every
    # kept entry is a true pruned edge, and the warm pass re-prunes at R=32
    # anyway (formats/vamana.py init=). Padding slots are rewritten to
    # self-ids, the convention build_vamana_graph's init path expects.
    rec = np.dtype([("vec", np.uint8, d), ("deg", np.uint32),
                    ("nbr", np.int32, (meta.entry_len - d - 4) // 4)])
    mm = np.memmap(SRC + "_disk.bin", dtype=rec, mode="r", shape=(n,))
    init_adj = np.ascontiguousarray(mm["nbr"][:, :R])
    init_deg = np.minimum(mm["deg"], R).astype(np.int32)
    pad = np.arange(R, dtype=np.int32)[None, :] >= init_deg[:, None]
    np.copyto(init_adj, np.arange(n, dtype=np.int32)[:, None], where=pad)
    del mm, pad
    log("warm seed extracted from source R=64 graph")
    adj, degrees, medoid = build_vamana_graph(
        data, r=R, l_build=L_BUILD, alpha=1.44, batch=BATCH, seed=3,
        n_passes=1, init=(init_adj, init_deg),
        medoid=int(meta.medoid),  # same dataset as the source bundle
    )
    log(f"graph built (medoid={medoid})")
    save_graph_index(DST, GraphIndex(data, adj, degrees, medoid))
    log("graph saved")

if not os.path.exists(DST + "_pq_compressed.bin"):
    pq = synthetic.train_pq(data[: 1 << 19], M, seed=3)
    pq.codes = encode_pq_jax(data, pq)
    save_pq(DST, pq)
    log("PQ saved")

for suffix in ("_query.bin", "_gt.bin"):
    if not os.path.exists(DST + suffix):
        shutil.copyfile(SRC + suffix, DST + suffix)
log(f"DONE: {DST}")
print(DST)
