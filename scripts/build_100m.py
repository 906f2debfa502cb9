"""Build the 100M-point index bundle on one device (DiskANN-style sharded
Vamana, formats/bigbuild.py) and write the full on-disk bundle that
BaseVariantSearcher + bench.py consume.

Configuration: 100M x 128 u8, R=32, m=32 PQ — the Base variant holds only the
PQ codes in HBM (100M x 32 = 3.2 GB) while the 26 GB packed graph lives in
host RAM, exactly the reference's billion-scale split (bang_search.cu:311-328
holds the graph host-side; parANN.h:161-171 is the SIFT100M config family).

Stages (flags let a crashed run resume). Cheap stages run FIRST so that when
the multi-hour graph stage finishes, the bundle is minutes (not another hour
of device time) from complete:
  medoid — streamed medoid
  gtq    — queries + exact int8 ground truth + save (~25 min at 100M)
  pq     — train + encode + save PQ
  graph  — sharded Vamana build -> adj/degrees (per-shard .npy checkpoints)
  disk   — materialize host dataset copy + write _disk.bin + metadata
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from bang_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()
import jax

from bang_jax.formats import bigbuild
from bang_jax.formats.bin_io import save_bin, save_truthset
from bang_jax.formats.graph import GraphIndex, save_graph_index
from bang_jax.formats.pq import save_pq, PQData
from bang_jax.formats import synthetic

N = int(os.environ.get("B100_N", 100_000_000))
D = 128
R = int(os.environ.get("B100_R", 32))
M = int(os.environ.get("B100_M", 32))
NQ = 10_000
N_SHARDS = int(os.environ.get("B100_SHARDS", 20))
L_BUILD = int(os.environ.get("B100_LBUILD", 24))
N_PASSES = int(os.environ.get("B100_PASSES", 1))
BATCH = int(os.environ.get("B100_BATCH", 16384))
CACHE = os.environ.get("B100_CACHE", os.path.join(REPO, "bench_data"))
PREFIX = os.path.join(CACHE, f"synthg_v1_n{N}_d{D}_r{R}_m{M}_shardvamana")
CKPT = PREFIX + "_ckpt"
os.makedirs(CKPT, exist_ok=True)

# The generated dataset depends only on (N, D, block, n_clusters, seed) —
# NOT on the graph parameters — so a sibling bundle built at a different R
# has byte-identical queries, ground truth, PQ (same M) and medoid. Hardlink
# them instead of recomputing (~25 min of device time at 100M).
REUSE = os.environ.get("B100_REUSE", "")
if REUSE:
    _links = [("_query.bin", True), ("_gt.bin", True),
              ("_pq_pivots.bin", REUSE.split("_m")[1].split("_")[0] == str(M)),
              ("_pq_compressed.bin", REUSE.split("_m")[1].split("_")[0] == str(M))]
    for suffix, ok in _links:
        src, dst = REUSE + suffix, PREFIX + suffix
        if ok and os.path.exists(src) and not os.path.exists(dst):
            os.link(src, dst)
    _src_med = REUSE + "_ckpt/medoid.npy"
    if os.path.exists(_src_med) and not os.path.exists(CKPT + "/medoid.npy"):
        os.link(_src_med, CKPT + "/medoid.npy")

t0 = time.time()


def log(msg):
    print(f"[100m] {msg} t={time.time()-t0:.0f}s", file=sys.stderr, flush=True)


# block = 512K keeps GT-time peak HBM in range: chunk table 12.9 GB (i8)
# + pstat 0.4 GB + per-step [q_block, block] i32/f32 transients
gen = bigbuild.BlockGen(N, D, block=1 << 19, n_clusters=4096, seed=11)

# ---- stage: medoid ----
med_path = CKPT + "/medoid.npy"
if not os.path.exists(med_path):
    medoid = bigbuild.medoid_streamed(gen)
    np.save(med_path, medoid)
    log(f"medoid = {medoid}")
else:
    medoid = int(np.load(med_path))

# ---- stage: queries + GT (device-resident data; independent of the graph) ----
if not os.path.exists(PREFIX + "_gt.bin"):
    rng = np.random.default_rng(77)
    qblock = 7
    base = np.asarray(jax.device_get(gen.gen_block(qblock)))[:NQ].astype(np.float32)
    queries = np.clip(
        np.rint(base + rng.normal(0, 2.0, base.shape)), 0, 255
    ).astype(np.uint8)
    log("computing exact int8 ground truth (chunked int8 matmuls)")
    gt_ids, gt_dists = bigbuild.groundtruth_u8_streamed(gen, queries, 100)
    save_bin(PREFIX + "_query.bin", queries)
    save_truthset(PREFIX + "_gt.bin", gt_ids, gt_dists)
    log("ground truth saved")

# ---- stage: pq ----
if not os.path.exists(PREFIX + "_pq_compressed.bin"):
    log("training PQ on a device-generated sample")
    sample = np.asarray(jax.device_get(gen.gen_block(3)))[: 1 << 19]
    pq = synthetic.train_pq(sample, M, seed=11)
    log("encoding 100M codes on device")
    pq.codes = bigbuild.encode_pq_streamed(gen, pq)
    save_pq(PREFIX, pq)
    log("PQ saved")

# ---- stage: graph ----
adj_path, deg_path = CKPT + "/adj.npy", CKPT + "/deg.npy"
if not os.path.exists(adj_path):
    # Warm start (B100_WARM=<sibling prefix>): seed each shard build from the
    # sibling bundle's adjacency — a DiskANN-style incremental pass that also
    # upgrades degree (R=32 -> 64). The packed _disk.bin IS the adjacency
    # store; extract via a structured memmap (one sequential scan).
    init_adj = init_deg = None
    WARM = os.environ.get("B100_WARM", "")
    if WARM:
        from bang_jax.formats.graph import load_metadata as _lm

        wm = _lm(WARM + "_disk_metadata.bin")
        rec = np.dtype([("vec", np.uint8, wm.entry_len - 4 - 4 * wm.degree),
                        ("deg", np.uint32), ("nbr", np.int32, wm.degree)])
        mm = np.memmap(WARM + "_disk.bin", dtype=rec, mode="r", shape=(wm.n,))
        log(f"warm start: extracting [{wm.n}, {wm.degree}] adjacency from {WARM}")
        init_adj = np.ascontiguousarray(mm["nbr"])
        init_deg = np.minimum(mm["deg"], wm.degree).astype(np.int32)
        del mm
        log("warm adjacency extracted")
    log(f"sharded build: N={N} R={R} shards={N_SHARDS} l_build={L_BUILD} "
        f"passes={N_PASSES} warm={bool(WARM)}")
    adj, degrees, _assign = bigbuild.build_sharded_vamana(
        gen, r=R, l_build=L_BUILD, n_shards=N_SHARDS, overlap=2,
        batch=BATCH, n_passes=N_PASSES, seed=11, ckpt_dir=CKPT,
        init_adj=init_adj, init_deg=init_deg,
    )
    log("saving adjacency checkpoint (25.6 GB, silent numpy IO)")
    np.save(adj_path, adj)
    np.save(deg_path, degrees)
    log("graph checkpointed")
    # per-shard checkpoints only exist to resume a crashed graph stage; at
    # 100M/R=64 they total ~50 GB — reclaim the disk before writing _disk.bin
    import glob as _glob
    for f in _glob.glob(CKPT + "/shard*_adj.npy"):
        os.remove(f)
else:
    adj = np.load(adj_path)
    degrees = np.load(deg_path)
    log("graph loaded from checkpoint")

# ---- stage: disk (host materialize + packed records) ----
if not os.path.exists(PREFIX + "_disk.bin"):
    log("materializing host dataset copy (D2H)")
    data = bigbuild.materialize_host(gen, log=log)
    log("writing _disk.bin (26 GB)")
    save_graph_index(PREFIX, GraphIndex(data, adj, degrees, medoid), log=log)
    log("disk bundle written")

log(f"DONE: {PREFIX}")
print(PREFIX)
