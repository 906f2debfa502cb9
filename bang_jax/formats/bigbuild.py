"""Beyond-device-memory index construction: DiskANN-style sharded Vamana build.

The reference delegates billion-point graph construction to DiskANN's
`build_disk_index`, which handles datasets larger than RAM by k-means
sharding with overlapped assignment, building a Vamana graph per shard, and
merging the per-shard edge lists (README.md:42-58; ReadMe.pdf p.1-2). This
module is the equivalent for datasets whose device-resident build footprint
(vectors + adjacency + search state) exceeds one device's memory:

  1. k-means shard centers trained on the device (Lloyd iterations);
  2. every point assigned to its `overlap` nearest centers (DiskANN uses 2 —
     overlapped membership is what stitches the final graph together);
  3. per-shard vectors assembled ON DEVICE and a Vamana graph built per shard
     with the device-resident builder (formats/vamana.py);
  4. per-shard adjacency downloaded, mapped to global ids, and merged
     round-robin with dedup (DiskANN's merge_shards scheme) to degree R.

Also here: a deterministic on-device dataset generator (threefry-keyed
blocks, regenerable at any time instead of re-uploading through a slow host
link) and an exact integer ground-truth kernel for u8 data (s8 x s8 -> s32
matmuls: bit-exact distances at int8 matmul throughput, where an f32
HIGHEST einsum would take hours at 100M and bf16 would mis-rank ties).
"""

from __future__ import annotations

import functools
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Deterministic blocked dataset generator (device-side, threefry-keyed)
# ---------------------------------------------------------------------------

class BlockGen:
    """Deterministic clustered u8 dataset, generated block-by-block on device.

    Mirrors formats.synthetic.make_clustered_data's manifold structure
    (low-intrinsic-dimension latent clusters mapped through a random linear
    map — full-dimension gaussian clusters make exact-NN ranking
    information-free at scale): point i in block b draws its latent cluster
    and noise from fold_in(key, b), so any block can be regenerated at any
    time. Nothing is ever uploaded: consumers that need the data on device
    call gen_block() again (a ~ms matmul) instead of shipping GBs through
    the host link.
    """

    def __init__(self, n: int, dim: int, block: int = 1 << 20,
                 n_clusters: int = 4096, intrinsic_dim: int = 16, seed: int = 0):
        self.n, self.dim, self.block = n, dim, block
        self.n_blocks = -(-n // block)
        self.key = jax.random.PRNGKey(seed)
        kc, ka = jax.random.split(jax.random.fold_in(self.key, 0xC0FFEE))
        self.dz = intrinsic_dim
        self.centers_z = jax.random.normal(kc, (n_clusters, intrinsic_dim)) * 1.0
        self.map_a = jax.random.normal(ka, (intrinsic_dim, dim)) / np.sqrt(intrinsic_dim)
        self.n_clusters = n_clusters

        @jax.jit
        def _gen(centers_z, map_a, key_b):
            k1, k2, k3 = jax.random.split(key_b, 3)
            ci = jax.random.randint(k1, (block,), 0, n_clusters)
            z = centers_z[ci] + 0.35 * jax.random.normal(k2, (block, intrinsic_dim))
            x = z @ map_a + 0.02 * jax.random.normal(k3, (block, dim))
            return jnp.clip(jnp.round(x * 28.0 + 128.0), 0, 255).astype(jnp.uint8)

        self._gen = _gen

    def gen_block(self, b: int) -> jnp.ndarray:
        """[block, dim] u8 — rows [b*block, (b+1)*block) of the dataset.
        The final block is full-size; rows beyond n are valid padding that
        callers slice off."""
        return self._gen(self.centers_z, self.map_a, jax.random.fold_in(self.key, b))


# ---------------------------------------------------------------------------
# Device k-means (shard centers)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k",))
def _kmeans_step(data_f32, centers, k):
    d = (
        (centers * centers).sum(-1)[None]
        - 2.0 * data_f32 @ centers.T
    )
    assign = jnp.argmin(d, axis=1)
    one_hot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
    sums = one_hot.T @ data_f32
    counts = one_hot.sum(0)
    return jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts, 1)[:, None], centers)


def kmeans_device(sample_u8: jnp.ndarray, k: int, iters: int = 12, seed: int = 1):
    """[k, D] f32 centers via Lloyd's on the device sample."""
    data = sample_u8.astype(jnp.float32)
    idx = jax.random.choice(
        jax.random.PRNGKey(seed), data.shape[0], (k,), replace=False
    )
    centers = data[idx]
    for _ in range(iters):
        centers = _kmeans_step(data, centers, k)
    return centers


# ---------------------------------------------------------------------------
# Overlapped shard assignment
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("overlap",))
def _assign_block(x_u8, centers, overlap):
    xf = x_u8.astype(jnp.float32)
    d = (centers * centers).sum(-1)[None] - 2.0 * xf @ centers.T
    _neg, idx = jax.lax.top_k(-d, overlap)
    return idx.astype(jnp.uint8)


def assign_shards(gen: BlockGen, centers, overlap: int = 2):
    """Each point's `overlap` nearest shard centers (DiskANN's overlapped
    k-means assignment). Returns (host [N, overlap] u8, device
    [n_blocks, block, overlap] u8 — kept resident so shard assembly never
    uploads indices)."""
    nb, blk = gen.n_blocks, gen.block
    assign_dev = jnp.zeros((nb, blk, overlap), jnp.uint8)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def fill(acc, x, b):
        return acc.at[b].set(_assign_block(x, centers, overlap))

    for b in range(nb):
        assign_dev = fill(assign_dev, gen.gen_block(b), b)
    host = np.asarray(jax.device_get(assign_dev)).reshape(nb * blk, overlap)
    return host[: gen.n], assign_dev


# ---------------------------------------------------------------------------
# Shard vector assembly (device compaction-scatter; nothing uploaded)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("shard",))
def _scatter_shard_block(shard_vecs, x, ablk, offset, n_valid, shard):
    """Compact this block's shard members to [offset, offset+count) of
    shard_vecs. Ascending-id order matches np.nonzero on the host copy."""
    blk = x.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, (blk,), 0)
    mask = (ablk == shard).any(-1) & (row < n_valid)
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask, offset + pos, shard_vecs.shape[0])
    return (
        shard_vecs.at[dest].set(x, mode="drop"),
        offset + mask.sum(dtype=jnp.int32),
    )


def gather_shard_vectors(gen: BlockGen, assign_dev, shard: int, n_s: int):
    """Assemble shard `shard`'s [n_s, D] u8 vector table on device by
    regenerating blocks and compaction-scattering member rows."""
    shard_vecs = jnp.zeros((n_s, gen.dim), jnp.uint8)
    offset = jnp.int32(0)
    for b in range(gen.n_blocks):
        n_valid = min(gen.n - b * gen.block, gen.block)
        shard_vecs, offset = _scatter_shard_block(
            shard_vecs, gen.gen_block(b), assign_dev[b], offset, n_valid, shard
        )
    return shard_vecs


# ---------------------------------------------------------------------------
# Round-robin merge of per-shard adjacency (DiskANN merge_shards scheme)
# ---------------------------------------------------------------------------

def merge_shard_adj(parts: list[np.ndarray], r: int, n: int,
                    chunk: int = 2_000_000,
                    log=None) -> tuple[np.ndarray, np.ndarray]:
    """Merge `overlap` per-point candidate rows into one [N, r] graph.

    parts: list of [N, r] int32 arrays (self-id = empty slot / padding).
    Round-robin interleave with dedup, truncated to r — DiskANN's
    merge_shards does exactly this on its overlapped builds. Returns
    (adj [N, r] self-padded, degrees [N]).

    log: progress every 10 chunks — at 100M this stage is minutes of
    host-side numpy.
    """
    adj = np.empty((n, r), np.int32)
    degrees = np.empty(n, np.int32)
    o = len(parts)
    for s in range(0, n, chunk):
        if log and (s // chunk) % 10 == 0:
            log(f"merge chunk {s // chunk}/{-(-n // chunk)}")
        e = min(s + chunk, n)
        rows = np.arange(s, e, dtype=np.int32)[:, None]
        # interleave: part0[0], part1[0], part0[1], part1[1], ...
        inter = np.stack([p[s:e] for p in parts], axis=2).reshape(e - s, o * r)
        inter = np.where(inter == rows, -1, inter)  # self = empty slot
        # first-occurrence dedup (argsort trick: stable sort by value, first
        # of each equal-value group wins, scatter the keep mask back)
        order = np.argsort(inter, axis=1, kind="stable")
        sv = np.take_along_axis(inter, order, axis=1)
        is_first = np.concatenate(
            [np.ones((e - s, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
        )
        keep = np.zeros_like(is_first)
        np.put_along_axis(keep, order, is_first & (sv >= 0), axis=1)
        # compact kept values to the front, preserving interleave order
        pos = np.argsort(~keep, axis=1, kind="stable")  # kept first
        compacted = np.take_along_axis(inter, pos, axis=1)[:, :r]
        valid = np.take_along_axis(keep, pos, axis=1)[:, :r]
        degrees[s:e] = valid.sum(1)
        adj[s:e] = np.where(valid, compacted, rows)
        del inter, order, sv, keep, pos
    return adj, degrees


# ---------------------------------------------------------------------------
# Exact integer ground truth for u8 data (s8 matmul path)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k",))
def _gt_block_u8(q_u8, chunks_i8, chunk_pstat, k):
    """Exact top-k of u8 queries against chunked PRE-SHIFTED i8 vectors.

    With q = a+128, v = b+128 (a, b int8): the cross term a.b runs as
    s8 x s8 -> s32 matmul, bit-exact. The full squared distance
    regroups into dist = qstat[q] + pstat[v] - 2*a.b where
      qstat = ||q||^2 - 256*sum(a) - 32768*D   (per query, i32 exact)
      pstat = ||v||^2 - 256*sum(b)             (per point, precomputed)
    Distances (<= D*255^2 = 8.3M at D=128) are exactly representable in the
    f32 used for the top-k merge. Chunks are stored ALREADY shifted (i8 =
    u8 XOR 0x80 bit pattern) so no per-step copy of the table is made.
    """
    b_q, d = q_u8.shape
    a = (q_u8.astype(jnp.int32) - 128).astype(jnp.int8)
    qstat = (
        (q_u8.astype(jnp.int32) ** 2).sum(-1)
        - 256 * a.astype(jnp.int32).sum(-1)
        - 32768 * d
    )  # [B]

    def body(ci, carry):
        best_d, best_i = carry
        b = chunks_i8[ci]  # [nc, D] i8, pre-shifted
        ab = jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [B, nc] s32, exact
        dist = (qstat[:, None] + chunk_pstat[ci][None, :] - 2 * ab).astype(
            jnp.float32
        )
        neg, idx = jax.lax.top_k(-dist, k)
        nc = b.shape[0]
        cat_d = jnp.concatenate([best_d, -neg], axis=1)
        cat_i = jnp.concatenate([best_i, idx + ci * nc], axis=1)
        nneg, sel = jax.lax.top_k(-cat_d, k)
        return -nneg, jnp.take_along_axis(cat_i, sel, axis=1)

    init = (jnp.full((b_q, k), jnp.inf, jnp.float32), jnp.zeros((b_q, k), jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, chunks_i8.shape[0], body, init)
    return best_i, best_d


def groundtruth_u8_streamed(gen: BlockGen, queries_u8: np.ndarray, k: int,
                            q_block: int = 128):
    """Exact GT against the full generated dataset (regenerated into an HBM
    chunk table; int8-exact distances). Returns (ids u32, dists f32)."""
    nb, blk, d = gen.n_blocks, gen.block, gen.dim
    chunks = jnp.zeros((nb, blk, d), jnp.int8)
    pstat = jnp.zeros((nb, blk), jnp.int32)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def fill(chunks, pstat, x, ci, n_valid):
        xi = x.astype(jnp.int32)
        ps = (xi ** 2).sum(-1) - 256 * (xi - 128).sum(-1)
        # padding rows (beyond n) get huge pstat so they never rank
        row = jax.lax.broadcasted_iota(jnp.int32, (blk,), 0)
        ps = jnp.where(row < n_valid, ps, jnp.int32(2_000_000_000))
        shifted = (xi - 128).astype(jnp.int8)
        return chunks.at[ci].set(shifted), pstat.at[ci].set(ps)

    for b in range(nb):
        n_valid = min(gen.n - b * blk, blk)
        chunks, pstat = fill(chunks, pstat, gen.gen_block(b), b, n_valid)

    nq = queries_u8.shape[0]
    ids = np.empty((nq, k), np.uint32)
    dists = np.empty((nq, k), np.float32)
    for s in range(0, nq, q_block):
        q = queries_u8[s : s + q_block]
        nbq = q.shape[0]
        if nbq < q_block:
            q = np.pad(q, ((0, q_block - nbq), (0, 0)))
        i, dd = _gt_block_u8(jnp.asarray(q), chunks, pstat, k)
        ids[s : s + q_block] = np.asarray(i[:nbq]).astype(np.uint32)
        dists[s : s + q_block] = np.asarray(dd[:nbq])
    chunks.delete()
    pstat.delete()
    return ids, dists


def d2h_chunked(arr, chunk_bytes: int = 1 << 28, log=None) -> np.ndarray:
    """device_get in row chunks (~256 MB), with progress per chunk, so a
    multi-GB fetch never needs a second full-size host buffer."""
    n = arr.shape[0]
    row_bytes = max(1, int(np.prod(arr.shape[1:])) * arr.dtype.itemsize)
    rows = max(1, chunk_bytes // row_bytes)
    out = np.empty(arr.shape, arr.dtype)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        out[s:e] = np.asarray(jax.device_get(arr[s:e]))
        if log:
            log(f"d2h {e}/{n} rows")
    return out


# ---------------------------------------------------------------------------
# Streamed helpers: medoid, PQ encoding, host materialization
# ---------------------------------------------------------------------------

@jax.jit
def _block_colsum_i32(x):
    return x.astype(jnp.int32).sum(0)


@jax.jit
def _block_nearest(x, mean_f32, n_valid):
    xf = x.astype(jnp.float32)
    d = ((xf - mean_f32[None]) ** 2).sum(-1)
    row = jax.lax.broadcasted_iota(jnp.int32, (x.shape[0],), 0)
    d = jnp.where(row < n_valid, d, jnp.inf)
    i = jnp.argmin(d)
    return i.astype(jnp.int32), d[i]


def medoid_streamed(gen: BlockGen) -> int:
    """Dataset medoid (nearest point to the mean), two streamed passes."""
    tot = np.zeros(gen.dim, np.int64)
    for b in range(gen.n_blocks):
        n_valid = min(gen.n - b * gen.block, gen.block)
        s = np.asarray(_block_colsum_i32(gen.gen_block(b)[:n_valid]), np.int64) \
            if n_valid < gen.block else \
            np.asarray(_block_colsum_i32(gen.gen_block(b)), np.int64)
        tot += s
    mean = jnp.asarray((tot / gen.n).astype(np.float32))
    best_d, best_i = np.inf, 0
    for b in range(gen.n_blocks):
        n_valid = min(gen.n - b * gen.block, gen.block)
        i, dv = jax.device_get(_block_nearest(gen.gen_block(b), mean, n_valid))
        if float(dv) < best_d:
            best_d, best_i = float(dv), b * gen.block + int(i)
    return best_i


def encode_pq_streamed(gen: BlockGen, pq) -> np.ndarray:
    """PQ-encode the generated dataset on device, blocked ([N, m] u8)."""
    from bang_jax.formats.accel import _encode_block
    from bang_jax.ops.pq import prepare_pq_codebook

    cb = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)
    m = cb.num_chunks
    codes = np.empty((gen.n, m), np.uint8)
    centroid = jnp.asarray(pq.centroid.astype(np.float32))

    @jax.jit
    def enc(x, centroid, piv_chunks, dim_idx, dim_mask):
        xc = x.astype(jnp.float32) - centroid
        chunk_data = xc[:, dim_idx] * dim_mask
        return _encode_block(chunk_data, piv_chunks)

    for b in range(gen.n_blocks):
        n_valid = min(gen.n - b * gen.block, gen.block)
        c = enc(gen.gen_block(b), centroid, cb.piv_chunks, cb.dim_idx, cb.dim_mask)
        codes[b * gen.block : b * gen.block + n_valid] = np.asarray(c)[:n_valid]
    return codes


def materialize_host(gen: BlockGen, log=None) -> np.ndarray:
    """Download the full generated dataset to host RAM ([N, D] u8) — needed
    once to write the packed `_disk.bin` host-graph file. Device and host
    copies are bit-identical by construction (same generated blocks)."""
    out = np.empty((gen.n, gen.dim), np.uint8)
    for b in range(gen.n_blocks):
        n_valid = min(gen.n - b * gen.block, gen.block)
        out[b * gen.block : b * gen.block + n_valid] = np.asarray(
            jax.device_get(gen.gen_block(b))
        )[:n_valid]
        if log and b % 10 == 0:
            log(f"materialize block {b}/{gen.n_blocks}")
    return out


# ---------------------------------------------------------------------------
# The sharded build driver
# ---------------------------------------------------------------------------

def shard_build_hbm_bytes(n_s: int, d: int, r: int, batch: int,
                          l_build: int, k_overflow: int | None = None) -> int:
    """Peak-HBM model for one shard's build_vamana_graph call.

    Persistent arrays (vectors u8 + norms f32 + adj i32 + degrees i32) plus
    the dominant per-batch f32 transients (traversal per-iter candidate
    gather, main prune pool, overflow re-prune pool), each double-buffered.
    Calibrated against the round-4 compile-OOM: a 25.4M-member shard at
    R=64/l_build=40/batch=16384 models to ~21 GB — the allocator reported
    21.2 GB against 15.75 GB — so the model is accurate to ~1%."""
    if k_overflow is None:
        k_overflow = max(512, batch)
    max_iters = l_build + 16
    persistent = n_s * (d + 4 + 4 * r + 4)
    c_pool = max_iters + r  # visited set + old edges joined for the prune
    prune = batch * c_pool * d * 4 * 2
    ovf = k_overflow * 2 * r * d * 4 * 2
    iter_gather = batch * r * d * 4 * 2
    return persistent + prune + ovf + iter_gather


# Share of the device's allocator limit one shard build may model to.
SHARD_MEMORY_SHARE = 0.92


def shard_memory_budget() -> float:
    """Bytes a shard build may take: SHARD_MEMORY_SHARE of the device's
    reported limit. A device that reports no limit (the CPU backend) gets no
    budget (infinite), so the guards below never fire there."""
    from bang_jax.models.index import device_bytes_limit

    limit = device_bytes_limit()
    return float("inf") if limit is None else SHARD_MEMORY_SHARE * limit


def build_sharded_vamana(
    gen: BlockGen,
    r: int = 32,
    l_build: int = 32,
    n_shards: int = 6,
    overlap: int = 2,
    batch: int = 8192,
    n_passes: int = 1,
    alpha: float = 1.44,
    kmeans_sample: int = 1 << 21,
    seed: int = 0,
    verbose: bool = True,
    ckpt_dir: str | None = None,
    init_adj: np.ndarray | None = None,
    init_deg: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DiskANN-style sharded build over a generated dataset.

    Returns (adj [N, r] int32 self-padded, degrees [N] int32,
    assignment [N, overlap] u8). Peak device memory = one shard's vectors +
    adjacency + build state (~N*overlap/n_shards points), not the full
    dataset.
    """
    from bang_jax.formats.vamana import build_vamana_graph

    t0 = time.time()
    n = gen.n

    def log(msg):
        if verbose:
            print(f"[bigbuild] {msg} t={time.time()-t0:.0f}s",
                  file=sys.stderr, flush=True)

    # Upfront balanced-estimate guard: an OOM must be a 2-second error, not
    # a failure at shard-0 compile time after the whole setup.
    budget = shard_memory_budget()
    est = shard_build_hbm_bytes(
        -(-n * overlap // n_shards), gen.dim, r, batch, l_build
    )
    if est > budget:
        raise MemoryError(
            f"balanced shard build models to {est/1e9:.1f} GB > budget "
            f"{budget/1e9:.1f} GB; raise n_shards or lower batch/l_build"
        )

    assign_path = f"{ckpt_dir}/assignment.npy" if ckpt_dir else None
    assign_dev = None  # lazily uploaded when an un-checkpointed shard needs it
    if assign_path and os.path.exists(assign_path):
        assignment = np.load(assign_path)
        log("assignment loaded from checkpoint")
    else:
        sample = gen.gen_block(0)[: kmeans_sample]
        centers = kmeans_device(sample, n_shards, iters=12, seed=seed + 1)
        log(f"kmeans centers done (k={n_shards})")
        assignment, assign_dev = assign_shards(gen, centers, overlap)
        log("assignment done")
        if assign_path:
            np.save(assign_path, assignment)

    # Exact per-shard guard (kmeans clusters are unbalanced; the LARGEST
    # shard sets peak memory, not the average)
    counts = np.array([
        int(((assignment == s).any(axis=1)).sum()) for s in range(n_shards)
    ])
    worst = shard_build_hbm_bytes(int(counts.max()), gen.dim, r, batch, l_build)
    log(f"shard members min/mean/max = {counts.min()}/{counts.mean():.0f}/"
        f"{counts.max()}; modeled peak {worst/1e9:.1f} GB "
        f"(budget {budget/1e9:.1f})")
    if worst > budget:
        raise MemoryError(
            f"largest shard ({counts.max()} members) models to "
            f"{worst/1e9:.1f} GB > budget {budget/1e9:.1f} GB; "
            f"raise n_shards (currently {n_shards}) or lower batch/l_build"
        )

    parts = [np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r)).copy()
             for _ in range(overlap)]
    rows_written = np.zeros(n, np.int8)
    for s in range(n_shards):
        in_shard = (assignment == s).any(axis=1)
        member_ids = np.nonzero(in_shard)[0]
        n_s = len(member_ids)
        ck = f"{ckpt_dir}/shard{s}_adj.npy" if ckpt_dir else None
        if ck is not None and os.path.exists(ck):
            adj_l = np.load(ck)
            log(f"shard {s}: {n_s} members; loaded from checkpoint")
        else:
            log(f"shard {s}: {n_s} members; assembling vectors on device")
            init = None
            if init_adj is not None:
                # Warm start (degree upgrade / extra pass): map the global
                # seed graph's neighbor ids into shard-local ids; edges
                # leaving the shard become self-padding, and surviving
                # edges are compacted to the row front (the builder's
                # reverse-edge slot arithmetic assumes real-edges-first).
                g_rows = init_adj[member_ids]  # [n_s, r_in] global ids
                if init_deg is not None:
                    # Padding slots (>= true degree) hold zeros when the seed
                    # was extracted from a packed _disk.bin; left in place
                    # they'd map to real edges to node 0 in the shards that
                    # contain it. Turn them into self-ids so the self-edge
                    # mask below strips them.
                    d_rows = init_deg[member_ids].astype(np.int32)
                    pad = (np.arange(g_rows.shape[1], dtype=np.int32)[None, :]
                           >= d_rows[:, None])
                    g_rows = np.where(pad, member_ids[:, None].astype(np.int32),
                                      g_rows)
                    del d_rows, pad
                loc = np.searchsorted(member_ids, g_rows)
                loc = np.minimum(loc, n_s - 1).astype(np.int32)
                # a source row's self-padding entries (own global id) map to
                # a valid local id — they are not edges; mask them out
                ok = (member_ids[loc] == g_rows) & (g_rows != member_ids[:, None])
                self_col = np.arange(n_s, dtype=np.int32)[:, None]
                local = np.where(ok, loc, self_col)
                order_c = np.argsort(~ok, axis=1, kind="stable")
                local = np.take_along_axis(local, order_c, axis=1)
                init = (local, ok.sum(axis=1).astype(np.int32))
                del g_rows, loc, ok, local, order_c
            if assign_dev is None:
                # resumed run: rebuild the device copy from the host
                # checkpoint (200 MB at 100M — one upload, reused per shard)
                nb, blk = gen.n_blocks, gen.block
                padded = np.zeros((nb * blk, overlap), np.uint8)
                padded[: n] = assignment
                padded[n:] = 255  # padding rows join no shard
                assign_dev = jnp.asarray(padded.reshape(nb, blk, overlap))
                del padded
            shard_vecs = gather_shard_vectors(gen, assign_dev, s, n_s)
            adj_dev, deg_dev, _med = build_vamana_graph(
                shard_vecs, r=r, l_build=l_build, alpha=alpha, batch=batch,
                seed=seed + 10 + s, n_passes=n_passes, verbose=verbose,
                medoid=int(n_s // 2), return_device=True, init=init,
            )
            shard_vecs.delete()
            log(f"shard {s}: graph built; downloading adjacency (chunked)")
            adj_l = d2h_chunked(adj_dev, log=log if verbose else None)
            adj_dev.delete()
            deg_dev.delete()
            if ck is not None:
                np.save(ck, adj_l)
        log(f"shard {s}: mapping to global ids")
        gids = member_ids.astype(np.int32)
        adj_g = gids[adj_l]  # local -> global (self-padding maps to self)
        # each point stores this shard's rows in its next free overlap slot
        slot = rows_written[gids]
        for o in range(overlap):
            sel = slot == o
            parts[o][gids[sel]] = adj_g[sel]
        rows_written[gids] = slot + 1
        del adj_l, adj_g
    if assign_dev is not None:
        assign_dev.delete()
    log("all shards built; merging")
    adj, degrees = merge_shard_adj(parts, r, n, log=log)
    log("merge done")
    return adj, degrees, assignment
