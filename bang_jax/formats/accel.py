"""Accelerator-powered offline index construction (kNN graphs, ground truth,
PQ training and encoding) — device matmuls instead of numpy loops.

The reference delegates graph building to DiskANN on the CPU (offline,
hours-scale for 1B points); for self-contained benchmarks we build synthetic
indices on the accelerator itself: blocked exact-kNN via the norm expansion
as a matmul + `lax.top_k`. A 1M x 128 dataset builds in seconds versus ~hours in
numpy. Ground truth uses full f32 precision; graph edges tolerate bf16.
"""

from __future__ import annotations

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k", "exact"))
def _block_topk(block_vecs, vectors, vector_norms, row_offset, k, exact):
    """Top-k nearest ids+dists of `block_vecs` against `vectors` (self excluded
    by distance; caller drops the self column)."""
    b = block_vecs.astype(jnp.float32)
    precision = jax.lax.Precision.HIGHEST if exact else jax.lax.Precision.DEFAULT
    cross = jnp.einsum(
        "bd,nd->bn",
        b,
        vectors.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    d = vector_norms[None, :] - 2.0 * cross + (b * b).sum(-1, keepdims=True)
    neg, idx = jax.lax.top_k(-d, k)
    return idx.astype(jnp.int32), -neg


def _device_vectors(vectors: np.ndarray):
    v = jnp.asarray(vectors.astype(np.float32))
    v64 = vectors.astype(np.float64)
    norms = jnp.asarray((v64 * v64).sum(-1).astype(np.float32))
    return v, norms


@functools.partial(jax.jit, static_argnames=("k",))
def _block_topk_chunked(q_blk, vecs, norms, k):
    """Top-k of q_blk against chunked vectors [n_chunks, nc, D] with a
    running merge — the full [block, N] distance matrix never materializes
    (41 GB at N=10M), only [block, nc] per chunk."""
    b = q_blk.shape[0]
    nc = vecs.shape[1]
    q_norm = (q_blk * q_blk).sum(-1, keepdims=True)

    def body(ci, carry):
        best_d, best_i = carry
        v = vecs[ci].astype(jnp.float32)
        cross = jnp.einsum(
            "bd,nd->bn", q_blk, v,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d = norms[ci][None, :] - 2.0 * cross + q_norm
        neg, idx = jax.lax.top_k(-d, k)
        cat_d = jnp.concatenate([best_d, -neg], axis=1)
        cat_i = jnp.concatenate([best_i, idx + ci * nc], axis=1)
        nneg, sel = jax.lax.top_k(-cat_d, k)
        return -nneg, jnp.take_along_axis(cat_i, sel, axis=1)

    init = (jnp.full((b, k), jnp.inf, jnp.float32), jnp.zeros((b, k), jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, vecs.shape[0], body, init)
    return best_i, best_d


def compute_groundtruth_jax(
    vectors: np.ndarray,
    queries: np.ndarray,
    k: int,
    block: int = 1024,
    n_chunk: int = 1_000_000,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k ground truth on the accelerator (f32, HIGHEST precision).

    Datasets larger than n_chunk are processed in N-chunks with a running
    top-k merge so the distance matrix stays [block, n_chunk]."""
    nq = queries.shape[0]
    n, d = vectors.shape
    ids = np.empty((nq, k), np.uint32)
    dists = np.empty((nq, k), np.float32)
    if n <= n_chunk:
        v, norms = _device_vectors(vectors)
        for s in range(0, nq, block):
            q_blk = queries[s : s + block].astype(np.float32)
            nb = q_blk.shape[0]
            if nb < block:  # pad to a fixed shape: one compiled program total
                q_blk = np.pad(q_blk, ((0, block - nb), (0, 0)))
            i, dd = _block_topk(jnp.asarray(q_blk), v, norms, 0, k, True)
            ids[s : s + block] = np.asarray(i[:nb]).astype(np.uint32)
            dists[s : s + block] = np.asarray(dd[:nb])
        return ids, dists

    n_chunks = -(-n // n_chunk)
    n_pad = n_chunks * n_chunk
    # keep the chunked table in the dataset's dtype (u8 stays 1 B/elt in HBM)
    vp = vectors
    if n_pad != n:
        pad = np.zeros((n_pad - n, d), dtype=vectors.dtype)
        vp = np.concatenate([vectors, pad], axis=0)
    vecs = jnp.asarray(vp.reshape(n_chunks, n_chunk, d))
    norms = np.empty(n_pad, np.float32)
    for s in range(0, n_pad, n_chunk):
        v64 = vp[s : s + n_chunk].astype(np.float64)
        norms[s : s + n_chunk] = (v64 * v64).sum(-1)
    norms[n:] = np.inf  # padding rows can never enter the top-k
    norms_d = jnp.asarray(norms.reshape(n_chunks, n_chunk))
    # progress per query block: at N=10M the staging plus the first block's
    # compile otherwise run with no output
    print(f"[gt] table staged ({n_pad * d / 1e9:.1f} GB, {n_chunks} chunks)",
          file=sys.stderr, flush=True)
    for s in range(0, nq, block):
        q_blk = queries[s : s + block].astype(np.float32)
        nb = q_blk.shape[0]
        if nb < block:
            q_blk = np.pad(q_blk, ((0, block - nb), (0, 0)))
        i, dd = _block_topk_chunked(jnp.asarray(q_blk), vecs, norms_d, k)
        ids[s : s + block] = np.asarray(i[:nb]).astype(np.uint32)
        dists[s : s + block] = np.asarray(dd[:nb])
        print(f"[gt] block {s // block + 1}/{-(-nq // block)}",
              file=sys.stderr, flush=True)
    return ids, dists


def build_knn_graph_jax(
    vectors: np.ndarray,
    r: int,
    n_random: int = 8,
    seed: int = 0,
    block: int = 1024,
) -> tuple[np.ndarray, np.ndarray]:
    """kNN + random-edge navigable graph, built on the accelerator.

    Same output contract as formats.synthetic.build_knn_graph.
    """
    n = vectors.shape[0]
    k_nn = r - n_random
    v, norms = _device_vectors(vectors)
    rng = np.random.default_rng(seed)
    adj = np.empty((n, r), dtype=np.int32)
    for s in range(0, n, block):
        blk = v[s : s + block]
        nb = blk.shape[0]
        if nb < block:
            blk = jnp.pad(blk, ((0, block - nb), (0, 0)))
        ids, _ = _block_topk(blk, v, norms, s, k_nn + 1, False)
        ids = np.asarray(ids)[:nb]
        rows = np.arange(s, min(s + block, n))
        # drop the self column (first hit is the point itself, possibly tied):
        # stable-sort "self" entries to the back, keep the first k_nn
        is_self = ids == rows[:, None]
        order = np.argsort(is_self, axis=1, kind="stable")
        adj[s : s + block, :k_nn] = np.take_along_axis(ids, order, axis=1)[:, :k_nn]
    if n_random > 0:
        adj[:, k_nn:] = rng.integers(0, n, size=(n, n_random), dtype=np.int32)
        self_hit = adj[:, k_nn:] == np.arange(n, dtype=np.int32)[:, None]
        adj[:, k_nn:][self_hit] = (adj[:, k_nn:][self_hit] + 1) % n
    from bang_jax.formats.synthetic import _dedup_rows_self

    adj = _dedup_rows_self(adj)
    degrees = np.full(n, r, dtype=np.int32)
    return adj, degrees


def build_pruned_knn_graph_jax(
    vectors: np.ndarray,
    r: int,
    k_base_factor: int = 3,
    alpha: float = 1.2,
    n_random: int = 4,
    seed: int = 0,
    block: int = 1024,
) -> tuple[np.ndarray, np.ndarray]:
    """Diversified (alpha-pruned) kNN graph, built on the accelerator.

    For each node: take the k_base_factor*r nearest neighbors, then apply the
    Vamana robust-prune occlusion rule in one batched jit pass to keep r
    diverse edges — long-range shortcut edges survive where plain kNN keeps
    only redundant same-cluster links. This is one extra fused step over
    plain-kNN and navigates dramatically better at equal degree; a few random
    edges guarantee global connectivity.
    """
    from bang_jax.formats.vamana import _robust_prune_batch

    n = vectors.shape[0]
    k_keep = r - n_random
    k_base = min(n - 1, k_base_factor * r)
    v, norms = _device_vectors(vectors)
    rng = np.random.default_rng(seed)
    adj = np.empty((n, r), dtype=np.int32)
    for s in range(0, n, block):
        blk = v[s : s + block]
        nb = blk.shape[0]
        if nb < block:
            blk = jnp.pad(blk, ((0, block - nb), (0, 0)))
        ids, dists = _block_topk(blk, v, norms, s, k_base + 1, False)
        rows_np = np.arange(s, s + block) % n
        is_self = np.asarray(ids) == rows_np[:, None]
        # keep non-self candidates (stable-sort self to the back)
        order = np.argsort(is_self, axis=1, kind="stable")
        cand_ids = np.take_along_axis(np.asarray(ids), order, axis=1)[:, :k_base]
        cand_dists = np.take_along_axis(np.asarray(dists), order, axis=1)[:, :k_base]

        cand_vecs = v[jnp.asarray(cand_ids)]  # [B, k_base, D] device gather
        sel_idx, sel_valid = _robust_prune_batch(
            blk,
            cand_vecs,
            jnp.asarray(cand_dists),
            jnp.ones((block, k_base), jnp.bool_),
            k_keep,
            alpha,
        )
        sel_idx = np.asarray(sel_idx)[:nb]
        sel_valid = np.asarray(sel_valid)[:nb]
        picked = np.take_along_axis(cand_ids[:nb], np.maximum(sel_idx, 0), axis=1)
        rows = np.arange(s, s + nb)
        adj[s : s + nb, :k_keep] = np.where(sel_valid, picked, rows[:, None])
    if n_random > 0:
        adj[:, k_keep:] = rng.integers(0, n, size=(n, n_random), dtype=np.int32)
        self_hit = adj[:, k_keep:] == np.arange(n, dtype=np.int32)[:, None]
        adj[:, k_keep:][self_hit] = (adj[:, k_keep:][self_hit] + 1) % n
    from bang_jax.formats.synthetic import _dedup_rows_self

    adj = _dedup_rows_self(adj)
    degrees = np.full(n, r, dtype=np.int32)
    return adj, degrees


@functools.partial(jax.jit, static_argnames=("iters",))
def _kmeans_chunks(train, init, iters):
    """Lloyd's k-means of each chunk, on the device. train [m, S, dmax] f32
    and init [m, 256, dmax] are zero-padded past each chunk's width (padding
    adds nothing to a distance). An empty cluster keeps its center."""
    hi = jax.lax.Precision.HIGHEST

    def one_chunk(args):
        x, c0 = args

        def body(_, c):
            d = (c * c).sum(-1)[None, :] - 2.0 * jnp.dot(x, c.T, precision=hi)
            onehot = jax.nn.one_hot(jnp.argmin(d, axis=1), c.shape[0])
            counts = onehot.sum(0)[:, None]
            sums = jnp.dot(onehot.T, x, precision=hi)
            return jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), c)

        return jax.lax.fori_loop(0, iters, body, c0)

    return jax.lax.map(one_chunk, (train, init))


def train_pq_jax(
    vectors: np.ndarray, m: int, kmeans_iters: int = 10, sample: int = 65536,
    seed: int = 0,
):
    """synthetic.train_pq with the k-means on the accelerator (same sample,
    chunking and initialisation; same PQData contract)."""
    from bang_jax.constants import PQ_NUM_CENTERS
    from bang_jax.formats.pq import PQData
    from bang_jax.formats.synthetic import default_chunk_offsets

    rng = np.random.default_rng(seed)
    data = vectors.astype(np.float32)
    centroid = data.mean(0)
    offsets = default_chunk_offsets(data.shape[1], m).astype(np.int64)
    if len(data) > sample:
        data = data[rng.choice(len(data), sample, replace=False)]
    train = data - centroid
    dmax = int((offsets[1:] - offsets[:-1]).max())
    chunks = np.zeros((m, len(train), dmax), np.float32)
    for c in range(m):
        chunks[c, :, : offsets[c + 1] - offsets[c]] = train[:, offsets[c] : offsets[c + 1]]
    init = chunks[:, rng.choice(len(train), PQ_NUM_CENTERS, replace=len(train) < PQ_NUM_CENTERS)]
    centers = np.asarray(_kmeans_chunks(jnp.asarray(chunks), jnp.asarray(init), kmeans_iters))
    pivots = np.zeros((PQ_NUM_CENTERS, data.shape[1]), np.float32)
    for c in range(m):
        pivots[:, offsets[c] : offsets[c + 1]] = centers[c, :, : offsets[c + 1] - offsets[c]]
    return PQData(pivots=pivots, centroid=centroid, chunk_offsets=offsets.astype(np.uint32))


@functools.partial(jax.jit, static_argnames=())
def _encode_block(chunk_data, piv_chunks):
    """chunk_data: [B, m, dmax]; piv_chunks: [m, 256, dmax] -> codes [B, m]."""
    d = (
        (piv_chunks * piv_chunks).sum(-1)[None]
        - 2.0
        * jnp.einsum(
            "bmt,mjt->bmj", chunk_data, piv_chunks, preferred_element_type=jnp.float32
        )
        + (chunk_data * chunk_data).sum(-1)[:, :, None]
    )
    return jnp.argmin(d, axis=-1).astype(jnp.uint8)


def encode_pq_jax(vectors: np.ndarray, pq, block: int = 65536) -> np.ndarray:
    """PQ-encode all vectors on the accelerator (same contract as
    synthetic.encode_pq)."""
    from bang_jax.ops.pq import prepare_pq_codebook

    cb = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)
    n = vectors.shape[0]
    m = cb.num_chunks
    codes = np.empty((n, m), np.uint8)
    dim_idx = np.asarray(cb.dim_idx)
    dim_mask = np.asarray(cb.dim_mask)
    for s in range(0, n, block):
        x = vectors[s : s + block].astype(np.float32) - pq.centroid
        nb = x.shape[0]
        if nb < block:
            x = np.pad(x, ((0, block - nb), (0, 0)))
        chunk_data = x[:, dim_idx] * dim_mask  # [B, m, dmax]
        codes[s : s + block] = np.asarray(
            _encode_block(jnp.asarray(chunk_data), cb.piv_chunks)
        )[:nb]
    return codes
