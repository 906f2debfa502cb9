"""Sampled entry-point selection — start each query near its target.

The reference enters every search at the dataset medoid
(bang_search.cu:466-506, parANN.cu:988-999): correct, but each query then
pays the full medoid->neighborhood walk, and traversal iterations ARE the
workload's unit of cost (each is an adjacency gather + distance pass +
merge). This module picks a per-query entry point by exact distance over a
small strided sample of the dataset: one [Q, S] matmul (~1 GFLOP at
Q=10K, S=1024, D=128) against a saving of several full traversal iterations.
An extension over the reference: the sample distances are one dense batched
matmul, which a one-block-per-query CUDA kernel has no cheap analog for.

Opt-in via SearchParams(entry_mode="sampled"); "medoid" preserves exact
reference behavior.
"""

from __future__ import annotations

import jax.numpy as jnp


def sampled_entry_ids(
    queries_f32: jnp.ndarray,
    vectors: jnp.ndarray,
    vector_norms: jnp.ndarray,
    n_samples: int,
) -> jnp.ndarray:
    """Per-query entry ids: nearest of a strided S-point sample. [Q] int32.

    The stride makes the sample deterministic and uniform over insertion
    order (ids carry no spatial meaning, so this is as good as random) —
    no RNG state, nothing stored in the index.
    """
    return sampled_entry_topb(queries_f32, vectors, vector_norms, n_samples, 1)[0][:, 0]


def sampled_entry_topb(
    queries_f32: jnp.ndarray,
    vectors: jnp.ndarray,
    vector_norms: jnp.ndarray,
    n_samples: int,
    b: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-B distinct sampled entries per query with their exact squared-L2
    distances: (ids [Q, B] int32, dists [Q, B] f32). B > 1 seeds every beam
    slot at init so the walk starts from B diverse good entries. Returning
    the distances (already computed by the selection matmul) lets the
    traversal seed its worklist without any extra per-query gather — the
    PQ variants' shared-medoid seeding trick does not generalize to
    per-query entries."""
    import jax

    n = vectors.shape[0]
    s = int(min(n_samples, n))
    stride = max(1, n // s)
    sample_ids = (jnp.arange(s, dtype=jnp.int32) * stride) % n
    sv = vectors[sample_ids].astype(jnp.float32)  # [S, D] tiny gather
    sn = vector_norms[sample_ids].astype(jnp.float32)
    # rank-only squared L2: |v|^2 - 2 q.v; add |q|^2 back for absolute dists
    d = sn[None, :] - 2.0 * (queries_f32 @ sv.T)
    qn = (queries_f32 ** 2).sum(-1, keepdims=True)
    if b == 1:
        idx = jnp.argmin(d, axis=1)[:, None]
    else:
        _, idx = jax.lax.top_k(-d, min(b, s))
    ids = sample_ids[idx]
    dists = jnp.take_along_axis(d, idx, axis=1) + qn
    if b > idx.shape[1]:  # degenerate tiny datasets: repeat the best entry
        pad = b - idx.shape[1]
        ids = jnp.concatenate(
            [ids, jnp.broadcast_to(ids[:, :1], (ids.shape[0], pad))], axis=1
        )
        dists = jnp.concatenate(
            [dists, jnp.broadcast_to(dists[:, :1], (dists.shape[0], pad))], axis=1
        )
    return ids, jnp.maximum(dists, 0.0)
