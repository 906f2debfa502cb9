"""Exact visited-set filtering (dense alternative to the bloom filter).

The reference's visited set is a per-query bloom filter because random-access
bit arrays are cheap per CUDA thread. For a batched XLA program the natural
dedup is a dense vectorized membership test: a candidate is new iff it
appears in neither the current worklist nor the list of already-expanded
parents. This has zero false positives (slightly better recall than bloom at
equal work) and turns scatter/gather into compares that XLA fuses into a
single reduction.

A node that entered the worklist but was evicted before being expanded may
re-enter later; that wastes a worklist slot but is semantically harmless (the
reference's bloom filter instead blocks re-entry). Both modes are provided;
see SearchParams.visited_mode.
"""

from __future__ import annotations

import jax.numpy as jnp


def exact_new_mask(
    cand_ids: jnp.ndarray, wl_ids: jnp.ndarray, visited_ids: jnp.ndarray
) -> jnp.ndarray:
    """new[q, r] = cand not in worklist and not among expanded parents.

    cand_ids: [Q, R] i32; wl_ids: [Q, L] i32; visited_ids: [Q, MI] i32
    (INVALID_ID padding never matches valid candidates).
    """
    in_wl = (cand_ids[:, :, None] == wl_ids[:, None, :]).any(-1)
    in_vis = (cand_ids[:, :, None] == visited_ids[:, None, :]).any(-1)
    return ~(in_wl | in_vis)


def first_occurrence_mask(cand_ids: jnp.ndarray) -> jnp.ndarray:
    """True where cand_ids[q, j] is the first occurrence in its row.

    Generic O(C^2) variant — kept as the reference/oracle implementation for
    tests; the search path uses first_occurrence_mask_blocks (below), which
    exploits the beam-block structure for half the compares.
    """
    eq = cand_ids[:, :, None] == cand_ids[:, None, :]  # [Q, C, C]
    c = cand_ids.shape[1]
    earlier = jnp.tril(jnp.ones((c, c), jnp.bool_), k=-1)[None]
    return ~(eq & earlier).any(-1)


def first_occurrence_mask_blocks(cand_ids: jnp.ndarray, beam: int) -> jnp.ndarray:
    """first_occurrence_mask specialized to beam-expansion structure.

    Candidates come as `beam` per-parent blocks of width R; duplicates can
    only occur ACROSS blocks (adjacency rows are duplicate-free and their
    self-padding is filtered by the visited test). Comparing each block only
    against earlier blocks does beam*(beam-1)/2 * R^2 work instead of C^2 —
    half the compares at beam=2.
    """
    q, c = cand_ids.shape
    r = c // beam
    blocks = cand_ids.reshape(q, beam, r)
    mask = jnp.ones((q, beam, r), jnp.bool_)
    for b in range(1, beam):
        dup = (
            blocks[:, b, :, None] == blocks[:, :b].reshape(q, 1, b * r)
        ).any(-1)
        mask = mask.at[:, b].set(~dup)
    return mask.reshape(q, c)
