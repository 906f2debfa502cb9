"""Per-query bloom-filter visited sets.

Re-design of the reference's `neighbor_filtering_new` bloom filter
(BANG_Inmemory/parANN.cu:964-1046): each query owns BF_ENTRIES one-byte cells;
a node is "seen" iff both hash positions are set. Hashes are FNV-1a over the
node id's 4 bytes with two different offset bases (statistically equivalent to
the reference's two FNV variants; bit-level identity is not required — bloom
semantics only need false positives to be rare and false negatives absent).

Inserts are batched scatters with out-of-bounds drop for masked lanes; tests
are batched gathers. Arrays are uint8 [Q, BF]; a bit-packed Pallas variant is
a future optimization.
"""

from __future__ import annotations

import jax.numpy as jnp

from bang_jax.constants import BF_ENTRIES

_FNV_PRIME = jnp.uint32(16777619)
_FNV_BASIS_1 = jnp.uint32(2166136261)
_FNV_BASIS_2 = jnp.uint32(0x9747B28C)


def _fnv1a(ids: jnp.ndarray, basis: jnp.uint32) -> jnp.ndarray:
    """Vectorized FNV-1a over the 4 little-endian bytes of each uint32 id."""
    x = ids.astype(jnp.uint32)
    h = jnp.full_like(x, basis)
    for shift in (0, 8, 16, 24):
        byte = (x >> jnp.uint32(shift)) & jnp.uint32(0xFF)
        h = (h ^ byte) * _FNV_PRIME
    return h


def bloom_hashes(ids: jnp.ndarray, bf_entries: int = BF_ENTRIES):
    """Two hash positions in [0, bf_entries) for each id."""
    h1 = _fnv1a(ids, _FNV_BASIS_1) % jnp.uint32(bf_entries)
    h2 = _fnv1a(ids, _FNV_BASIS_2) % jnp.uint32(bf_entries)
    return h1.astype(jnp.int32), h2.astype(jnp.int32)


def bloom_query(bloom: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """seen[q, r] = both hash cells set. bloom: [Q, BF] u8; ids: [Q, R] i32."""
    h1, h2 = bloom_hashes(ids, bloom.shape[-1])
    b1 = jnp.take_along_axis(bloom, h1, axis=1)
    b2 = jnp.take_along_axis(bloom, h2, axis=1)
    return (b1 & b2) > 0


def bloom_insert(bloom: jnp.ndarray, ids: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Set both hash cells of masked ids; masked-out lanes scatter out of bounds
    and are dropped. Returns the updated [Q, BF] filter."""
    bf = bloom.shape[-1]
    h1, h2 = bloom_hashes(ids, bf)
    oob = jnp.int32(bf)
    idx = jnp.concatenate(
        [jnp.where(mask, h1, oob), jnp.where(mask, h2, oob)], axis=1
    )
    q = bloom.shape[0]
    rows = jnp.broadcast_to(jnp.arange(q, dtype=jnp.int32)[:, None], idx.shape)
    return bloom.at[rows, idx].set(jnp.uint8(1), mode="drop")
