"""Chunk-sharded (tensor-parallel) PQ distance: codes split over the 'model'
mesh axis by PQ chunk.

Motivation: at billion scale the PQ codes alone nearly fill one card
(SIFT1B x 74 chunks = 74 GB; an H100 has 80 GB, of which a JAX process takes
60 GB by default). The reference fits them on an 80 GB A100
(bang_search.cu:232-240); here the *chunk* axis is sharded: device i holds
codes[:, i*m_loc:(i+1)*m_loc] and the matching slice of every query's
distance table, computes its partial lookup sum for the candidate batch, and
a `psum` over NVLink yields the full PQ distance. Communication per iteration
is just the [Q, R] partial-sum reduction — independent of m and N.

Composes with query data-parallelism: psum runs over 'model' only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from bang_jax.ops.pq import pq_lookup


def shard_codes_by_chunk(codes, n_shards: int):
    """[N, m] codes -> [S, N, m/S] stacked chunk shards (numpy)."""
    import numpy as np

    n, m = codes.shape
    assert m % n_shards == 0, "pad m to a multiple of the model axis"
    m_loc = m // n_shards
    return np.stack([codes[:, s * m_loc : (s + 1) * m_loc] for s in range(n_shards)])


def shard_tables_by_chunk(tables, n_shards: int):
    """[Q, m, 256] tables -> [S, Q, m/S, 256] stacked chunk shards."""
    q, m, c = tables.shape
    m_loc = m // n_shards
    return jnp.stack(
        [tables[:, s * m_loc : (s + 1) * m_loc] for s in range(n_shards)]
    )


def pq_lookup_tp(mesh: Mesh, tables_sharded, codes_sharded, cand_ids):
    """Distributed PQ lookup: out[q, r] = full-m distance, via partial sums.

    tables_sharded: [S, Q, m/S, 256]; codes_sharded: [S, N, m/S];
    cand_ids: [Q, R] (replicated). Returns [Q, R] f32 (replicated).
    """

    def per_device(tables, codes, cand):
        partial = pq_lookup(tables[0], codes[0][cand])  # local chunk slice
        return jax.lax.psum(partial, "model")

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("model"), P("model"), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(tables_sharded, codes_sharded, cand_ids)
