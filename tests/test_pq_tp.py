"""Chunk-sharded PQ distance must equal the single-device lookup."""

import jax.numpy as jnp
import numpy as np

from bang_jax.ops.pq import pq_lookup
from bang_jax.parallel.pq_tp import (
    pq_lookup_tp,
    shard_codes_by_chunk,
    shard_tables_by_chunk,
)
from bang_jax.parallel.sharded import make_mesh


def test_pq_lookup_tp_matches_single():
    rng = np.random.default_rng(0)
    q, r, m, n, shards = 16, 8, 32, 500, 8
    tables = jnp.asarray(rng.normal(size=(q, m, 256)).astype(np.float32))
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    cand = jnp.asarray(rng.integers(0, n, (q, r)).astype(np.int32))

    want = np.asarray(pq_lookup(tables, jnp.asarray(codes)[cand]))

    mesh = make_mesh(1, shards)
    ts = shard_tables_by_chunk(tables, shards)
    cs = jnp.asarray(shard_codes_by_chunk(codes, shards))
    got = np.asarray(pq_lookup_tp(mesh, ts, cs, cand))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
