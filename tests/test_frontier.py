"""Fused frontier rows (ops/pq.pack_frontier_rows) and their XLA decode."""

import jax.numpy as jnp
import numpy as np
import pytest

from bang_jax.ops.pq import frontier_decode_xla, pack_frontier_rows

N = 70_000  # > 65,536: ids use byte-plane 2


def _numpy_decode(rows, m, r):
    """Reference decode of gathered rows [Q, P, 4r + m*r]."""
    q, p, _ = rows.shape
    planes = rows[:, :, : 4 * r].astype(np.int64).reshape(q, p, 4, r)
    ids = sum(planes[:, :, b] << (8 * b) for b in range(4)).reshape(q, p * r)
    codes = rows[:, :, 4 * r :].reshape(q, p, m, r).transpose(0, 1, 3, 2)
    return ids.astype(np.int32), codes.reshape(q, p * r, m)


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("r", [24, 32, 64, 96])
def test_frontier_decode_matches_numpy(r, beam):
    m = 8
    rng = np.random.default_rng(r + beam)
    adj = rng.integers(0, N, (N, r)).astype(np.int32)
    adj[:, 0] = N - 1 - np.arange(N)  # every row holds an id above 65,535
    codes = rng.integers(0, 256, (N, m)).astype(np.uint8)
    table = pack_frontier_rows(adj, codes)
    assert table.shape == (N, 4 * r + m * r)
    parents = rng.integers(0, N, (16, beam))
    rows = table[parents]
    ids, cand_codes = frontier_decode_xla(jnp.asarray(rows), m, r)
    want_ids, want_codes = _numpy_decode(rows, m, r)
    np.testing.assert_array_equal(np.asarray(ids), want_ids)
    np.testing.assert_array_equal(np.asarray(cand_codes), want_codes)
    # and the decode is the graph: ids are the parents' adjacency rows,
    # codes are those neighbors' codes
    np.testing.assert_array_equal(want_ids, adj[parents].reshape(16, beam * r))
    np.testing.assert_array_equal(want_codes, codes[adj[parents].reshape(16, -1)])
