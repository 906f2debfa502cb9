"""BFS / reachability / warmup utilities."""

import numpy as np

from bang_jax.utils.graph_tools import bfs_from, reachable_fraction, warmup_touch


def ring_adj(n, r=2):
    adj = np.empty((n, r), np.int32)
    adj[:, 0] = (np.arange(n) + 1) % n
    adj[:, 1] = (np.arange(n) - 1) % n
    return adj


def test_bfs_ring():
    adj = ring_adj(10)
    order = bfs_from(adj, 0)
    assert len(order) == 10 and order[0] == 0
    assert set(order) == set(range(10))


def test_bfs_max_nodes():
    order = bfs_from(ring_adj(100), 5, max_nodes=7)
    assert len(order) == 7


def test_reachable_fraction_disconnected():
    adj = ring_adj(10)
    adj[4] = [3, 3]  # cut the ring one way
    adj[6] = [7, 7]
    frac = reachable_fraction(adj, 0)
    assert 0 < frac <= 1.0


def test_warmup_touch(tiny_index):
    from bang_jax.models.index import device_index_from_files

    index = device_index_from_files(
        tiny_index["prefix"], variant="inmemory", neighbor_codes=True
    )
    touched = warmup_touch(index, n_nodes=500)
    assert touched == 500
    # neighbor_codes-mode indexes carry byte-plane adjacency, not the i32 table
    from bang_jax.ops.adjacency import decode_adj_planes

    adj = (np.asarray(decode_adj_planes(index.adj_planes))
           if index.adj is None else np.asarray(index.adj))
    assert reachable_fraction(adj, index.medoid) > 0.99


def test_warmup_touch_base_variant(tiny_index):
    """Base variant: BFS must walk the host-mmap graph (no device adj)."""
    from bang_jax.models.base import BaseVariantSearcher

    searcher = BaseVariantSearcher(tiny_index["prefix"])
    touched = warmup_touch(searcher, n_nodes=400)
    assert touched == 400
