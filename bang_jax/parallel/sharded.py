"""Multi-chip search: shard_map over a (data, model) device mesh.

Two composable strategies (both extensions over the single-GPU reference;
XLA hands the collectives to NCCL):

  * data parallelism — queries sharded over the 'data' axis; every device
    row processes its own query slice (the reference's one-block-per-query
    batching, lifted across chips);
  * index (model) parallelism — the dataset sharded over the 'model' axis as
    independent sub-indices (see parallel/partition.py); each device searches
    its shard for its query slice, then per-shard top-k candidate lists are
    all-gathered over 'model' and merged with a final top-k. The merge is the
    only communication: k ids + k f32 distances per query per shard.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bang_jax.models.traversal import (
    make_exact_distance_fn,
    make_pq_distance_fn,
    rerank_topk,
    run_traversal,
)
from bang_jax.utils.config import SearchParams


def make_mesh(data: int, model: int, devices=None) -> Mesh:
    """(data, model) mesh with Auto axis types (works for both shard_map and
    auto-partitioned jit)."""
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= data * model, (
        f"need {data * model} devices, have {len(devices)}"
    )
    dev_grid = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(dev_grid, ("data", "model"))


def _local_search(
    adj, vectors, norms, codes, nbr_codes, fused_rows, codebook, medoid,
    id_base, queries,
    *, l, k, max_iters, use_bloom, beam=1, pq_impl="auto", rerank=True,
):
    """Search one shard for one query slice; returns global-id top-k.

    Runs the same tuned configuration as the single-chip engines: the fused
    frontier rows / neighbor-aligned nbr_codes layouts (when the sharded
    index carries them) and the requested pq_impl flow through to
    make_pq_distance_fn, and rerank is honored instead of being forced on.
    """
    q = queries.shape[0]
    queries_f32 = queries.astype(jnp.float32)
    if codes is not None:
        distance_fn = make_pq_distance_fn(
            queries_f32, codebook, codes, impl=pq_impl, nbr_codes=nbr_codes,
            fused_rows=fused_rows,
        )
    else:
        distance_fn = make_exact_distance_fn(queries_f32, vectors, norms)
    final = run_traversal(adj, distance_fn, medoid, q, l, max_iters, use_bloom, beam)
    if rerank or codes is None:
        ids, dists = rerank_topk(queries_f32, vectors, norms, final.visited_ids, k)
    else:
        ids, dists = final.wl_ids[:, :k], final.wl_dist[:, :k]
    # INVALID_ID padding must not collide with real global ids after offset
    ids = jnp.where(ids < 0, ids, ids + id_base)
    return ids, dists


def search_sharded(
    mesh: Mesh,
    sharded_index,
    queries: np.ndarray,
    params: SearchParams,
):
    """Search a node-sharded index over the mesh.

    queries are sharded over 'data'; the index over 'model'; results are the
    global top-k per query, merged across shards. Returns (ids [Q, k] i32,
    dists [Q, k] f32) with 'data'-sharded layout.
    """
    si = sharded_index
    n_model = mesh.shape["model"]
    assert si.n_shards == n_model, (si.n_shards, n_model)
    use_bloom = params.visited_mode == "bloom"

    def per_device(adj, vectors, norms, codes, nbr_codes, fused_rows, medoids,
                   id_base, queries):
        # leading shard axis is size 1 inside the shard_map body
        ids, dists = _local_search(
            adj[0],
            vectors[0],
            norms[0],
            None if codes is None else codes[0],
            None if nbr_codes is None else nbr_codes[0],
            None if fused_rows is None else fused_rows[0],
            si.codebook,
            medoids[0],
            id_base[0],
            queries,
            l=params.L,
            k=params.k,
            max_iters=params.max_iters,
            use_bloom=use_bloom,
            beam=params.beam_width,
            pq_impl=params.pq_impl,
            rerank=params.rerank,
        )
        # gather all shards' candidates and merge: [S, q_loc, k] → top-k
        all_ids = jax.lax.all_gather(ids, "model")
        all_dists = jax.lax.all_gather(dists, "model")
        q_loc = queries.shape[0]
        flat_ids = jnp.moveaxis(all_ids, 0, 1).reshape(q_loc, -1)
        flat_dists = jnp.moveaxis(all_dists, 0, 1).reshape(q_loc, -1)
        neg, idx = jax.lax.top_k(-flat_dists, params.k)
        return jnp.take_along_axis(flat_ids, idx, axis=1), -neg

    shard_spec = P("model")
    nbr_codes = getattr(si, "nbr_codes", None)
    fused_rows = getattr(si, "fused_rows", None)
    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(
            P("model"), P("model"), P("model"),
            None if si.codes is None else P("model"),
            None if nbr_codes is None else P("model"),
            None if fused_rows is None else P("model"),
            shard_spec, shard_spec, P("data"),
        ),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )
    return fn(
        jnp.asarray(si.adj),
        jnp.asarray(si.vectors),
        jnp.asarray(si.vector_norms),
        None if si.codes is None else jnp.asarray(si.codes),
        None if nbr_codes is None else jnp.asarray(nbr_codes),
        None if fused_rows is None else jnp.asarray(fused_rows),
        jnp.asarray(si.medoids),
        jnp.asarray(si.id_base),
        jnp.asarray(queries),
    )


def search_data_parallel(mesh: Mesh, index, queries: np.ndarray, params: SearchParams):
    """Pure query-data-parallel search of a replicated in-memory index.

    The index pytree is replicated on every device; queries are sharded over
    'data'. XLA partitions the existing single-chip program automatically.
    """
    from bang_jax.models.inmemory import _search_inmemory_jit

    q_sharding = NamedSharding(mesh, P("data"))
    replicated = NamedSharding(mesh, P())
    queries_d = jax.device_put(jnp.asarray(queries), q_sharding)
    index_d = jax.tree.map(lambda x: jax.device_put(x, replicated), index._asdict())
    from bang_jax.models.index import DeviceIndex

    index_r = DeviceIndex(**index_d)
    ids, dists, _it, _ne, _nd = _search_inmemory_jit(
        index_r.adj,
        index_r.vectors,
        index_r.vector_norms,
        index_r.codes,
        index_r.nbr_codes,
        index_r.codebook,
        queries_d,
        medoid=index.medoid,
        l=params.L,
        k=params.k,
        max_iters=params.max_iters,
        use_bloom=params.visited_mode == "bloom",
        fused_rows=index_r.fused_rows,
        adj_planes=index_r.adj_planes,
        rerank=params.rerank,
        pq_impl=params.pq_impl,
        beam=params.beam_width,
    )
    return ids, dists
