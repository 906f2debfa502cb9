#!/usr/bin/env python3
"""Smoke test of bang_jax on the GPU at SIFT1M scale.

    python chip_smoke.py               # one card: build, three variants, kernel check
    python chip_smoke.py --four-cards  # the two multi-card paths on 4 cards
    python chip_smoke.py --n 100000    # a cut-down rehearsal

One card: a 1,000,000 x 128 uint8 SIFT-like corpus (ann-benchmarks' SIFT1M
shape) and 10,000 queries are generated from --seed. Ground truth (float32,
HIGHEST precision), a Vamana graph (R=64) and PQ codes (m=64) are built on
the device and written as an index bundle under bench_data/. The three
variants then run through the BANGSearch facade, each sweeping L until
recall@10 >= 0.90, and the PQ lookup kernel is compared with the plain XLA
lookup at full width.

--four-cards runs only the multi-card paths, each beside what it is compared
with: the chunk-sharded Base searcher on the same bundle against the
one-card Base searcher, and the node-sharded search over a (1, 4) mesh
against the same per-shard searches run on one card. Both are also scored
against brute force.

Every phase passes or raises. Nothing runs without a GPU. The last line of
stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

K = 10
TARGET_RECALL = 90.0
D, R, M = 128, 64, 64
N_QUERIES = 10_000
# L grids and operating points of bench.py (VARIANT_CONFIGS, sweep_base)
EXACT = dict(grid=(10, 12, 16, 20, 30, 40, 60, 100), beam_width=1, extra_iters=6)
INMEMORY = dict(
    grid=(11, 12, 14, 16, 20, 25, 30, 40, 60, 100, 160), beam_width=2,
    extra_iters=11,
)
BASE = dict(grid=(30, 45, 60, 90), beam_width=2, extra_iters=16)
# node-sharded corpus: its per-shard kNN graphs are built on the host, in
# O((N/4)^2) per shard (about half a minute per shard at this size)
SHARDED_N = 200_000
KERNEL_RTOL = 1e-5  # f32 tables: only the summation order differs


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device(devices) -> None:
    """Refuse to run anywhere but on a GPU: a CPU run would measure the
    wrong machine."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {platform!r}); nothing run"
        )


def make_corpus(n: int, n_queries: int, seed: int):
    """SIFT-like u8 corpus and u8 queries (perturbed corpus points), as
    bench.py's build_bundle makes them."""
    from bang_jax.formats.synthetic import make_clustered_data

    data = make_clustered_data(
        n, D, n_clusters=max(64, min(4096, n // 1000)), dtype=np.uint8, seed=seed
    )
    rng = np.random.default_rng(seed + 1)
    queries = data[rng.integers(0, n, n_queries)].astype(np.float32)
    queries += rng.normal(0, 2.0, queries.shape).astype(np.float32)
    return data, np.clip(np.rint(queries), 0, 255).astype(np.uint8)


def check_groundtruth(data, queries, gt_ids, gt_dists) -> float:
    """Device ground truth against a float64 brute force on the host (exact
    for u8 data). Returns the host's recall of the device's top-K."""
    from bang_jax.utils.recall import calculate_recall

    x = data.astype(np.float64)
    q = queries.astype(np.float64)
    d = (x * x).sum(1)[None, :] - 2.0 * (q @ x.T) + (q * q).sum(1)[:, None]
    part = np.argpartition(d, 100, axis=1)[:, :100]
    pd = np.take_along_axis(d, part, axis=1)
    order = np.argsort(pd, axis=1, kind="stable")
    host_ids = np.take_along_axis(part, order, axis=1)
    host_d = np.take_along_axis(pd, order, axis=1)
    np.testing.assert_allclose(gt_dists[:, :K], host_d[:, :K], rtol=1e-6)
    recall = calculate_recall(host_ids, gt_ids, K, host_d)
    if recall != 100.0:
        raise RuntimeError(f"device ground truth recall {recall} vs host float64")
    return recall


def build_bundle(prefix: str, n: int, seed: int):
    """Corpus, ground truth, Vamana graph and PQ, saved as an index bundle.
    Returns (queries, gt_ids, gt_dists)."""
    from bang_jax.formats.accel import (
        compute_groundtruth_jax,
        encode_pq_jax,
        train_pq_jax,
    )
    from bang_jax.formats.bin_io import save_bin, save_truthset
    from bang_jax.formats.graph import GraphIndex, save_graph_index
    from bang_jax.formats.pq import save_pq
    from bang_jax.formats.vamana import build_vamana_graph

    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        now = time.perf_counter()
        log(f"build {name}: {now - t:.1f} s")
        t = now

    data, queries = make_corpus(n, N_QUERIES, seed)
    stage(f"data ({n} x {D} u8, {N_QUERIES} queries)")
    gt_ids, gt_dists = compute_groundtruth_jax(data, queries.astype(np.float32), 100)
    stage("ground truth (f32, HIGHEST)")
    recall = check_groundtruth(data, queries[:100], gt_ids[:100], gt_dists[:100])
    stage(f"ground truth check (100 queries vs host float64: recall {recall})")
    adj, degrees, medoid = build_vamana_graph(
        data, r=R, l_build=48, alpha=1.44, batch=4096, seed=seed
    )
    stage(f"graph (Vamana R={R})")
    pq = train_pq_jax(data, M, seed=seed)
    pq.codes = encode_pq_jax(data, pq)
    stage(f"pq (m={M})")
    save_graph_index(prefix, GraphIndex(data, adj, degrees, medoid))
    save_pq(prefix, pq)
    save_bin(prefix + "_query.bin", queries)
    save_truthset(prefix + "_gt.bin", gt_ids, gt_dists)
    stage("save")
    return queries, gt_ids, gt_dists


def overlap(a, b) -> float:
    """Mean share of each row's top-K ids that two result sets share."""
    return float(np.mean([
        len(set(x[:K].tolist()) & set(y[:K].tolist())) / K for x, y in zip(a, b)
    ]))


def sweep(variant, prefix, queries, gt_ids, gt_dists, card, cfg, **extra):
    """BANGSearch lifecycle over cfg's L grid until recall@K reaches the
    target; returns the passing point. Raises if no L reaches it."""
    from bang_jax.api import BANGSearch
    from bang_jax.utils.recall import calculate_recall

    eng = BANGSearch(variant=variant)
    eng.bang_load(prefix)
    tag = variant + "".join(f" {k}={v}" for k, v in extra.items())
    try:
        for L in cfg["grid"]:
            eng.bang_set_searchparams(
                K, L, beam_width=cfg["beam_width"], extra_iters=cfg["extra_iters"],
                **extra,
            )
            t0 = time.perf_counter()
            eng.bang_alloc(len(queries))
            t_alloc = time.perf_counter() - t0
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                ids, _ = eng.bang_query(queries)
                walls.append(time.perf_counter() - t0)
            recall = calculate_recall(gt_ids, ids, K, gt_dists)
            if variant == "base":
                steps = f"device steps={eng._searcher.last_n_steps}"
            else:
                steps = f"iters={eng.last_stats.iters}"
            qps = len(queries) / float(np.median(walls))
            log(f"{tag} L={L}: recall@{K}={recall:.2f} {steps} "
                f"QPS={qps:,.0f} (median of 3 walls; {card}) "
                f"alloc+compile={t_alloc:.1f} s")
            if recall >= TARGET_RECALL:
                return {"L": L, "recall": recall, "qps": qps, "ids": ids}
        raise RuntimeError(
            f"{tag}: recall {recall:.2f} < {TARGET_RECALL} at the grid's last L={L}"
        )
    finally:
        eng.bang_unload()


def kernel_check(prefix, queries, gt_ids, inmem, card, seed, logdir):
    """The PQ lookup kernel against ops/pq.pq_lookup at full width, then both
    timed alone and inside the inmemory search (device time from a trace).
    Alone, the C = 2R candidates of each query are either uniform random
    points or the graph neighbors of its two nearest points (codes as
    clustered as a late traversal iteration sees them)."""
    import jax
    import jax.numpy as jnp

    from bang_jax.api import BANGSearch
    from bang_jax.formats.graph import load_graph_index
    from bang_jax.formats.pq import load_pq
    from bang_jax.ops.pq import pq_distance_tables, pq_lookup, prepare_pq_codebook
    from bang_jax.ops.pq_pallas import pq_lookup_pallas
    from bang_jax.utils.trace import trace_device_time

    pq = load_pq(prefix)
    cb = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)
    tables = pq_distance_tables(cb, jnp.asarray(queries, jnp.float32))
    q, c = len(queries), 2 * R  # beam 2 x R candidates per iteration
    cands = {
        "random": np.random.default_rng(seed + 2).integers(0, len(pq.codes), (q, c)),
        "neighbors": load_graph_index(prefix, mmap=True).adj[gt_ids[:, :2]].reshape(q, c),
    }
    lookups = {"xla": jax.jit(pq_lookup), "pallas": pq_lookup_pallas}
    for kind, cand in cands.items():
        codes = jnp.asarray(pq.codes[cand])
        got = np.asarray(lookups["pallas"](tables, codes))
        want = np.asarray(lookups["xla"](tables, codes))
        err = np.abs(got - want)
        rel = float((err / np.abs(want)).max())
        log(f"kernel pq_lookup_pallas vs pq_lookup at Q={q} m={M} C={c} {kind} "
            f"candidates (f32 tables, HIGHEST): max abs err {err.max():.3g}, max "
            f"rel err {rel:.3g} (tolerance rtol {KERNEL_RTOL}: f32 tables, only "
            "the summation order differs)")
        if not rel <= KERNEL_RTOL:
            raise RuntimeError(f"kernel relative error {rel} > {KERNEL_RTOL}")
        for impl in ("xla", "pallas", "pallas", "xla"):
            f = lookups[impl]
            t = trace_device_time(
                lambda: jax.block_until_ready(f(tables, codes)), 20,
                os.path.join(logdir, f"lookup_{kind}_{impl}"),
            )
            log(f"lookup alone, {kind} candidates [{impl}]: device busy "
                f"{t['busy_ms']:.4f} ms/call, kernels {t['kernels_ms']} ({card})")

    eng = BANGSearch(variant="inmemory")
    eng.bang_load(prefix)
    ids = {}
    try:
        for impl in ("xla", "pallas", "pallas", "xla"):
            eng.bang_set_searchparams(
                K, inmem["L"], beam_width=INMEMORY["beam_width"],
                extra_iters=INMEMORY["extra_iters"], pq_impl=impl,
            )
            eng.bang_alloc(len(queries))
            t0 = time.perf_counter()
            ids[impl], _ = eng.bang_query(queries)
            wall = time.perf_counter() - t0
            t = trace_device_time(
                lambda: eng.bang_query(queries), 3,
                os.path.join(logdir, f"inmemory_{impl}"),
            )
            log(f"inmemory L={inmem['L']} [{impl}]: wall {wall * 1e3:.2f} ms, "
                f"device busy {t['busy_ms']:.3f} ms/search of window "
                f"{t['window_ms']:.3f} ms, top kernels {t['kernels_ms']} ({card})")
    finally:
        eng.bang_unload()
    log(f"inmemory top-{K} ids shared by pq_impl=pallas and xla: "
        f"{overlap(ids['pallas'], ids['xla']):.4f}")


def gpu_tests() -> None:
    """The tests marked `gpu` (they skip on the CPU), in this process: a
    second process could not get the card's memory."""
    import pytest

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", tests])
    if rc != 0:
        raise RuntimeError(f"tests marked gpu failed (pytest exit code {rc})")


def one_card(prefix, queries, gt_ids, gt_dists, card, seed):
    from bang_jax import native

    gpu_tests()
    inmem = sweep("inmemory", prefix, queries, gt_ids, gt_dists, card, INMEMORY)
    for precision in ("highest", "default"):
        sweep("exactdistance", prefix, queries, gt_ids, gt_dists, card, EXACT,
              traversal_precision=precision)
    if not native.native_available():
        raise RuntimeError(
            "the native host gather (bang_jax/native) did not build; its numpy "
            "fallback must not stand in for it on the card"
        )
    log(f"base: native host gather built and used ({native._LIB_PATH})")
    sweep("base", prefix, queries, gt_ids, gt_dists, card, BASE)
    kernel_check(prefix, queries, gt_ids, inmem, card, seed,
                 os.path.join(os.path.dirname(prefix), "traces"))


def four_cards(prefix, queries, gt_ids, gt_dists, card, seed):
    """Correctness of the multi-card paths against one card and brute
    force; nothing here is timed."""
    import jax

    from bang_jax.formats.accel import compute_groundtruth_jax
    from bang_jax.models.base import BaseVariantSearcher
    from bang_jax.parallel.base_tp import ShardedBaseSearcher
    from bang_jax.parallel.partition import build_sharded_index
    from bang_jax.parallel.sharded import make_mesh, search_sharded
    from bang_jax.utils.config import SearchParams
    from bang_jax.utils.recall import calculate_recall

    devices = jax.devices()
    mesh = make_mesh(1, 4)

    # 1. chunk-sharded Base (codes split over 4 cards, psum) vs one card
    one = BaseVariantSearcher(prefix, n_pipeline_batches=4)
    four = ShardedBaseSearcher(prefix, mesh, n_pipeline_batches=4)
    for L in BASE["grid"]:
        params = SearchParams(L=L, k=K, beam_width=BASE["beam_width"],
                              extra_iters=BASE["extra_iters"])
        res = {name: s.search(queries, params)[0]
               for name, s in (("1 card", one), ("4 cards", four))}
        recalls = [calculate_recall(gt_ids, v, K, gt_dists) for v in res.values()]
        agree = overlap(res["1 card"], res["4 cards"])
        log(f"base L={L}: recall@{K} 1 card {recalls[0]:.2f}, 4 cards "
            f"{recalls[1]:.2f}; top-{K} ids shared {agree:.4f} ({card})")
        if min(recalls) >= TARGET_RECALL:
            break
    else:
        raise RuntimeError(f"chunk-sharded base: recall {recalls} < {TARGET_RECALL}")
    if agree < 0.98:
        raise RuntimeError(f"chunk-sharded base agrees with one card on {agree}")

    # 2. node-sharded search over a (1, 4) mesh vs the same shards on one card
    t0 = time.perf_counter()
    data_s, q_s = make_corpus(SHARDED_N, N_QUERIES, seed + 3)
    gi, gd = compute_groundtruth_jax(data_s, q_s.astype(np.float32), 100)
    si = build_sharded_index(data_s, n_shards=4, r=R, m=M, seed=seed)
    log(f"node-sharded index: N={SHARDED_N}, 4 shards of {si.n_local}, host "
        f"kNN graphs R={R}, PQ m={M}: {time.perf_counter() - t0:.1f} s")
    one_mesh = make_mesh(1, 1, devices=devices[:1])
    for L in (32, 64, 128):
        params = SearchParams(L=L, k=K, beam_width=INMEMORY["beam_width"],
                              extra_iters=INMEMORY["extra_iters"])
        ids4, _ = search_sharded(mesh, si, q_s, params)
        ids4 = np.asarray(ids4)
        parts = [
            search_sharded(one_mesh, shard_slice(si, s), q_s, params)
            for s in range(4)
        ]
        all_ids = np.concatenate([np.asarray(p[0]) for p in parts], axis=1)
        all_d = np.concatenate([np.asarray(p[1]) for p in parts], axis=1)
        ids1 = np.take_along_axis(all_ids, np.argsort(all_d, axis=1, kind="stable"), 1)
        r4 = calculate_recall(gi, ids4, K, gd)
        r1 = calculate_recall(gi, ids1, K, gd)
        agree = overlap(ids4, ids1)
        log(f"search_sharded L={L}: recall@{K} 4 cards {r4:.2f}, shards on one "
            f"card {r1:.2f}, top-{K} ids shared {agree:.4f}")
        if min(r4, r1) >= TARGET_RECALL:
            break
    else:
        raise RuntimeError(f"node-sharded search: recall {r4}, {r1} < {TARGET_RECALL}")
    if agree < 0.98:
        raise RuntimeError(f"node-sharded search agrees with one card on {agree}")


def shard_slice(si, s):
    """Shard s of a ShardedIndex as a one-shard index."""
    one = slice(s, s + 1)
    return si._replace(**{
        f: (None if getattr(si, f) is None else getattr(si, f)[one])
        for f in ("adj", "vectors", "vector_norms", "codes", "medoids", "id_base",
                  "nbr_codes", "fused_rows")
    })


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 cards")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="points in the main corpus")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    check_device(devices)
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} GPUs needed, {len(devices)} found")
    from bang_jax.utils.cache import enable_persistent_cache
    from bang_jax.utils.device import card_lines

    cache_dir = enable_persistent_cache()
    card = card_lines()
    log(f"device: {devices[0].device_kind} x{len(devices)}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache: {cache_dir}")

    here = os.path.dirname(os.path.abspath(__file__))
    prefix = os.path.join(here, "bench_data", "smoke", f"sift_n{args.n}_s{args.seed}")
    t0 = time.perf_counter()
    queries, gt_ids, gt_dists = build_bundle(prefix, args.n, args.seed)
    phase = four_cards if args.four_cards else one_card
    phase(prefix, queries, gt_ids, gt_dists, card, args.seed)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(f"nvidia-smi: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
