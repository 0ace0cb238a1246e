#!/usr/bin/env python
"""Smoke test of the main path on one GPU: build an index, serve k-NN.

Stand-in data with the shape of ann-benchmarks' deep-image-96-angular,
made on the device from ``--seed``: 9,990,000 train rows x 96 and 10,000
test queries, clustered (c = n/1000 centres, sigma 0.05) and
unit-normalised. Phases, each printed as one JSON line with its seconds:

1. device       — the platform must be ``gpu``; card name, power limit
2. build        — ``build_index_fused(train, leaf_size=16)``: compile and
                  build seconds, memory analysis, ``locate`` exactness on
                  4,096 stored rows; a 1M x 4 tree eps-ball check
3. serve_full   — ``PackedServer`` over ``pack_database(metric="cosine")``
                  on all test queries: recall@10 against the exact oracle,
                  f32 distance check
4. serve_pruned — ``probes=`` at two values; ``probes >= num_blocks``
                  must return the full scan's rows exactly
5. kernel_ref   — the GPU scan kernel against the plain XLA scan at
                  9.99M x 96 (full and pruned), 1M x 768, 3M x 768 (past
                  2^31 packed elements; full and pruned), 100k x 1536
6. routes       — both scan routes timed through ``PackedServer``, full
                  and pruned, in turns A B B A
7. mutable      — ``DynamicIndex`` over the corpus, +10k / -10k rows
8. out_of_core  — ``ChunkedIndex`` over a 2M x 96 ``NativeVectorStore``

``--four`` runs only the four-card paths (sharded scan, full and pruned,
and the sharded build) and compares them with one card's results from
the same run.

The second-to-last line is ``nvidia-smi``'s card name and power limit;
the last is ``{"ok": true, "device": {...}}``. A failed check raises, so
the script exits non-zero and prints no result line.

    python chip_smoke.py [--four] [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K = 10
BATCH = 4096
Q_TILE = 512
# Set only by tests/test_chip_smoke.py, a dry run of every phase on the
# CPU at tiny sizes: accepts the CPU backend and runs the GPU kernel in
# the Pallas interpreter. Never set when the script runs.
_REHEARSE = False


_COMPILE = {"timer": None, "seen": 0.0}


def log(phase, t0=None, **fields):
    if t0 is not None:
        fields["seconds"] = time.perf_counter() - t0
    timer = _COMPILE["timer"]
    if timer is not None:  # XLA compile seconds since the previous line
        fields["compile_s"] = timer.total - _COMPILE["seen"]
        _COMPILE["seen"] = timer.total
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    """Card name and power limit, read by a child that does not use JAX."""
    if _REHEARSE:
        return "rehearsal, no GPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def clustered(key, n, q, d):
    """``(rows [n, d], queries [q, d])`` made on the device: clustered
    around c = n/1000 shared centres with sigma 0.05, unit-normalised."""
    import jax
    import jax.numpy as jnp

    c = max(64, n // 1000)
    kc, kr, kq = jax.random.split(key, 3)
    centers = jax.random.uniform(kc, (c, d), jnp.float32) * 2 - 1

    def draw(k, size):
        ka, kn = jax.random.split(k)
        v = centers[jax.random.randint(ka, (size,), 0, c)]
        v = v + 0.05 * jax.random.normal(kn, (size, d), jnp.float32)
        return v / jnp.linalg.norm(v, axis=1, keepdims=True)

    return draw(kr, n), draw(kq, q)


def recall(rows, truth) -> float:
    rows = np.asarray(rows)[: truth.shape[0]]
    hits = sum(len(set(r.tolist()) & set(t.tolist()))
               for r, t in zip(rows, truth))
    return hits / truth.size


def median_ms(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


class CompileTimer:
    """Sums the XLA backend compile seconds JAX reports."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration


_XLA_ENTRIES: dict = {}


@contextlib.contextmanager
def route(name):
    """Serve through scan route ``name`` inside the block. For "xla" the
    module's jitted entries are swapped for separate ones over distinct
    function objects, so the two routes share no traced or compiled
    program."""
    import functools

    import jax
    from vector_database_tpu.ops import pallas_knn as pk

    if name == "triton":
        yield
        return
    if not _XLA_ENTRIES:
        _XLA_ENTRIES["full"] = jax.jit(
            functools.partial(pk._scan_knn_packed_impl),
            static_argnames=("k", "q_tile", "oversample", "probes",
                             "probes_max", "interpret"))
        _XLA_ENTRIES["rt"] = jax.jit(
            functools.partial(pk._scan_knn_packed_rt_entry),
            static_argnames=("k", "probes_max", "q_tile", "oversample",
                             "interpret"))
    with mock.patch.object(pk, "scan_route", lambda platform=None: "xla"), \
            mock.patch.object(pk, "pallas_scan_knn_packed",
                              _XLA_ENTRIES["full"]), \
            mock.patch.object(pk, "pallas_scan_knn_packed_rt",
                              _XLA_ENTRIES["rt"]):
        yield


def scan_acc(pack, queries, name, probes=None):
    """``[Q, m]`` bucket minima of scan route ``name`` for ``queries``
    (pruned over ``probes`` blocks per tile when given)."""
    import jax
    import jax.numpy as jnp
    from vector_database_tpu.ops import pallas_knn as pk

    def f(pack, queries):
        q, d = queries.shape
        qp = jnp.pad(queries, ((0, (-q) % Q_TILE),
                               (0, pack.vb.shape[1] - d)))
        bmap = nprobe = None
        if probes is not None:
            qp, bmap, nprobe, _ = pk._select_blocks(
                pack, queries, qp, probes=probes, probes_rt=probes,
                q_tile=Q_TILE)
        return pk._bucket_scan(
            pack.vn, pack.vb, qp.astype(jnp.bfloat16), bmap, nprobe,
            bits=pack.bits, m=pack.m, q_tile=Q_TILE,
            interpret=_REHEARSE and name == "triton")

    with mock.patch.object(pk, "scan_route",
                           lambda platform=None: name):
        return np.asarray(jax.jit(f)(pack, queries))


def compare_routes(pack, queries, label, probes=None):
    """The kernel against the plain XLA scan: bucket minima within
    2^-(23-bits) relative + 1e-5, >= 99.9% identical returned rows, equal
    f32 distances where rows agree."""
    from vector_database_tpu.ops import pallas_knn as pk

    t0 = time.perf_counter()
    ax = scan_acc(pack, queries, "xla", probes)
    at = scan_acc(pack, queries, "triton", probes)
    tol = 2.0 ** -(23 - pack.bits)
    err = np.abs(ax - at)
    check(bool(np.all(err <= tol * np.abs(ax) + 1e-5)),
          f"{label}: bucket minima differ beyond tolerance "
          f"(max rel {float((err / np.abs(ax)).max())})")
    kw = dict(k=K, q_tile=Q_TILE, interpret=_REHEARSE)
    if probes is not None:
        kw["probes"] = probes
    with route("xla"):
        rx, dx = (np.asarray(a) for a in pk.pallas_scan_knn_packed(
            pack, queries, **{**kw, "interpret": False}))
    rt, dt = (np.asarray(a) for a in pk.pallas_scan_knn_packed(
        pack, queries, **kw))
    same = rx == rt
    check(same.mean() >= 0.999,
          f"{label}: only {same.mean():.5f} of row slots agree")
    check(np.array_equal(dx[same], dt[same]),
          f"{label}: rerank distances differ where rows agree")
    log("kernel_ref", t0, shape=label, probes=probes,
        max_rel_diff=float((err / np.maximum(np.abs(ax), 1e-30)).max()),
        tol_rel=tol, rows_same=float(same.mean()))


def phase_build(jax, jnp, train, n, timer):
    from vector_database_tpu import build_index_fused, exact_ball, locate
    from vector_database_tpu import search
    from vector_database_tpu.ops.sorted_build import (
        segment_capacity,
        sorted_build,
    )

    # the one program build_index_fused runs, compiled on its own first
    # (the same arguments build_index_fused passes for leaf_size=16)
    t0 = time.perf_counter()
    comp = sorted_build.lower(
        train, jnp.arange(n, dtype=jnp.int32), jnp.int32(n),
        s_max=segment_capacity(n, 16), m_max=2 * n, leaf_size=16,
        max_levels=n + 64, stats_subsample=4 if n > 500_000 else 1,
        tie_break="positional", progress_cb=None, split="alternate",
        id_limb_bits=7, id_limbs=5,
    ).compile()
    compile_s = time.perf_counter() - t0
    c0 = timer.total
    t0 = time.perf_counter()
    index = build_index_fused(train, leaf_size=16)
    index.vectors.block_until_ready()
    build_s = time.perf_counter() - t0
    log("build", n=n, d=int(train.shape[1]), program_compile_s=compile_s,
        build_s=build_s, compile_s_inside_build=timer.total - c0,
        depth=index.depth, leaves=index.num_leaves,
        memory_analysis=str(comp.memory_analysis()),
        peak_bytes_in_use=(jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"))
    del comp

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    rows = np.sort(rng.choice(n, size=min(4096, n), replace=False))
    got = np.asarray(locate(index, train[jnp.asarray(rows)]))
    check(np.array_equal(got, rows),
          f"locate: {(got != rows).sum()} of {rows.size} stored rows "
          "not found")
    log("build_locate", t0, rows=int(rows.size))

    # eps-ball on low-dimensional data, where the tree prunes
    t0 = time.perf_counter()
    kb = jax.random.PRNGKey(7)
    nb_rows = 1_000_000 if not _REHEARSE else 20_000
    ball = jax.random.uniform(kb, (nb_rows, 4), jnp.float32) * 2 - 1
    bq = jax.random.uniform(jax.random.fold_in(kb, 1), (256, 4),
                            jnp.float32) * 2 - 1
    bidx = build_index_fused(ball, leaf_size=16)
    radius = 0.1
    res = search(bidx, bq, radius)
    truth = np.asarray(exact_ball(ball, bq, radius))
    host, qh = np.asarray(ball, np.float64), np.asarray(bq, np.float64)
    band = 1e-6  # relative band around the radius where f32 may differ
    matches = 0
    for i in range(bq.shape[0]):
        got = set(res.match_rows(i).tolist())
        want = set(np.nonzero(truth[i])[0].tolist())
        matches += len(want)
        for r in got ^ want:
            d = float(np.sqrt(((host[r] - qh[i]) ** 2).sum()))
            check(abs(d - radius) <= band * radius,
                  f"eps-ball query {i}: row {r} at distance {d} differs "
                  "from the exact oracle outside the radius band")
    log("build_eps_ball", t0, n=nb_rows, d=4, queries=256, radius=radius,
        matches=matches, radius_band_rel=band)
    del bidx, ball
    return index


def phase_serve(jax, jnp, index, test, truth_q):
    from vector_database_tpu import PackedServer, exact_knn, pack_database

    t0 = time.perf_counter()
    pack = pack_database(index.vectors, metric="cosine")
    pack.vb.block_until_ready()
    nb = int(pack.vb.shape[0])
    log("pack", t0, blocks=nb, block=pack.block, buckets=pack.m,
        d_pad=int(pack.vb.shape[1]))

    t0 = time.perf_counter()
    truth = np.asarray(exact_knn(pack.vectors, test[:truth_q], k=K)[0])
    log("oracle", t0, queries=truth_q)

    t0 = time.perf_counter()
    srv = PackedServer(pack, k=K, batch=BATCH)
    srv.warmup()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, d2 = srv.query(np.asarray(test))
    serve_s = time.perf_counter() - t0
    check(rows.shape == (test.shape[0], K), f"rows shape {rows.shape}")
    check(bool(np.isfinite(d2).all()), "non-finite distances")
    r_full = recall(rows, truth)
    check(r_full >= 0.95, f"full-scan recall@10 {r_full} < 0.95")
    vec = np.asarray(pack.vectors)
    qn = np.asarray(test, np.float32)
    qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
    ref = ((vec[rows] - qn[:, None, :]) ** 2).sum(-1, dtype=np.float32)
    check(np.allclose(d2, ref, rtol=1e-5, atol=0),
          "returned distances differ from the f32 recomputation: max rel "
          f"{float((np.abs(d2 - ref) / np.maximum(ref, 1e-30)).max())}")
    log("serve_full", queries=int(test.shape[0]), warmup_s=warm,
        seconds=serve_s, qps=test.shape[0] / serve_s,
        recall_at_10=r_full, truth_queries=truth_q)

    probes = [p for p in (128, 256) if p < nb] or [max(1, nb // 2)]
    t0 = time.perf_counter()
    psrv = PackedServer(pack, k=K, batch=BATCH, probes=probes[0],
                        probes_max=nb)
    psrv.warmup()
    for p in probes:
        psrv.set_probes(p)
        t1 = time.perf_counter()
        prow, _ = psrv.query(np.asarray(test))
        log("serve_pruned", t1, probes=p, blocks=nb,
            recall_at_10=recall(prow, truth),
            recall_vs_full=recall(prow, rows[:truth_q]))
    psrv.set_probes(nb)
    prow, pd2 = psrv.query(np.asarray(test))
    check(np.array_equal(prow, rows),
          f"probes >= num_blocks: {(prow != rows).sum()} slots differ "
          "from the full scan")
    check(np.array_equal(pd2, d2), "probes >= num_blocks: distances differ")
    log("serve_pruned_all_blocks", t0, probes=nb, equal_to_full=True)
    return pack, rows, truth, probes


def phase_routes(pack, test, probes, reps):
    """Both scan routes through PackedServer, A B B A, full and pruned."""
    from vector_database_tpu import PackedServer

    nb = int(pack.vb.shape[0])
    batch = np.asarray(test[:BATCH])
    out = {}
    for mode, kw in (("full", {}),
                     ("pruned", dict(probes=probes, probes_max=nb))):
        legs = {}
        for name in ("xla", "triton", "triton", "xla"):
            with route(name):
                srv = PackedServer(pack, k=K, batch=BATCH,
                                   interpret=_REHEARSE and name == "triton",
                                   **kw)
                srv.warmup()  # every shape warmed before its leg
                legs.setdefault(name, []).append(
                    median_ms(lambda: srv.query(batch), reps))
        out[mode] = legs
        log("routes", mode=mode, probes=kw.get("probes"), q=BATCH,
            batches_per_leg=reps,
            ms_per_batch={k: v for k, v in legs.items()})
    return out


def phase_mutable(jax, jnp, train_host, seed):
    from vector_database_tpu import DynamicIndex

    t0 = time.perf_counter()
    steps = {}

    def step(name, t):
        steps[name] = time.perf_counter() - t
        return time.perf_counter()

    n = train_host.shape[0]
    dyn = DynamicIndex(train_host, leaf_size=16)
    t = step("construct", t0)
    rng = np.random.default_rng(seed + 5)
    extra = np.asarray(clustered(jax.random.PRNGKey(seed + 5), 10_000, 0,
                                 train_host.shape[1])[0])
    added = dyn.add(extra)
    t = step("add", t)
    removed = rng.choice(n, size=10_000, replace=False)
    check(dyn.remove_ids(removed) == removed.size, "remove_ids count")
    t = step("remove", t)
    probe = rng.choice(added.size, size=1024, replace=False)
    ids, _ = dyn.knn(extra[probe], k=K, packed=True)
    t = step("knn_first", t)
    check(np.array_equal(ids[:, 0], added[probe]),
          f"{(ids[:, 0] != added[probe]).sum()} added rows are not their "
          "own nearest neighbour")
    gone = set(removed.tolist())
    rq = train_host[removed[:1024]]
    rids, _ = dyn.knn(rq, k=K, packed=True)
    step("knn_second", t)
    hit = [int(i) for i in np.concatenate([ids.ravel(), rids.ravel()])
           if int(i) in gone]
    check(not hit, f"removed rows returned: {hit[:5]}")
    log("mutable", t0, rows=n, added=int(added.size),
        removed=int(removed.size), live=len(dyn), step_seconds=steps)


def phase_out_of_core(jax, jnp, seed):
    from vector_database_tpu import ChunkedIndex, exact_knn
    from vector_database_tpu.runtime.native_store import NativeVectorStore

    t0 = time.perf_counter()
    n, d = (2_000_000, 96) if not _REHEARSE else (40_000, 96)
    rows, qs = (np.asarray(a) for a in
                clustered(jax.random.PRNGKey(seed + 9), n, 1024, d))
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        store = NativeVectorStore.create(os.path.join(work, "rows.vs"), d,
                                         capacity_rows=n)
        store.append(rows)
        idx = ChunkedIndex.from_store(store, chunk_rows=n // 4,
                                      leaf_size=16)
        check(idx.num_chunks == 4, f"{idx.num_chunks} chunks")
        got, _ = idx.knn(qs, k=K, host_rerank=True)
        truth = np.asarray(exact_knn(jnp.asarray(rows), jnp.asarray(qs),
                                     k=K)[0])
        r = recall(got, truth)
        check(r >= 0.95, f"out-of-core recall@10 {r} < 0.95")
        store.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("out_of_core", t0, rows=n, chunks=4, queries=int(qs.shape[0]),
        recall_at_10=r)


def run_one(args, jax, jnp, timer):
    n = args.n
    key = jax.random.PRNGKey(args.seed)
    t0 = time.perf_counter()
    train, test = clustered(key, n, args.q, 96)
    train.block_until_ready()
    log("data", t0, train=list(train.shape), test=list(test.shape))

    from vector_database_tpu import pack_database

    index = phase_build(jax, jnp, train, n, timer)
    pack, rows, truth, probes = phase_serve(jax, jnp, index, test,
                                            args.truth_q)

    tq = test[:BATCH]
    compare_routes(pack, tq, f"{n}x96")
    compare_routes(pack, tq, f"{n}x96", probes=probes[-1])
    for wn, wd in ((1_000_000, 768), (3_000_000, 768), (100_000, 1536)):
        # 3M x 768 packs past 2^31 bf16 elements (64-bit kernel offsets)
        big = wn * wd > 2**31
        if _REHEARSE:
            wn //= 100
        wv, wq = clustered(jax.random.PRNGKey(args.seed + wd + wn), wn,
                           BATCH, wd)
        wpack = pack_database(wv)
        del wv
        compare_routes(wpack, wq, f"{wn}x{wd}")
        if big:
            check(_REHEARSE or wpack.vb.size > 2**31,
                  f"{wn}x{wd}: pack is not past 2^31 elements")
            compare_routes(wpack, wq, f"{wn}x{wd}",
                           probes=max(1, wpack.vb.shape[0] // 4))
        del wpack
    phase_routes(pack, test, probes[-1], args.reps)

    del pack, index
    train_host = np.asarray(train)
    del train
    phase_mutable(jax, jnp, train_host, args.seed)
    del train_host
    phase_out_of_core(jax, jnp, args.seed)


def run_four(args, jax, jnp):
    """Sharded scan and sharded build on a 4-card mesh, against one card.

    The sharded scan must return the rows that one card computes for the
    same four row shards (each shard scanned on its own, merged top-k), in
    >= 99.9% of slots, and a recall against the exact oracle no lower
    than one card's unsharded full scan (each shard has its own m buckets,
    so the sharded scan collides less than the unsharded one). The same
    holds for the pruned scan (``probes=``, against one card's pruned
    scans of the shards); with every block probed it must return exactly
    the full sharded scan's rows."""
    from vector_database_tpu import build_index_fused, exact_ball, exact_knn
    from vector_database_tpu import locate, pack_database
    from vector_database_tpu import pallas_scan_knn_packed
    from vector_database_tpu.parallel import (
        build_index_sharded,
        make_mesh,
        pack_database_sharded,
        search_global,
        sharded_scan_knn,
        to_bsp,
    )
    from vector_database_tpu.parallel.forest import merge_topk

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    n = args.n
    t0 = time.perf_counter()
    train, test = clustered(jax.random.PRNGKey(args.seed), n, BATCH, 96)
    train.block_until_ready()
    log("data", t0, train=list(train.shape), test=list(test.shape))

    # serve the leaf-major layout a deployment serves (the tree's row
    # order gives pruning its block locality); ids are leaf-major rows
    t0 = time.perf_counter()
    index = build_index_fused(train, leaf_size=16)
    lm = index.vectors
    del index
    log("one_card_build", t0)

    t0 = time.perf_counter()
    truth = np.asarray(exact_knn(lm, test[: args.truth_q], k=K)[0])
    pack = pack_database(lm)
    one_rows = np.asarray(pallas_scan_knn_packed(
        pack, test, k=K, q_tile=Q_TILE)[0])
    r_one = recall(one_rows, truth)
    n_loc = -(-n // 4)
    nb_loc = -(-n_loc // pack.block)
    p = max(1, nb_loc // 4)  # pruned: a quarter of each shard's blocks
    del pack
    parts = {"full": ([], []), "pruned": ([], [])}
    for s in range(4):
        part = pack_database(lm[s * n_loc: min((s + 1) * n_loc, n)])
        for mode, kw in (("full", {}), ("pruned", dict(probes=p))):
            r, d = pallas_scan_knn_packed(part, test, k=K, q_tile=Q_TILE,
                                          **kw)
            parts[mode][0].append(jnp.where(r >= 0, r + s * n_loc, -1))
            parts[mode][1].append(d)
        del part
    ref_rows, ref_pruned = (
        np.asarray(merge_topk(jnp.stack(rs), jnp.stack(ds), k=K)[0])
        for rs, ds in (parts["full"], parts["pruned"]))
    log("one_card", t0, recall_at_10=r_one,
        per_shard_recall_at_10=recall(ref_rows, truth),
        per_shard_pruned_recall_at_10=recall(ref_pruned, truth))

    mesh = make_mesh()
    t0 = time.perf_counter()
    sdb = pack_database_sharded(lm, mesh)
    srows = np.asarray(sharded_scan_knn(sdb, test, k=K, q_tile=Q_TILE)[0])
    same = float((srows == ref_rows).mean())
    r_four = recall(srows, truth)
    check(same >= 0.999, f"sharded scan: only {same:.5f} of slots equal "
          "one card's scan of the same shards")
    check(r_four >= r_one, f"sharded recall {r_four} < one-card {r_one}")
    log("sharded_scan", t0, rows_same_as_one_card_shards=same,
        rows_same_as_one_card_full_scan=float((srows == one_rows).mean()),
        recall_at_10=r_four, one_card_recall_at_10=r_one)

    t0 = time.perf_counter()
    check(sdb.vb.shape[1] == nb_loc, f"{sdb.vb.shape[1]} blocks per shard")
    prow = np.asarray(sharded_scan_knn(sdb, test, k=K, q_tile=Q_TILE,
                                       probes=p)[0])
    same_p = float((prow == ref_pruned).mean())
    check(same_p >= 0.999, f"pruned sharded scan: only {same_p:.5f} of "
          "slots equal one card's pruned scans of the same shards")
    # every block through the runtime-probes program: the full scan's rows
    arow = np.asarray(sharded_scan_knn(sdb, test, k=K, q_tile=Q_TILE,
                                       probes=nb_loc, probes_max=nb_loc)[0])
    check(np.array_equal(arow, srows), "sharded probes >= blocks per "
          f"shard: {(arow != srows).sum()} slots differ from the full scan")
    log("sharded_scan_pruned", t0, probes_per_shard=p,
        blocks_per_shard=nb_loc, rows_same_as_one_card_shards=same_p,
        recall_at_10=recall(prow, truth), all_blocks_equal_to_full=True)
    del sdb, lm

    t0 = time.perf_counter()
    sidx = build_index_sharded(train, mesh, leaf_size=16)
    sidx.vectors.block_until_ready()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsp = to_bsp(sidx)
    rows = np.sort(np.random.default_rng(1).choice(n, size=4096,
                                                   replace=False))
    got = np.asarray(locate(bsp, train[jnp.asarray(rows)]))
    check(np.array_equal(got, rows),
          f"sharded tree: locate misses {(got != rows).sum()} rows")
    log("sharded_build", t0, build_s=build_s, locate_rows=int(rows.size))
    del bsp, sidx

    t0 = time.perf_counter()
    kb = jax.random.PRNGKey(7)
    ball = jax.random.uniform(kb, (1_000_000, 4), jnp.float32) * 2 - 1
    bq = jax.random.uniform(jax.random.fold_in(kb, 1), (256, 4),
                            jnp.float32) * 2 - 1
    sball = build_index_sharded(ball, mesh, leaf_size=16)
    grow, _, _, ovf = search_global(sball, bq, 0.1, max_leaves=2048)
    check(not np.asarray(ovf).any(), "sharded eps-ball overflowed")
    truth_b = np.asarray(exact_ball(ball, bq, 0.1))
    grow = np.asarray(grow)
    host, qh = np.asarray(ball, np.float64), np.asarray(bq, np.float64)
    for i in range(256):
        got = set(grow[i][grow[i] >= 0].tolist())
        for r in got ^ set(np.nonzero(truth_b[i])[0].tolist()):
            dist = float(np.sqrt(((host[r] - qh[i]) ** 2).sum()))
            check(abs(dist - 0.1) <= 1e-6 * 0.1,
                  f"sharded eps-ball query {i}: row {r} differs from the "
                  "exact oracle outside the radius band")
    log("sharded_eps_ball", t0, n=1_000_000, d=4, queries=256)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=9_990_000)
    ap.add_argument("--q", type=int, default=10_000)
    ap.add_argument("--truth-q", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not _REHEARSE:
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    sys.path.insert(0, HERE)
    from vector_database_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    timer = _COMPILE["timer"] = CompileTimer()
    smi = nvidia_smi()
    log("device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), nvidia_smi=smi, compile_cache=cache,
        jax=jax.__version__)
    if args.four:
        run_four(args, jax, jnp)
    else:
        run_one(args, jax, jnp, timer)
    log("done", t_start, compile_s_total=timer.total)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
