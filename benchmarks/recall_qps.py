#!/usr/bin/env python
"""Recall@k vs QPS harness — the qdrant.tech-style benchmark the reference
intended but never implemented (reference README.md:102-103).

Measures, on the current device:
  - index build throughput (fused builder);
  - exact-scan k-NN QPS (precise f32 and bf16+rerank serving paths) with
    recall@k against the f32 oracle;
  - tree-search QPS/recall at several radii (meaningful at low/moderate
    dimensionality; at 96-d the scan path is the server).

Dataset: an ann-benchmarks HDF5 file if VDB_DATA points at one (e.g.
deep-image-96-angular.hdf5), otherwise synthetic clustered vectors (uniform
random has no neighbor structure at high D and benchmarks nothing useful).

Usage: python benchmarks/recall_qps.py [--n 1000000] [--d 96] [--q 1024]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# run from anywhere without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_data(n, d, q, seed=0):
    path = os.environ.get("VDB_DATA")
    if path and path.endswith(".arff"):
        from vector_database_tpu.utils.arff import load_arff, minmax_normalize

        data, _, _ = load_arff(path)
        vecs = minmax_normalize(data)[:n]
        rng = np.random.RandomState(seed)
        test = vecs[rng.randint(0, vecs.shape[0], size=q)]
        return vecs, test, f"arff:{os.path.basename(path)}"
    if path:
        from vector_database_tpu.utils.datasets import hdf5_size, load_hdf5

        rows, dims = hdf5_size(path, "/train")
        n = min(n, rows)
        parts = []
        for start, chunk in load_hdf5(path, "/train", chunk=250_000):
            parts.append(chunk)
            if sum(p.shape[0] for p in parts) >= n:
                break
        train = np.concatenate(parts)[:n]
        qrows, _ = hdf5_size(path, "/test")
        import h5py

        with h5py.File(path, "r") as f:
            test = np.asarray(f["test"][: min(q, qrows)], np.float32)
        return train, test, f"hdf5:{os.path.basename(path)}"

    import jax
    import jax.numpy as jnp

    c = max(64, n // 1000)
    key = jax.random.PRNGKey(seed)
    centers = jax.random.uniform(key, (c, d), jnp.float32) * 2 - 1
    assign = jax.random.randint(jax.random.PRNGKey(1), (n,), 0, c)
    train = centers[assign] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(2), (n, d), jnp.float32
    )
    test = centers[
        jax.random.randint(jax.random.PRNGKey(3), (q,), 0, c)
    ] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(4), (q, d), jnp.float32
    )
    return train, test, f"clustered:{n}x{d}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument(
        "--sweep", action="store_true",
        help="emit a (recall, QPS) curve over the serving knobs "
        "(buckets x oversample) — the qdrant-style tradeoff plot, one "
        "JSON line per operating point",
    )
    ap.add_argument(
        "--probes", type=str, default=None,
        help="comma-separated probes values (e.g. 64,128,256): also "
        "serve through the PRUNED scan — only that many database blocks "
        "stream per query tile, chosen by cell-centroid distance — one "
        "JSON line per value (the IVF-style high-QPS operating points)",
    )
    ap.add_argument(
        "--buckets", type=int, default=4096,
        help="shortlist bucket count m for the single-device serve pack",
    )
    ap.add_argument(
        "--sharded-only", action="store_true", dest="sharded_only",
        help="measure ONLY the mesh serving path (implies --sharded; "
        "skips every single-device serving section so the sharded "
        "pack gets unfragmented memory — a production mesh process "
        "never runs the single-device passes anyway)",
    )
    ap.add_argument(
        "--sharded", action="store_true",
        help="ALSO serve through the mesh path (parallel/scan.py): "
        "pack_database_sharded over a mesh of all visible devices + "
        "sharded_scan_knn — on one device this measures the pure SPMD "
        "overhead vs the single-device line; on N devices, the "
        "multi-device QPS multiplier",
    )
    args = ap.parse_args()
    if args.sharded_only:
        args.sharded = True

    if os.environ.get("VDB_CPU"):
        # smoke the full pipeline glue on the CPU (the plain XLA scan
        # route); must land before any device touch
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from vector_database_tpu import (
        build_index_fused,
        exact_knn,
        knn,
        scan_knn,
    )
    from vector_database_tpu.search import calibrate_radius

    train, test, name = load_data(args.n, args.d, args.q)
    # a dataset's test split can be smaller than --q: every QPS below
    # divides by the ACTUAL batch size, not the requested one
    nq = test.shape[0]
    report = {"dataset": name, "k": args.k, "q": nq, "device": None}
    import jax

    report["device"] = str(jax.devices()[0])

    t0 = time.time()
    # donate: the input buffer is dead after the build's first level and
    # everything downstream reads index.vectors — at 10M this frees 3.8G
    # of HBM that otherwise OOMs the serving sections
    index = build_index_fused(
        jnp.asarray(train, jnp.float32), leaf_size=args.leaf, donate=True
    )
    del train
    np.asarray(index.orig_row[:1])
    report["build_s"] = round(time.time() - t0, 2)
    report["build_vps"] = round(index.n / report["build_s"], 0)
    report["depth"] = index.depth

    truth, _ = exact_knn(index.vectors, test, k=args.k)
    truth_rows = np.asarray(index.orig_row)[np.asarray(truth)]

    def recall(rows):
        rows = np.asarray(rows)
        hits = sum(
            len(set(rows[i].tolist()) & set(truth_rows[i].tolist()))
            for i in range(rows.shape[0])
        )
        return hits / (rows.shape[0] * args.k)

    def to_orig(rows):
        """Sorted-position rows -> original input-row ids, keeping -1
        padding as -1 (numpy fancy indexing would wrap -1 to the LAST
        row's id and overstate recall)."""
        rows = np.asarray(rows)
        orig = np.asarray(index.orig_row)
        return np.where(rows >= 0, orig[np.clip(rows, 0, None)], -1)

    def timed(fn):
        out = fn()
        np.asarray(out[0][:1])
        t0 = time.time()
        for _ in range(args.reps):
            out = fn()
            np.asarray(out[0][:1])
        return out, nq * args.reps / (time.time() - t0)

    def timed_chained(batch_fn, db=None):
        """Steady-state QPS: chain the batches inside one jit so per-call
        dispatch doesn't pollute the number; returns (last result, qps).
        The database (raw vectors or a PackedDB pytree) is an ARGUMENT,
        not a closure capture — captured device arrays would become
        compile-time constants of the program."""
        import jax

        if db is None:
            db = index.vectors
        qstack = jnp.broadcast_to(
            jnp.asarray(test), (args.reps, *test.shape)
        )

        @jax.jit
        def chained(db, qstack):
            def body(carry, qs):
                rows, d2 = batch_fn(db, qs)
                return carry + jnp.sum(rows), None
            acc, _ = jax.lax.scan(body, jnp.int32(0), qstack)
            return acc

        int(chained(db, qstack))  # compile + warm
        t0 = time.time()
        int(chained(db, qstack))
        qps = nq * args.reps / (time.time() - t0)
        return batch_fn(db, jnp.asarray(test)), qps

    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    if args.sharded_only:
        # dedicated mesh measurement: skip every single-chip serving
        # section: their leftovers would share device memory with the
        # sharded pack's in-flight programs, and a production mesh
        # process never runs them anyway.
        pack = None
    else:
        t0 = time.time()
        pack = pack_database(index.vectors, buckets=args.buckets)
        np.asarray(pack.vn[:1, :, :1])
        report["pack_s"] = round(time.time() - t0, 2)

    for mode, fn, db in () if args.sharded_only else (
        ("scan_bf16", lambda v, qs: scan_knn(v, qs, k=args.k), None),
        # serving path: database packed once, batches stream against it
        ("pallas", lambda p, qs: pallas_scan_knn_packed(
            p, qs, k=args.k, q_tile=min(512, max(256, args.q))), pack),
    ):
        (rows, _), qps = timed_chained(fn, db=db)
        report[f"{mode}_qps"] = round(qps, 0)
        report[f"{mode}_recall"] = round(recall(to_orig(rows)), 4)

    if args.probes and not args.sharded_only:
        nb = pack.vb.shape[0]
        for p in (int(x) for x in args.probes.split(",")):
            fn = (
                lambda pk, qs, p=p: pallas_scan_knn_packed(
                    pk, qs, k=args.k,
                    q_tile=min(512, max(256, args.q)), probes=min(p, nb),
                )
            )
            (rows, _), qps = timed_chained(fn, db=pack)
            print(json.dumps({"probes": {
                "probes": min(p, nb), "blocks": nb,
                "stream_fraction": round(min(p, nb) / nb, 4),
                "qps": round(qps),
                "recall": round(recall(to_orig(rows)), 4),
            }}))

    if (args.sweep or args.sharded) and pack is not None:
        # the single-chip pack is done serving; free its blocks so the
        # sweep/sharded copies fit alongside index.vectors at 10M
        pack.vb.delete()
        pack.vn.delete()
        if pack.cent is not None:
            pack.cent.delete()
            pack.rad.delete()

    if args.sweep:
        # recall-vs-QPS operating curve: shortlist buckets (selection
        # granularity) x oversample (rerank width). Each bucket setting
        # re-packs (freeing the previous pack first, so only one pack
        # sits beside index.vectors); each point is
        # steady-state chained timing.
        for buckets in (2048, 4096, 8192):
            p = pack_database(index.vectors, buckets=buckets)
            np.asarray(p.vn[:1, :, :1])
            for ov in (1, 4, 16):
                fn = (
                    lambda p, qs, ov=ov: pallas_scan_knn_packed(
                        p, qs, k=args.k,
                        q_tile=min(512, max(256, args.q)), oversample=ov,
                    )
                )
                (rows, _), qps = timed_chained(fn, db=p)
                print(json.dumps({"sweep": {
                    "buckets": buckets, "oversample": ov,
                    "qps": round(qps),
                    "recall": round(recall(to_orig(rows)), 4),
                }}))
            p.vb.delete()
            p.vn.delete()
            if p.cent is not None:
                p.cent.delete()
                p.rad.delete()

    if args.sharded:
        from vector_database_tpu.parallel import (
            make_mesh,
            pack_database_sharded,
        )
        from vector_database_tpu.parallel.forest import merge_topk
        from vector_database_tpu.parallel.scan import _sharded_serve_fn

        mesh = make_mesh()
        host_rows = np.asarray(index.orig_row)
        # above tree-walk scale nothing downstream reads index.vectors:
        # donate it into the sharded pack (input + rerank copy + bf16
        # blocks are ~4+4+2 GB at 10M; no need to keep a fourth copy
        # alive through the pack)
        donate = args.n > 2_000_000
        t0 = time.time()
        sdb = pack_database_sharded(
            index.vectors, mesh, orig_rows=host_rows, donate=donate,
        )
        jax.block_until_ready(sdb.vb)
        report["sharded_devices"] = int(np.prod(list(mesh.shape.values())))
        report["sharded_pack_s"] = round(time.time() - t0, 2)
        q_tile = min(512, max(256, args.q))
        serve = _sharded_serve_fn(
            mesh, sdb.axis, sdb.n_loc, sdb.block, sdb.m, sdb.bits,
            sdb.metric, args.k, q_tile, None, False,
        )

        def sharded_fn(db, qs):
            vb, vn, vecs, orig, cent, rad = db
            rows_p, key_p = serve(vb, vn, vecs, orig, qs, cent, rad)
            return merge_topk(rows_p, key_p, k=args.k)

        (rows, _), qps = timed_chained(
            sharded_fn,
            db=(sdb.vb, sdb.vn, sdb.vectors, sdb.orig_row,
                sdb.cent, sdb.rad),
        )
        report["sharded_qps"] = round(qps, 0)
        report["sharded_recall"] = round(recall(np.asarray(rows)), 4)

        if args.probes:
            # pruned x sharded composition: per-shard pruned stream +
            # the same all-gather merge, one line per probes value
            nb_loc = sdb.vb.shape[1]
            for p in (int(x) for x in args.probes.split(",")):
                p = min(p, nb_loc)
                pserve = _sharded_serve_fn(
                    mesh, sdb.axis, sdb.n_loc, sdb.block, sdb.m,
                    sdb.bits, sdb.metric, args.k, q_tile, None, False,
                    p if p < nb_loc else None,
                )

                def pruned_fn(db, qs, pserve=pserve):
                    vb, vn, vecs, orig, cent, rad = db
                    rows_p, key_p = pserve(vb, vn, vecs, orig, qs,
                                           cent, rad)
                    return merge_topk(rows_p, key_p, k=args.k)

                (rows, _), qps = timed_chained(
                    pruned_fn,
                    db=(sdb.vb, sdb.vn, sdb.vectors, sdb.orig_row,
                        sdb.cent, sdb.rad),
                )
                print(json.dumps({"sharded_probes": {
                    "probes": p, "blocks_per_shard": nb_loc,
                    "stream_fraction": round(p / nb_loc, 4),
                    "qps": round(qps),
                    "recall": round(recall(np.asarray(rows)), 4),
                }}))

    if args.n <= 2_000_000:
        # at high D the tree prunes nothing (measured crossover,
        # benchmarks/crossover.py) — skip the walk at scan scale
        r = calibrate_radius(
            index.vectors, jnp.asarray(test[:64]), args.k, 0.9
        )
        (rows, _), qps = timed(
            lambda: knn(index, jnp.asarray(test), k=args.k, radius=r,
                        max_leaves=256)
        )
        report["tree_radius"] = round(float(r), 4)
        report["tree_qps"] = round(qps, 0)
        report["tree_recall"] = round(recall(rows), 4)

    print(json.dumps(report))


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
