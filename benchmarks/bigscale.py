#!/usr/bin/env python
"""Out-of-core scale demonstration: build and serve a dataset 10x the
reference's flagship (100M x 96 ~ 38 GB of f32)
through the C++ mmap store + ChunkedIndex pipeline:

  host RNG -> NativeVectorStore (mmap file, reference FileRangeStore's
  role) -> per-chunk fused device builds -> host-resident chunk indexes
  -> exact cross-chunk top-k merge serving.

Recall is checked against a chunked exact-scan oracle on a query sample
(the full oracle would be another 38 GB stream — the sample is enough to
catch a broken merge). Prints JSON lines; the final line is the summary.

Usage: python benchmarks/bigscale.py [--n 100000000] [--d 96]
       [--chunk 10000000] [--q 256] [--path /tmp/bigscale.vstore]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=10_000_000)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--path", default="/tmp/bigscale.vstore")
    ap.add_argument("--spill", default="/tmp/bigscale_spill",
                    help="disk spill dir for chunk vectors ('' = RAM)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument(
        "--reuse", action="store_true",
        help="reuse an existing store file at --path (skip ingest)",
    )
    ap.add_argument(
        "--pin", action="store_true",
        help="also measure the pinned capacity mode: packed blocks stay "
        "device-resident (~196 B/row at 96-d), steady-state QPS",
    )
    ap.add_argument(
        "--probes", type=int, default=None,
        help="with --pin: also measure the pruned pinned mode "
        "(per-chunk probes)",
    )
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from vector_database_tpu import ChunkedIndex, exact_knn
    from vector_database_tpu.runtime.native_store import NativeVectorStore

    print(json.dumps({"device": str(jax.devices()[0])}), flush=True)

    # --- ingest: host RNG -> mmap store (chunked; never 38 GB in RAM)
    rng = np.random.RandomState(11)
    if args.reuse and os.path.exists(args.path):
        store = NativeVectorStore.open(args.path)
        assert len(store) >= args.n, "existing store too small for --n"
        print(json.dumps({"ingest_rows": len(store), "reused": True}),
              flush=True)
    else:
        if os.path.exists(args.path):
            os.unlink(args.path)
        t0 = time.time()
        store = NativeVectorStore.create(args.path, args.d,
                                         capacity_rows=args.chunk)
        written = 0
        while written < args.n:
            rows = min(args.chunk, args.n - written)
            block = (rng.rand(rows, args.d).astype(np.float32) * 2 - 1)
            store.append(block)
            written += rows
        ingest_s = time.time() - t0
        print(json.dumps({
            "ingest_rows": written,
            "ingest_s": round(ingest_s, 1),
            "store_gb": round(written * args.d * 4 / 2**30, 1),
        }), flush=True)

    # --- build: per-chunk fused device builds, indexes return to host
    t0 = time.time()
    ci = ChunkedIndex.from_store(store, chunk_rows=args.chunk,
                                 leaf_size=args.leaf,
                                 spill_dir=args.spill or None)
    build_s = time.time() - t0
    print(json.dumps({"chunks": ci.num_chunks,
                      "build_s": round(build_s, 1),
                      "vectors_per_s": round(args.n / build_s)}), flush=True)

    # --- queries: perturbed database rows; exact-merge serving
    queries = np.stack([
        np.asarray(store.rows(i * (args.n // args.q), 1))[0]
        for i in range(args.q)
    ]) + 0.01 * rng.randn(args.q, args.d).astype(np.float32)

    t0 = time.time()
    rows, d2 = ci.knn(queries, k=args.k)
    query_s = time.time() - t0
    qps = args.q / query_s  # COLD: includes compile + first chunk stream

    # steady-state streamed-mode QPS (warm executables; per-call chunk
    # streaming remains — the host-to-device transfer is the bound)
    t0 = time.time()
    for _ in range(args.reps):
        rows, d2 = ci.knn(queries, k=args.k)
    qps_steady = args.q * args.reps / (time.time() - t0)
    print(json.dumps({"streamed_steady_qps": round(qps_steady, 1)}),
          flush=True)

    pinned_qps = pruned_qps = None
    if args.pin:
        ci.pin()
        ci.knn(queries, k=args.k)  # warm
        t0 = time.time()
        for _ in range(args.reps):
            prow, _ = ci.knn(queries, k=args.k)
        pinned_qps = args.q * args.reps / (time.time() - t0)
        match = sum(
            len(set(prow[i].tolist()) & set(rows[i].tolist()))
            for i in range(args.q)
        ) / (args.q * args.k)
        print(json.dumps({"pinned_steady_qps": round(pinned_qps, 1),
                          "pinned_vs_streamed_overlap": round(match, 3)}),
              flush=True)
        if args.probes:
            ci.knn(queries, k=args.k, probes=args.probes)  # warm
            t0 = time.time()
            for _ in range(args.reps):
                prow, _ = ci.knn(queries, k=args.k, probes=args.probes)
            pruned_qps = args.q * args.reps / (time.time() - t0)
            match = sum(
                len(set(prow[i].tolist()) & set(rows[i].tolist()))
                for i in range(args.q)
            ) / (args.q * args.k)
            print(json.dumps({
                "pinned_pruned_steady_qps": round(pruned_qps, 1),
                "probes": args.probes,
                "pruned_vs_full_overlap": round(match, 3),
            }), flush=True)

    # --- sampled oracle: chunked exact scan for the first 16 queries
    qs = jnp.asarray(queries[:16])
    best_d = np.full((16, args.k), np.inf, np.float32)
    best_r = np.full((16, args.k), -1, np.int64)
    off = 0
    for start in range(0, args.n, args.chunk):
        nrows = min(args.chunk, args.n - start)
        dev = jnp.asarray(store.rows(start, nrows))
        idx, dd = exact_knn(dev, qs, k=args.k)
        idx = np.asarray(idx) + off
        dd = np.asarray(dd)
        cat_d = np.concatenate([best_d, dd], 1)
        cat_r = np.concatenate([best_r, idx], 1)
        order = np.argsort(cat_d, axis=1)[:, : args.k]
        best_d = np.take_along_axis(cat_d, order, 1)
        best_r = np.take_along_axis(cat_r, order, 1)
        off += nrows
        dev.delete()
    hits = sum(
        len(set(rows[i].tolist()) & set(best_r[i].tolist()))
        for i in range(16)
    )
    recall = hits / (16 * args.k)

    print(json.dumps({
        "metric": f"out_of_core_build_{args.d}d_n{args.n}",
        "value": round(args.n / build_s),
        "unit": "vectors/s",
        "build_s": round(build_s, 1),
        "serve_qps_cold": round(qps, 1),
        "serve_qps_steady": round(qps_steady, 1),
        "pinned_qps_steady":
            round(pinned_qps, 1) if pinned_qps else None,
        "pinned_pruned_qps_steady":
            round(pruned_qps, 1) if pruned_qps else None,
        "recall_at_10_sampled": round(recall, 3),
    }), flush=True)

    if not args.keep:
        os.unlink(args.path)
        if args.spill:
            import shutil

            shutil.rmtree(args.spill, ignore_errors=True)


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
