#!/usr/bin/env python
"""Serving latency + small-batch throughput through ``PackedServer``.

Every serving number was q=4096-centric; a
serving layer without a latency number is half-characterized. This
harness measures, per batch size (default 32 / 256 / 1024 / 4096):

- **per-call latency** p50 / p99 over repeated ``PackedServer.query``
  calls (the real request path: host pad -> device -> host results),
  with the floor (min) reported beside them;
- **sequential QPS** (1 / latency x batch — what one synchronous client
  gets) and **chained QPS** (batches queued back-to-back inside one jit:
  the pipelined steady state an async server reaches);
- **recall@k** against the exact oracle at each operating point (pruned
  serving is a BATCH mode — the small-batch rows of the pruned table are
  expected to fall off the recall knee; that is the documented result,
  not a bug).

Usage:
  python benchmarks/latency.py [--n 10000000] [--probes 256]
  (VDB_LAT_BATCHES=32,256,1024,4096 to override the sweep)
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
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--reps", type=int, default=20,
                    help="chained batches per throughput measurement")
    ap.add_argument("--probes", type=int, default=256,
                    help="pruned operating point (0 = full scan only)")
    ap.add_argument("--truth-q", type=int, default=512)
    args = ap.parse_args()
    batches = [
        int(x)
        for x in os.environ.get(
            "VDB_LAT_BATCHES", "32,256,1024,4096"
        ).split(",")
    ]

    import jax
    import jax.numpy as jnp

    from vector_database_tpu import build_index_fused, exact_knn
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )
    from vector_database_tpu.serving import PackedServer

    n, d, k = args.n, args.d, args.k
    c = max(64, n // 1000)
    centers = (
        jax.random.uniform(jax.random.PRNGKey(10), (c, d), jnp.float32)
        * 2 - 1
    )
    assign = jax.random.randint(jax.random.PRNGKey(11), (n,), 0, c)
    train = centers[assign] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(12), (n, d), jnp.float32
    )
    qmax = max(batches)
    test = np.asarray(centers[
        jax.random.randint(jax.random.PRNGKey(13), (qmax, ), 0, c)
    ] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(14), (qmax, d), jnp.float32
    ))

    index = build_index_fused(train, leaf_size=args.leaf, donate=True)
    for buf in (index.orig_row, index.dim, index.mid, index.low,
                index.high, index.leaf_start, index.leaf_count):
        buf.delete()
    vectors = index.vectors
    tq = min(args.truth_q, qmax)
    truth = np.asarray(exact_knn(vectors, jnp.asarray(test[:tq]), k=k)[0])
    want = [set(r.tolist()) for r in truth]

    def recall(rows):
        rows = np.asarray(rows)[:tq]
        hits = sum(
            len(set(rows[i].tolist()) & want[i])
            for i in range(min(len(want), rows.shape[0]))
        )
        return hits / max(1, sum(
            len(w) for w in want[:rows.shape[0]]
        ))

    pack = pack_database(vectors)
    np.asarray(pack.vn[:1, :, :1])
    nb = pack.vb.shape[0]
    modes = [("full", None)]
    if args.probes and args.probes < nb:
        modes.append(("pruned", args.probes))

    print(json.dumps({"n": n, "d": d, "k": k, "blocks": nb,
                      "device": str(jax.devices()[0])}))
    rng = np.random.RandomState(0)
    for b in batches:
        for mode, probes in modes:
            srv = PackedServer(pack, k=k, batch=b, probes=probes)
            srv.warmup()
            # distinct query sets per call (no cross-call caching luck)
            lats = []
            for i in range(args.calls):
                qs = test[rng.randint(0, qmax, size=b)]
                t0 = time.time()
                rows, _ = srv.query(qs)
                lats.append(time.time() - t0)
            lats = np.sort(np.asarray(lats))
            p50 = float(np.percentile(lats, 50))
            p99 = float(np.percentile(lats, 99))
            # chained steady state at this batch shape
            q_tile = srv._q_tile
            qstack = jnp.asarray(
                np.stack([
                    test[rng.randint(0, qmax, size=b)]
                    for _ in range(args.reps)
                ])
            )

            @jax.jit
            def chained(pk, qs):
                def body(carry, batch):
                    r, _ = pallas_scan_knn_packed(
                        pk, batch, k=k, q_tile=q_tile, probes=probes,
                    )
                    return carry + jnp.sum(r).astype(jnp.float32), None
                acc, _ = jax.lax.scan(body, jnp.float32(0), qs)
                return acc

            float(chained(pack, qstack))
            t0 = time.time()
            float(chained(pack, qstack))
            qps_chained = b * args.reps / (time.time() - t0)
            # recall at this operating point: serve enough queries to
            # cover the truth subset, in this batch size's waves
            rows, _ = srv.query(test[:b] if b >= tq else test[:tq])
            print(json.dumps({
                "batch": b, "mode": mode, "probes": probes,
                "lat_p50_ms": round(p50 * 1e3, 2),
                "lat_p99_ms": round(p99 * 1e3, 2),
                "lat_min_ms": round(float(lats[0]) * 1e3, 2),
                "qps_sequential": round(b / p50),
                "qps_chained": round(qps_chained),
                "recall": round(recall(rows), 4),
            }), flush=True)


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
