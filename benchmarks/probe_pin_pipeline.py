"""A/B the capacity-mode dispatch pipeline (out_of_core.knn, pinned +
host_rerank): VDB_PIN_PIPELINE=1 enqueues every chunk's kernel + an async
device->host shortlist copy BEFORE any host rerank, so the per-chunk
dispatch, the scan, and the ~1.3 MB/chunk result transfer overlap the
host-side candidate gather + exact rerank; =0 is the old strictly
sequential loop. Results must be bit-identical (merge order unchanged) —
asserted here.

Runs on the accelerator (this is a dispatch/transfer-overlap
measurement; a CPU run measures nothing). One process per device.

Usage:
  python benchmarks/probe_pin_pipeline.py [--n 4000000] [--chunk 500000]
      [--d 96] [--q 4096] [--k 10] [--probes 64] [--reps 4]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--chunk", type=int, default=500_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--probes", type=int, default=64)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU smoke (plain XLA scan; no timing value)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from vector_database_tpu.out_of_core import ChunkedIndex

    rng = np.random.RandomState(7)
    nc = max(16, args.n // 1000)
    centers = rng.randn(nc, args.d).astype(np.float32)

    index = ChunkedIndex(leaf_size=16)
    t0 = time.time()
    first = None
    for lo in range(0, args.n, args.chunk):
        rows = min(args.chunk, args.n - lo)
        assign = rng.randint(0, nc, size=rows)
        chunk = (
            centers[assign] + 0.1 * rng.randn(rows, args.d)
        ).astype(np.float32)
        if first is None:
            first = chunk[: args.q].copy()
        index.add_chunk(chunk, capacity=args.chunk)
        del chunk
    print(json.dumps({
        "build_s": round(time.time() - t0, 1),
        "chunks": index.num_chunks,
    }), flush=True)
    index.pin()

    queries = (
        first + 0.05 * rng.randn(args.q, args.d).astype(np.float32)
    )

    def timed(mode_env: str, probes):
        os.environ["VDB_PIN_PIPELINE"] = mode_env
        kw = {"probes": probes} if probes else {}
        r, d = index.knn(queries, k=args.k, **kw)  # warm (compiles)
        t0 = time.time()
        for _ in range(args.reps):
            r, d = index.knn(queries, k=args.k, **kw)
        dt = (time.time() - t0) / args.reps
        return r, d, round(args.q / dt)

    out = {}
    for tag, probes in (("full", None), ("pruned", args.probes)):
        r_seq, d_seq, qps_seq = timed("0", probes)
        r_pipe, d_pipe, qps_pipe = timed("1", probes)
        assert r_seq.tolist() == r_pipe.tolist(), f"{tag}: rows differ"
        np.testing.assert_array_equal(d_seq, d_pipe)
        out[f"{tag}_seq_qps"] = qps_seq
        out[f"{tag}_pipe_qps"] = qps_pipe
        out[f"{tag}_speedup"] = round(qps_pipe / max(qps_seq, 1), 3)
        print(json.dumps({tag: {
            "seq_qps": qps_seq, "pipe_qps": qps_pipe,
            "bit_identical": True,
        }}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
