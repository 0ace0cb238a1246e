#!/usr/bin/env python
"""DynamicIndex mutate+serve steady state: when does packed serving win?

Measures the ``mask_rows`` tombstone path. DynamicIndex
serves the main segment and the delta as separate parts (dynamic.py):
an ``add`` only rebuilds the tiny padded delta view (the main pack
SURVIVES adds — fresh rows merge exactly per batch); a main-segment
removal invalidates the main view — the exact scan recovers with one
[N]-bool mask upload, and packed serving now recovers with
``PackedDB.mask_rows`` (the bf16 BASE pack survives the whole
compaction epoch; a tombstone epoch rebuilds only the [1, N] norm row
ON DEVICE — no host gather, no bf16 repack, no transfer).

Measured here on the real device, per database size:

  t_scan         — steady exact-scan batch
  t_packed       — steady packed batch (same epoch)
  t_scan_add     — first scan batch after an add (delta view rebuild)
  t_packed_add   — first packed batch after an add (NO repack)
  t_scan_rm      — first scan batch after remove_ids (mask upload)
  t_packed_rm    — first packed batch after remove_ids (mask upload +
                   device norm-row rebuild via mask_rows)

Packed serving wins a remove epoch of T batches when
  T > (t_packed_rm - t_scan_rm) / (t_scan - t_packed);
for add epochs it wins whenever t_packed_add < t_scan_add (no repack).

Prints one JSON line per database size.

Usage: python benchmarks/probe_churn.py [--sizes 1000000,10000000]
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
    ap.add_argument("--sizes", type=str, default="1000000")
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()

    import jax

    from vector_database_tpu.dynamic import DynamicIndex

    dyn = None
    for n in (int(x) for x in args.sizes.split(",")):
        if dyn is not None:
            # free the previous size's device residents (index, serve
            # view, pack) BEFORE allocating the next
            dyn._invalidate_serve()
            if dyn._index is not None:
                for buf in (dyn._index.vectors, dyn._index.orig_row,
                            dyn._index.dim, dyn._index.mid,
                            dyn._index.low, dyn._index.high,
                            dyn._index.leaf_start, dyn._index.leaf_count):
                    buf.delete()
            dyn = None
        rng = np.random.RandomState(0)
        base = rng.rand(n, args.d).astype(np.float32) * 2 - 1
        queries = rng.rand(args.q, args.d).astype(np.float32) * 2 - 1
        dyn = DynamicIndex(base, leaf_size=16)
        del base

        def scan_batch():
            dyn.knn(queries, k=args.k)

        def packed_batch():
            dyn.knn(queries, k=args.k, exact=False, packed=True)

        def timed(fn, reps):
            t0 = time.time()
            for _ in range(reps):
                fn()
            return (time.time() - t0) / reps

        def epoch_first(mutate, batch, epochs):
            """Mean first-batch-after-mutation time. The first epoch is
            the warm-up (it compiles the post-mutation programs — delta
            merge / masked scan); steady epochs share them."""
            mutate()
            batch()
            ts = []
            for _ in range(epochs):
                mutate()
                t0 = time.time()
                batch()
                ts.append(time.time() - t0)
            return sum(ts) / len(ts)

        # steady batches (compile/warm first)
        scan_batch()
        t_scan = timed(scan_batch, args.reps)
        packed_batch()
        t_packed = timed(packed_batch, args.reps)
        pack_obj = dyn._packed[1] if dyn._packed is not None else None

        # add churn: one fresh row per epoch (delta stays inside its
        # 64-row padded capacity, so every epoch shares the programs)
        def add_one():
            dyn.add(rng.rand(1, args.d).astype(np.float32) * 2 - 1)

        t_scan_add = epoch_first(add_one, scan_batch, args.epochs)
        t_packed_add = epoch_first(add_one, packed_batch, args.epochs)
        pack_survived = bool(
            pack_obj is not None
            and dyn._packed is not None
            and dyn._packed[1] is pack_obj
        )

        # remove churn: tombstone one main row per epoch
        rm_iter = iter(range(n))

        def remove_one():
            dyn.remove_ids([next(rm_iter)])

        t_scan_rm = epoch_first(remove_one, scan_batch, args.epochs)
        # mask_rows keeps the bf16 base pack: measurable at every size
        # (the old gather+repack was transfer-bound above 2M rows)
        t_packed_rm = epoch_first(remove_one, packed_batch, args.epochs)
        base_survived = bool(
            dyn._packed_base is not None
            and dyn._packed_base[0] is dyn._index
        )

        denom = t_scan - t_packed
        crossover_rm = (
            round((t_packed_rm - t_scan_rm) / denom, 2)
            if (t_packed_rm is not None and denom > 0) else None
        )
        print(json.dumps({
            "n": n,
            "q": args.q,
            "t_scan_batch_s": round(t_scan, 4),
            "t_packed_batch_s": round(t_packed, 4),
            "t_scan_first_after_add_s": round(t_scan_add, 4),
            "t_packed_first_after_add_s": round(t_packed_add, 4),
            "pack_survived_adds": pack_survived,
            "t_scan_first_after_remove_s": round(t_scan_rm, 4),
            "t_packed_first_after_remove_s": round(t_packed_rm, 4),
            "base_pack_survived_removes": base_survived,
            "scan_qps": round(args.q / t_scan),
            "packed_qps": round(args.q / t_packed),
            "remove_crossover_batches_per_epoch": crossover_rm,
            "device": str(jax.devices()[0]),
        }), flush=True)


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
