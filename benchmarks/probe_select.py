#!/usr/bin/env python
"""Pruned-scan SELECTION-POLICY probe (CPU, no kernel needed).

Recall through the pruned kernel is upper-bounded by block COVERAGE: a
true neighbor can only be found if its leaf-major block is in its
query's tile list. The kernel scores chosen blocks exactly, so ranking
selection policies by coverage@probes ranks them by achievable recall —
without running the scan at all.

Policies over the per-query key matrix ``key[Q, nb]`` (best-cell
centroid distance, exactly what production computes):
  min      — tile key = min over tile queries (production's base)
  min+f1   — min + force every query's top-1 block  (PRODUCTION)
  min+f2   — min + force every query's top-2 blocks
  min+f3   — min + force every query's top-3 blocks
  rank     — tile key = sum of per-query ranks (Borda count)
  rank+f1  — Borda + forced top-1
  mean     — tile key = mean key over tile queries

Usage: python benchmarks/probe_select.py [--n 1000000] [--q 4096]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--q-tile", type=int, default=512)
    ap.add_argument("--probes", type=str, default="8,16,24,32,48,64")
    ap.add_argument(
        "--cell", type=int, default=0,
        help="override summary-cell rows (0 = the pack's block/32)",
    )
    ap.add_argument(
        "--group", type=str, default="top1",
        choices=("none", "top1", "top12", "kmeans"),
        help="query->tile grouping policy (production: top1 sort)",
    )
    ap.add_argument(
        "--sel-bf16", action="store_true",
        help="single-pass bf16 selection dot (inputs rounded to bf16, "
        "f32 accumulate, as production does) instead of "
        "Precision.HIGHEST",
    )
    args = ap.parse_args()

    import jax

    # default CPU: coverage is device-independent math.
    # VDB_PROBE_DEVICE=1 runs it on the accelerator instead.
    if os.environ.get("VDB_PROBE_DEVICE") != "1":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from benchmarks.recall_qps import load_data
    from vector_database_tpu import build_index_fused, exact_knn
    from vector_database_tpu.ops.pallas_knn import pack_database

    t0 = time.time()
    train, test, name = load_data(args.n, args.d, args.q)
    index = build_index_fused(jnp.asarray(train, jnp.float32), leaf_size=16)
    del train
    pack = pack_database(index.vectors)
    nb = pack.vb.shape[0]
    block = pack.block
    print(f"# {name} nb={nb} block={block} ({time.time()-t0:.0f}s)",
          flush=True)

    # truth in SORTED-position space -> owning block ids
    truth, _ = exact_knn(index.vectors, jnp.asarray(test), k=args.k)
    tblock = np.asarray(truth) // block  # [Q, k]

    # per-query selection key: same math as _shortlist_rows
    if args.cell:
        # recompute finer/coarser summaries than the pack's block/32
        # default straight from the sorted vectors (radius only matters
        # as the empty-cell sentinel here)
        v = np.asarray(index.vectors)
        n_pad = nb * block
        vp = np.zeros((n_pad, args.d), np.float32)
        vp[: v.shape[0]] = v
        real = np.zeros(n_pad, bool)
        real[: v.shape[0]] = True
        c = args.cell
        cnt = real.reshape(-1, c).sum(1)
        cent = jnp.asarray(
            vp.reshape(-1, c, args.d).sum(1)
            / np.maximum(cnt, 1)[:, None]
        ).astype(jnp.float32)
        rad = jnp.asarray(
            np.where(cnt > 0, 0.0, -3.0e38).astype(np.float32))
    else:
        cent, rad = pack.cent, pack.rad
    cpb = cent.shape[0] // nb
    qsel, csel = jnp.asarray(test), cent
    if args.sel_bf16:
        qsel = qsel.astype(jnp.bfloat16).astype(jnp.float32)
        csel = csel.astype(jnp.bfloat16).astype(jnp.float32)
    dots = jax.lax.dot_general(
        qsel, csel,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    cc = jnp.sum(cent * cent, axis=1)
    key = cc[None, :] - 2.0 * dots
    key = jnp.where(rad[None, :] < -1e38, jnp.inf, key)
    key = np.asarray(key.reshape(args.q, nb, cpb).min(axis=2))  # [Q, nb]

    top1 = key.argmin(axis=1)
    if args.group == "none":
        order = np.arange(args.q)
    elif args.group == "top1":
        order = np.argsort(top1, kind="stable")
    elif args.group == "top12":
        t12 = np.argsort(key, axis=1)[:, :2]
        order = np.lexsort((t12[:, 1], t12[:, 0]))
    elif args.group == "kmeans":
        # tiles as key-space clusters: greedy — sort by top1, then one
        # refinement pass swapping queries toward the tile whose MEAN
        # key vector they are closest to (cosine on rank-transformed
        # keys would be fancier; L2 on keys is enough to probe)
        order = np.argsort(top1, kind="stable")
        q_t = args.q_tile
        pads = ((args.q + q_t - 1) // q_t) * q_t
        ks = np.full((pads, nb), 0, np.float32)
        ks[: args.q] = key[order]
        cent_t = ks.reshape(-1, q_t, nb).mean(axis=1)  # [tiles, nb]
        d2t = ((key[:, None, :] - cent_t[None]) ** 2).sum(-1)  # [q,t]
        pref = d2t.argmin(axis=1)
        order = np.argsort(pref, kind="stable")
    else:
        raise SystemExit(f"unknown --group {args.group}")
    q_tile = args.q_tile
    q_pad = ((args.q + q_tile - 1) // q_tile) * q_tile
    tiles = q_pad // q_tile
    key_s = np.full((q_pad, nb), np.inf, np.float32)
    key_s[: args.q] = key[order]
    ranks = np.empty_like(key_s)
    # per-query rank of each block (0 = best); inf keys rank last anyway
    rk = np.argsort(np.argsort(key_s, axis=1), axis=1).astype(np.float32)
    ranks[:] = rk
    tkey = key_s.reshape(tiles, q_tile, nb)
    trank = ranks.reshape(tiles, q_tile, nb)

    def forced(j):
        """[tiles, nb] bool: blocks that are some tile member's top-j."""
        topj = np.argsort(key_s, axis=1)[:, :j]  # [q_pad, j]
        f = np.zeros((q_pad, nb), bool)
        np.put_along_axis(f, topj, True, axis=1)
        f[args.q:] = False
        return f.reshape(tiles, q_tile, nb).any(axis=1)

    pol = {
        "min": (tkey.min(axis=1), None),
        "min+f1": (tkey.min(axis=1), forced(1)),
        "min+f2": (tkey.min(axis=1), forced(2)),
        "min+f3": (tkey.min(axis=1), forced(3)),
        "rank": (trank.sum(axis=1), None),
        "rank+f1": (trank.sum(axis=1), forced(1)),
        "mean": (np.where(np.isinf(tkey), 0, tkey).sum(axis=1), None),
        "mean+f1": (np.where(np.isinf(tkey), 0, tkey).sum(axis=1),
                    forced(1)),
    }

    tile_of = np.empty(args.q, np.int64)
    tile_of[order] = np.arange(args.q) // q_tile  # query -> its tile

    probes_list = [int(x) for x in args.probes.split(",")]
    print("policy      " + "".join(f"  P={p:<5d}" for p in probes_list),
          flush=True)
    for nm, (tk, f) in pol.items():
        tk = tk.copy()
        if f is not None:
            tk[f] = -np.inf
        bsort = np.argsort(tk, axis=1)  # [tiles, nb] best-first
        line = f"{nm:<12s}"
        for p in probes_list:
            sel = np.zeros((tiles, nb), bool)
            np.put_along_axis(sel, bsort[:, :p], True, axis=1)
            cov = sel[tile_of[:, None], tblock].mean()
            line += f"  {cov:.4f}"
        print(line, flush=True)


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
