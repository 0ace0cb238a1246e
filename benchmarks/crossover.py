#!/usr/bin/env python
"""Tree-vs-scan crossover benchmark.

The BSP tree is the engine for low-dimensional / boolean workloads (the
reference's original KB use case, README.md:4-18); the streaming scan
is the high-dimensional server (at 96-d the curse of dimensionality makes
every split plane uninformative and the tree prunes nothing). This harness
measures WHERE the crossover sits on real hardware: per dimensionality it
times

  - the tree path (pruned lockstep traversal + exact rerank + top-k),
    radius calibrated for ~0.95 recall@k, steady-state (batches chained
    inside one jit, same as the scan measurement — per-call dispatch
    would otherwise swamp the tree's small batches);
  - the packed scan serving path (``pallas_scan_knn_packed``);

plus one boolean-matrix line: exact-match identification (the Akinator
endgame — the only Hamming ball the ±1-encoded tree can prune, see the
inline note) vs the exact Hamming matmul scan.

Usage: python benchmarks/crossover.py [--n 1000000] [--q 1024]
       [--dims 2,4,8,16,32,96]
Prints one JSON line per configuration and a crossover summary.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def clustered(n, d, q, seed=0):
    import jax
    import jax.numpy as jnp

    c = max(64, n // 1000)
    centers = jax.random.uniform(
        jax.random.PRNGKey(seed), (c, d), jnp.float32
    ) * 2 - 1
    assign = jax.random.randint(jax.random.PRNGKey(seed + 1), (n,), 0, c)
    train = centers[assign] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed + 2), (n, d), jnp.float32
    )
    test = centers[
        jax.random.randint(jax.random.PRNGKey(seed + 3), (q,), 0, c)
    ] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed + 4), (q, d), jnp.float32
    )
    return train, test


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dims", type=str, default="2,4,8,16,32,96")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from vector_database_tpu import build_index_fused, exact_knn
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )
    from vector_database_tpu.search import (
        _rerank,
        _traverse,
        calibrate_radius,
        search,
    )

    print("device:", jax.devices()[0], file=sys.stderr)

    def chained_qps(fn, db_args, test):
        """Steady-state QPS with per-batch dispatch amortized: chain
        ``reps`` batches inside one jit (db as argument, not closure)."""
        qstack = jnp.broadcast_to(jnp.asarray(test), (args.reps, *test.shape))

        @jax.jit
        def chained(db, qstack):
            def body(carry, qs):
                rows, _ = fn(db, qs)
                return carry + jnp.sum(rows), None

            acc, _ = jax.lax.scan(body, jnp.int32(0), qstack)
            return acc

        int(chained(db_args, qstack))  # compile + warm
        t0 = time.time()
        int(chained(db_args, qstack))
        return args.q * args.reps / (time.time() - t0)

    def tree_knn(index, qs, radius, k, max_leaves):
        leaves, _, _ = _traverse(
            index.dim, index.mid, index.low, index.high, qs, radius,
            max_leaves=max_leaves, max_stack=index.depth + 2,
        )
        rows, d2, _, _, _ = _rerank(
            index.leaf_start, index.leaf_count, index.vectors,
            index.orig_row, leaves, qs, radius, leaf_cap=index.leaf_cap,
        )
        neg, pos = jax.lax.top_k(-d2, k)
        return jnp.take_along_axis(rows, pos, axis=1), -neg

    def recall(rows, truth_rows):
        rows = np.asarray(rows)
        hits = sum(
            len(set(rows[i].tolist()) & set(truth_rows[i].tolist()))
            for i in range(rows.shape[0])
        )
        return hits / (rows.shape[0] * args.k)

    summary = []
    for d in [int(x) for x in args.dims.split(",")]:
        train, test = clustered(args.n, d, args.q, seed=17 * d)
        index = build_index_fused(train, leaf_size=args.leaf)
        truth, _ = exact_knn(index.vectors, test, k=args.k)
        truth_rows = np.asarray(index.orig_row)[np.asarray(truth)]

        pack = pack_database(index.vectors)
        prow, _ = pallas_scan_knn_packed(pack, jnp.asarray(test), k=args.k)
        scan_rec = recall(np.asarray(index.orig_row)[np.asarray(prow)],
                          truth_rows)
        scan_qps = chained_qps(
            lambda p, qs: pallas_scan_knn_packed(
                p, qs, k=args.k, q_tile=min(512, max(256, args.q))),
            pack, test,
        )

        r = calibrate_radius(index.vectors, test[:64], args.k, 0.95)
        # freeze a leaf-buffer width wide enough for this radius (the
        # chained timing can't host-retry); double until no overflow,
        # but cap the rerank candidate budget (Q * leaves * leaf_cap
        # rows) — past the cap the tree is pruning nothing (curse of
        # dimensionality) and the honest verdict is "scan", not an OOM
        cand_cap = 64 << 20  # ~64M candidate rows across the batch
        leaf_cap_max = max(64, cand_cap // (args.q * args.leaf))
        max_leaves = 64
        pruned = True
        while True:
            res = search(index, test, r, max_leaves=max_leaves,
                         auto_grow=False)
            if not bool(jnp.any(res.overflow)):
                break
            if max_leaves >= min(index.num_leaves, leaf_cap_max):
                pruned = False
                break
            max_leaves *= 2

        if not pruned:
            line = {
                "d": d, "n": args.n, "tree_qps": None,
                "tree_recall": None, "tree_leaves": max_leaves,
                "radius": round(float(r), 4),
                "scan_qps": round(scan_qps),
                "scan_recall": round(scan_rec, 4), "winner": "scan",
                "note": "tree prunes nothing at this d/recall",
            }
            print(json.dumps(line))
            summary.append(line)
            continue

        rows, _ = tree_knn(index, jnp.asarray(test), jnp.float32(r),
                           args.k, max_leaves)
        tree_rec = recall(
            np.asarray(rows), truth_rows
        )
        tree_qps = chained_qps(
            lambda idx, qs: tree_knn(idx, qs, jnp.float32(r), args.k,
                                     max_leaves),
            index, test,
        )

        line = {
            "d": d, "n": args.n, "tree_qps": round(tree_qps),
            "tree_recall": round(tree_rec, 4), "tree_leaves": max_leaves,
            "radius": round(float(r), 4), "scan_qps": round(scan_qps),
            "scan_recall": round(scan_rec, 4),
            "winner": "tree" if tree_qps > scan_qps else "scan",
        }
        print(json.dumps(line))
        summary.append(line)

    # boolean-matrix line: identify-style Hamming workload at p=64
    from vector_database_tpu.models.boolmatrix import BoolMatrixIndex
    from vector_database_tpu.ops.exact import pairwise_sq_dists

    rng = np.random.RandomState(7)
    p = 64
    mat = rng.rand(args.n, p) < 0.5  # distinct objects (KB mode)
    qprops = mat[rng.randint(0, args.n, args.q)]
    bidx = BoolMatrixIndex(mat, leaf_size=args.leaf)
    qsigned = jnp.asarray(qprops.astype(np.float32) * 2 - 1)

    # tree: exact-match identification (Hamming 0 -> radius 0: the ONLY
    # Hamming ball the +-1/0-plane tree can prune — h>=1 means L2 radius
    # 2 >= the plane distance 1, so both branches always match). The
    # Akinator endgame descends ONE branch per level: the single-branch
    # locate path (depth lockstep steps, no DFS stack).
    from vector_database_tpu.search import _descend, _locate_in_leaf

    # sanity: every object identifies to itself
    sample = np.asarray(bidx.identify_batch(qprops[:64]))
    assert (sample >= 0).all()

    def identify_fn(idx, qs):
        leaf, _ = _descend(idx.dim, idx.mid, idx.low, idx.high, qs,
                           depth=idx.depth)
        rows = _locate_in_leaf(
            idx.leaf_start, idx.leaf_count, idx.vectors, idx.orig_row,
            leaf, qs, leaf_cap=idx.leaf_cap,
        )
        return rows, None

    btree_qps = chained_qps(identify_fn, bidx._index, np.asarray(qsigned))

    def bool_scan(vectors, qs):
        d2 = pairwise_sq_dists(qs, vectors)
        neg, pos = jax.lax.top_k(-d2, args.k)
        return pos, -neg

    bscan_qps = chained_qps(bool_scan, bidx._index.vectors,
                            np.asarray(qsigned))
    line = {
        "d": f"bool{p}", "n": args.n, "tree_qps": round(btree_qps),
        "scan_qps": round(bscan_qps), "workload": "identify",
        "winner": "tree" if btree_qps > bscan_qps else "scan",
    }
    print(json.dumps(line))
    summary.append(line)

    tree_wins = [s["d"] for s in summary if s["winner"] == "tree"]
    print(json.dumps({"tree_wins_at": tree_wins}))


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
