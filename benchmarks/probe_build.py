"""Build-time bisection probe: time build_index_fused under different
knobs (stats_subsample, leaf_size, d) to locate where the per-level cost
sits on real hardware. One JSON line per variant.

Usage: python benchmarks/probe_build.py N '[{"leaf":16,"ss":4}, ...]'
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    variants = (
        eval(sys.argv[2]) if len(sys.argv) > 2 else [{"leaf": 16, "ss": 4}]
    )

    import jax
    import jax.numpy as jnp

    from vector_database_tpu import build_index_fused

    print("device:", jax.devices()[0], file=sys.stderr)

    def make(seed, d):
        v = (
            jax.random.uniform(jax.random.PRNGKey(seed), (n, d), jnp.float32)
            * 2.0 - 1.0
        )
        v.block_until_ready()
        return v

    def drop(idx):
        for buf in (idx.vectors, idx.orig_row, idx.dim, idx.mid, idx.low,
                    idx.high, idx.leaf_start, idx.leaf_count):
            buf.delete()

    for var in variants:
        d = var.get("d", 96)
        leaf = var.get("leaf", 16)
        ss = var.get("ss", None)
        kw = dict(leaf_size=leaf, donate=True)
        if ss is not None:
            kw["stats_subsample"] = ss
        if "max_levels" in var:
            kw["max_levels"] = var["max_levels"]
        if "tie" in var:
            kw["tie_break"] = var["tie"]
        idx = build_index_fused(make(0, d), **kw)  # compile + warm
        np.asarray(idx.orig_row[:1])
        depth = idx.depth
        drop(idx)
        dt = float("inf")
        for seed in (1, 2):
            vecs = make(seed, d)
            t0 = time.time()
            idx = build_index_fused(vecs, **kw)
            np.asarray(idx.orig_row[:1])
            dt = min(dt, time.time() - t0)
            drop(idx)
        print(json.dumps({
            "n": n, "d": d, "leaf": leaf, "ss": ss,
            "tie": var.get("tie", "positional"),
            "max_levels": var.get("max_levels"), "depth": depth,
            "build_s": round(dt, 2),
            "vectors_per_s": round(n / dt),
            "s_per_level": round(dt / max(depth, 1), 3),
        }))


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
