#!/usr/bin/env python
"""Probe: the per-level [N] permutation inversion of the fused build.

The partition computes dest[p] (where position p's row moves) and needs
src = dest^-1 (src[i] = which row lands at i) to GATHER the permuted
arrays. Three formulations, timed on device:

  A  src = zeros.at[dest].set(pos)       — current: scatter w/ unique
                                           computed indices (XLA lowers
                                           to a sort of the index pairs)
  B  _, src = lax.sort_key_val(dest, pos) — the same sort, stated
                                           directly (no scatter lowering)
  C  src = jnp.argsort(dest)              — comparator argsort

If B beats A, the fused builder's one remaining scatter can be replaced
one-for-one. Run on the real chip: `python benchmarks/probe_perm.py`.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    reps = 20
    rng = np.random.RandomState(0)
    # realistic dest: a within-segment stable two-way partition permutation
    dest_h = np.arange(n, dtype=np.int32)
    seg = 1 << 14
    for s in range(0, n, seg):
        e = min(s + seg, n)
        low = rng.rand(e - s) < 0.5
        d = np.empty(e - s, np.int32)
        d[low] = s + np.arange(low.sum())
        d[~low] = s + low.sum() + np.arange((~low).sum())
        dest_h[s:e] = d
    dest = jnp.asarray(dest_h)
    pos = jnp.arange(n, dtype=jnp.int32)

    def timed(f):
        g = jax.jit(f)

        def run(d):
            # vary the input per rep: identical scan bodies get CSE'd
            out = g(d)
            return out

        run(dest).block_until_ready()
        t0 = time.time()
        acc = 0
        for r in range(reps):
            acc += int(run(dest + (r & 1))[0])
        dt = (time.time() - t0) / reps
        return dt

    a = timed(lambda d: jnp.zeros((n,), jnp.int32).at[d].set(pos))
    b = timed(lambda d: jax.lax.sort_key_val(d, pos)[1])
    c = timed(lambda d: jnp.argsort(d).astype(jnp.int32))
    print(json.dumps({
        "n": n,
        "scatter_ms": round(a * 1e3, 2),
        "sort_key_val_ms": round(b * 1e3, 2),
        "argsort_ms": round(c * 1e3, 2),
    }))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
