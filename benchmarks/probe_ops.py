"""Microbenchmark the build's per-level [N]-wide primitives on hardware.

The build's per-level cost is [N]-wide machinery (independent of D and
of stats subsampling where it was first measured). This times each
suspect primitive in isolation (chained inside one jit,
inputs varied per iteration to defeat CSE) to find where the second goes.

Usage: python benchmarks/probe_ops.py [N] [D] [S]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 96
    s = int(sys.argv[3]) if len(sys.argv) > 3 else 625_000
    reps = 10

    import jax
    import jax.numpy as jnp

    print("device:", jax.devices()[0], file=sys.stderr)
    key = jax.random.PRNGKey(0)
    pvec = jax.random.uniform(key, (n, d), jnp.float32)
    p_dim = jax.random.randint(jax.random.PRNGKey(1), (n,), 0, d)
    ps = jax.random.randint(jax.random.PRNGKey(2), (n,), 0, s)
    src = jax.random.permutation(jax.random.PRNGKey(3), n).astype(jnp.int32)
    packA = jax.random.uniform(jax.random.PRNGKey(4), (s, 5), jnp.float32)
    vec1 = jax.random.uniform(jax.random.PRNGKey(5), (n,), jnp.float32)

    def timed(name, fn, *args):
        @jax.jit
        def chained(*a):
            def body(carry, i):
                out = fn(*a, i)
                return carry + jnp.sum(out[:1]).astype(jnp.float32), None

            acc, _ = jax.lax.scan(
                body, jnp.float32(0), jnp.arange(reps, dtype=jnp.int32)
            )
            return acc

        float(chained(*args))  # compile + warm
        t0 = time.time()
        float(chained(*args))
        dt = (time.time() - t0) / reps
        print(json.dumps({"op": name, "ms": round(dt * 1000, 1)}))

    # per-row value on the segment's split dim (phase 2)
    timed(
        "take_along_axis[pvec,p_dim] (N scalar col-gathers)",
        lambda pv, pd, i: jnp.take_along_axis(
            pv, ((pd + i) % d)[:, None], axis=1
        )[:, 0],
        pvec, p_dim,
    )
    # same value via one-hot mask-reduce (streaming alternative)
    timed(
        "onehot mask-reduce value",
        lambda pv, pd, i: jnp.sum(
            pv
            * (
                ((pd + i) % d)[:, None]
                == jnp.arange(d, dtype=jnp.int32)[None, :]
            ),
            axis=1,
        ),
        pvec, p_dim,
    )
    # per-row segment-table lookup (phases 1/3)
    timed(
        "take(packA[S,5], ps) (N row-gathers from table)",
        lambda pa, p, i: jnp.take(pa, (p + i) % s, axis=0),
        packA, ps,
    )
    # whole-matrix row permutation (the per-level partition move)
    timed(
        "pvec[src] ([N,D] row permutation)",
        lambda pv, sr, i: pv[(sr + i) % n],
        pvec, src,
    )
    # [N] f32 cumsum (boundary-difference machinery)
    timed(
        "cumsum[N] f32",
        lambda v, i: jnp.cumsum(v + jnp.float32(i)),
        vec1,
    )
    # [N] int cumsum
    timed(
        "cumsum[N] i32",
        lambda v, i: jnp.cumsum((v + jnp.float32(i)).astype(jnp.int32)),
        vec1,
    )
    # [N,D] elementwise pass (streaming reference point)
    timed(
        "elementwise [N,D] mul",
        lambda pv, i: pv * (jnp.float32(i) + 1.5),
        pvec,
    )
    # scatter [N] (dest write of the permutation)
    timed(
        "scatter zeros[N].at[dest].set",
        lambda sr, i: jnp.zeros((n,), jnp.int32).at[(sr + i) % n].set(1),
        src,
    )


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
