#!/usr/bin/env python
"""Time tile configurations of the GPU bucket-scan kernel.

At one shape (default 9.99M x 96, q = 4096; clustered, unit-normalized,
generated on the device from ``--seed`` as ``chip_smoke.py`` does) the
scan alone is compiled for each ``--tiles`` configuration
(BQ,BM,warps,stages), checked bitwise against the default
configuration's bucket minima, and timed: median of ``--reps`` batches,
each ending in ``block_until_ready``, every configuration warmed first.
The kernel-vs-reference comparison and the timing of both scan routes
through the server are ``chip_smoke.py``'s phases kernel_ref and routes.

    python benchmarks/probe_scan_tiles.py [--shape 9990000x96] [--tiles ...]

Needs a GPU; prints one JSON line per configuration.
"""

import argparse
import json
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import chip_smoke


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="9990000x96")
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tiles", default="128,64,4,3;128,128,8,3;256,64,8,3;"
                    "64,128,4,3;128,64,4,4;128,64,8,2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from vector_database_tpu.ops import pallas_knn as pk
    from vector_database_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    enable_compile_cache()
    print(json.dumps({"device": dev.device_kind,
                      "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)

    n, d = (int(x) for x in args.shape.split("x"))
    vecs, queries = chip_smoke.clustered(jax.random.PRNGKey(args.seed), n,
                                         args.q, d)
    pack = pk.pack_database(vecs)
    del vecs
    qb = jnp.pad(queries, ((0, 0), (0, pack.vb.shape[1] - d))).astype(
        jnp.bfloat16)

    def scan():
        # a fresh jit each time: the tile constants are read at trace time
        f = jax.jit(lambda vn, vb, qb: pk._bucket_scan(
            vn, vb, qb, None, None, bits=pack.bits, m=pack.m,
            q_tile=chip_smoke.Q_TILE, interpret=False))
        return f, np.asarray(f(pack.vn, pack.vb, qb))

    _, ref = scan()
    for cfg in args.tiles.split(";"):
        bq, bm, nw, ns = (int(x) for x in cfg.split(","))
        with mock.patch.multiple(pk, _BQ=bq, _BM=bm, _NUM_WARPS=nw,
                                 _NUM_STAGES=ns):
            try:
                f, acc = scan()
            except Exception as e:  # a configuration the compiler refuses
                print(json.dumps({"tiles": cfg, "refused": repr(e)[:200]}),
                      flush=True)
                continue
        ms = chip_smoke.median_ms(
            lambda: f(pack.vn, pack.vb, qb).block_until_ready(), args.reps)
        print(json.dumps({
            "shape": args.shape, "q": args.q, "tiles": cfg,
            "scan_ms": ms, "equal_to_default": bool(np.array_equal(acc, ref)),
        }), flush=True)


if __name__ == "__main__":
    main()
