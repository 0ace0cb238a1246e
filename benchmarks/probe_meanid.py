#!/usr/bin/env python
"""Decompose the mean_id tie-break build tax.

``tie_break="mean_id"`` (the reference-parity tie statistic, Stats.cs:26)
costs build throughput over positional ties. Per level it adds,
for each of ``id_limbs`` (5 at 10M) base-2^7 limbs:

  1. limb extraction        — one [N] read of pid + [N] write
  2. [N] int32 cumsum       — read + write
  3. two boundary gathers   — 2*s_max scalar gathers from the [N] prefix

This probe times each piece in isolation on the real device (chained
reps inside one jit, input varied per iteration to defeat CSE, scalar
transfer to sync) plus two candidate replacements:

  stacked   — the 5 prefix arrays stacked [N -> NB=ceil(N/8) blocks] so
              the boundary lookup is ONE [2S]-row gather of a [NB, 8+5]
              table per level instead of 10 scalar-gather passes, with
              intra-block remainders from a shared [2S, 8] pid row gather
  blocked   — per-block limb sums (B=8) + short cumsums, scalar boundary
              gathers from the [NB] prefixes (tests whether gather cost
              scales with source size or index count)

Usage: python benchmarks/probe_meanid.py [--n 10000000] [--reps 10]
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
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--s-live", type=int, default=0,
                    help="live segments (0 = all s_max lanes live)")
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU (a smoke test; no timing value)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax import lax

    from vector_database_tpu.ops.sorted_build import (
        id_limb_plan,
        segment_capacity,
    )

    n = args.n
    bits, limbs = id_limb_plan(n)
    mask = (1 << bits) - 1
    s_max = segment_capacity(n, args.leaf)
    s_live = args.s_live or s_max

    rng = np.random.RandomState(0)
    pid = jnp.asarray(rng.permutation(n).astype(np.int32))
    # s_live equal segments over [0, n); retired lanes start=end=0
    bounds = np.linspace(0, n, s_live + 1).astype(np.int32)
    start = np.zeros(s_max, np.int32)
    ends = np.zeros(s_max, np.int32)
    start[:s_live] = bounds[:-1]
    ends[:s_live] = bounds[1:]
    start = jnp.asarray(start)
    ends = jnp.asarray(ends)
    np.asarray(pid[:1])

    def lc_at(lc, idx):
        v = lc[jnp.clip(idx - 1, 0, n - 1)]
        return jnp.where(idx > 0, v, 0)

    # ---- pieces -------------------------------------------------------
    def extract_cumsum(i, pid, start, ends):
        # extraction + [N] cumsum only; consume the total (no gathers)
        s = jnp.int32(0)
        p = pid ^ i  # defeat cross-iteration CSE
        for l in range(limbs):
            lc = jnp.cumsum(((p >> (bits * l)) & mask).astype(jnp.int32))
            s += lc[-1]
        return s.astype(jnp.float32)

    def full_current(i, pid, start, ends):
        s = jnp.int32(0)
        p = pid ^ i
        for l in range(limbs):
            lc = jnp.cumsum(((p >> (bits * l)) & mask).astype(jnp.int32))
            s += jnp.sum(lc_at(lc, ends) - lc_at(lc, start))
        return s.astype(jnp.float32)

    # precomputed prefixes: gathers only
    lcs = [
        jnp.cumsum(((pid >> (bits * l)) & mask).astype(jnp.int32))
        for l in range(limbs)
    ]
    np.asarray(lcs[-1][-1:])

    def gathers_only(i, lcs, start, ends):
        st = jnp.clip(start + (i & 1), 0, n)  # vary indices, not data
        en = jnp.clip(ends + (i & 1), 0, n)
        s = jnp.int32(0)
        for l in range(limbs):
            s += jnp.sum(lc_at(lcs[l], en) - lc_at(lcs[l], st))
        return s.astype(jnp.float32)

    # ---- candidate: blocked prefixes, scalar boundary gathers ---------
    B = 8
    nb = -(-n // B)

    def blocked(i, pid, start, ends):
        p = (pid ^ i)
        pb = jnp.pad(p, (0, nb * B - n)).reshape(nb, B)
        bi_s, ri_s = start // B, start % B
        bi_e, ri_e = ends // B, ends % B
        # shared intra-block remainder rows (pid raw, limbs extracted on
        # the small [S, B] arrays)
        rows_s = jnp.take(pb, jnp.clip(bi_s, 0, nb - 1), axis=0)
        rows_e = jnp.take(pb, jnp.clip(bi_e, 0, nb - 1), axis=0)
        col = jnp.arange(B, dtype=jnp.int32)[None, :]
        m_s = col < ri_s[:, None]
        m_e = col < ri_e[:, None]
        s = jnp.int32(0)
        for l in range(limbs):
            bs = jnp.sum(((pb >> (bits * l)) & mask).astype(jnp.int32),
                         axis=1)
            bp = jnp.cumsum(bs)  # [nb] inclusive

            def bp_ex(bi, bp=bp):
                v = bp[jnp.clip(bi - 1, 0, nb - 1)]
                return jnp.where(bi > 0, v, 0)

            intra_s = jnp.sum(
                jnp.where(m_s, (rows_s >> (bits * l)) & mask, 0), axis=1
            )
            intra_e = jnp.sum(
                jnp.where(m_e, (rows_e >> (bits * l)) & mask, 0), axis=1
            )
            s += jnp.sum(
                (bp_ex(bi_e) + intra_e) - (bp_ex(bi_s) + intra_s)
            )
        return s.astype(jnp.float32)

    # ---- candidate: stacked block prefixes, ONE row gather ------------
    def stacked(i, pid, start, ends):
        p = (pid ^ i)
        pb = jnp.pad(p, (0, nb * B - n)).reshape(nb, B)
        cols = []
        for l in range(limbs):
            bs = jnp.sum(((pb >> (bits * l)) & mask).astype(jnp.int32),
                         axis=1)
            bp = jnp.cumsum(bs)
            cols.append(jnp.concatenate([jnp.zeros(1, jnp.int32), bp]))
        # [nb+1, B + limbs] table: raw pid block (for the intra sums)
        # beside the exclusive block prefixes — ONE row gather serves
        # every limb at a boundary
        table = jnp.concatenate(
            [jnp.pad(pb, ((1, 0), (0, 0))),
             jnp.stack(cols, axis=1)], axis=1
        )

        def pref(idx):
            bi, ri = idx // B, idx % B
            rows = jnp.take(table, bi + (ri > 0), axis=0)  # row 0 = zeros
            raw = jnp.where(
                jnp.arange(B, dtype=jnp.int32)[None, :] < ri[:, None],
                rows[:, :B], 0,
            )
            out = []
            for l in range(limbs):
                ex = jnp.take(table, bi, axis=0)[:, B + l]
                out.append(
                    ex + jnp.sum((raw >> (bits * l)) & mask, axis=1)
                )
            return out

        st = pref(start)
        en = pref(ends)
        s = jnp.int32(0)
        for l in range(limbs):
            s += jnp.sum(en[l] - st[l])
        return s.astype(jnp.float32)

    def timed(fn, *arrs):
        @jax.jit
        def run(a):
            def body(c, i):
                return c + fn(i, *a, start, ends), None
            acc, _ = lax.scan(
                body, jnp.float32(0),
                jnp.arange(args.reps, dtype=jnp.int32),
            )
            return acc

        r1 = float(run(arrs))  # compile + warm
        t0 = time.time()
        r2 = float(run(arrs))
        assert r1 == r2
        return (time.time() - t0) / args.reps

    out = {"n": n, "bits": bits, "limbs": limbs, "s_max": s_max,
           "s_live": s_live, "B": B}
    out["full_current_ms"] = round(timed(full_current, pid) * 1e3, 2)
    out["extract_cumsum_ms"] = round(timed(extract_cumsum, pid) * 1e3, 2)
    out["gathers_only_ms"] = round(timed(gathers_only, lcs) * 1e3, 2)
    out["blocked_ms"] = round(timed(blocked, pid) * 1e3, 2)
    out["stacked_ms"] = round(timed(stacked, pid) * 1e3, 2)

    # correctness: every variant computes the same segment limb totals
    a = float(full_current(jnp.int32(0), pid, start, ends))
    for name, fn in (("blocked", blocked), ("stacked", stacked)):
        b = float(fn(jnp.int32(0), pid, start, ends))
        assert a == b, (name, a, b)
    out["variants_exact"] = True
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    from vector_database_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    main()
