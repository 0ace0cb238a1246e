#!/usr/bin/env python
"""Headline benchmark: build throughput + certified serving QPS/recall.

The reference's only published number is the deep-image-96-angular build —
~10M vectors x 96 dims in ~3 minutes on a laptop (reference README.md:93-100;
BASELINE.md), i.e. ~55.6k vectors/s; its recall/QPS benchmark was intended
but never implemented (README.md:102-103). This harness measures, on one
chip, in one run:

- **index build throughput** (fused single-compile builder, uniform data —
  the builder is data-oblivious) — the ``metric``/``value``/``vs_baseline``
  headline fields, comparable across rounds;
- **sharded build throughput** (``build_index_sharded`` over a mesh of all
  visible devices — the SPMD >memory-per-device program);
- **serving QPS + recall@10** on clustered data (the deep-image stand-in;
  uniform 96-d data has no neighbor structure and benchmarks nothing):
  full packed scan and the pruned scan at several probes operating points
  via the runtime-probes program (ONE compile for all of them). QPS is
  steady-state: batches chained inside one jit (``lax.scan``), each timed
  window ending in ``block_until_ready``.

Prints exactly ONE JSON line, naming the device it ran on; a failed
phase raises (non-zero exit). Primary fields stay build throughput for
cross-round comparability; serving certification rides as extra fields
(``serve_full_qps``, ``serve_full_recall``, ``serve_pruned`` operating
points, and the ``serve_headline_*`` = best QPS at recall >= 0.95).

Environment knobs: VDB_BENCH_N (rows), VDB_BENCH_D (dims),
VDB_BENCH_LEAF (leaf bucket size), VDB_BENCH_TIE=mean_id (the
reference-parity tie-break), VDB_BENCH_SHARDED=1 (time the PRIMARY build
through the SPMD path instead), VDB_BENCH_INGEST=1 (ingest-inclusive
primary build), VDB_BENCH_SHARDED_FIELD=0 / VDB_BENCH_SERVE=0 (skip the
extra sections), VDB_BENCH_Q (serving batch, default 4096 — pruning is a
batch mode; the knee needs tile diversity), VDB_BENCH_TRUTH_Q (queries
scored against the exact oracle, default 1024), VDB_BENCH_PROBES
(comma list, default "192,256,320"), VDB_BENCH_BUCKETS (shortlist
buckets m for the serve pack; default 4096).
"""

import json
import os
import sys
import time

import numpy as np


def main():
    n = int(os.environ.get("VDB_BENCH_N", 10_000_000))
    d = int(os.environ.get("VDB_BENCH_D", 96))
    leaf = int(os.environ.get("VDB_BENCH_LEAF", 16))
    tie = os.environ.get("VDB_BENCH_TIE", "positional")
    sharded = os.environ.get("VDB_BENCH_SHARDED", "") == "1"
    ingest = os.environ.get("VDB_BENCH_INGEST", "") == "1"
    want_sharded_field = (
        os.environ.get("VDB_BENCH_SHARDED_FIELD", "1") == "1" and not sharded
    )
    want_serve = os.environ.get("VDB_BENCH_SERVE", "1") == "1"
    serve_q = int(os.environ.get("VDB_BENCH_Q", 4096))
    truth_q = int(os.environ.get("VDB_BENCH_TRUTH_Q", 1024))
    probes_list = [
        int(x)
        for x in os.environ.get("VDB_BENCH_PROBES", "192,256,320").split(",")
    ]
    serve_reps = int(os.environ.get("VDB_BENCH_SERVE_REPS", 20))

    import jax
    import jax.numpy as jnp

    from vector_database_tpu import build_index_fused
    from vector_database_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    out = _device_fields()

    # ---- primary build benchmark --------------------------------------
    # Generate the dataset on device: the benchmark measures the build, not
    # host->device ingest (the reference's ~3 min likewise excludes the HDF5
    # parse, Program.cs:133-152). The input buffer is donated into the build
    # (the builder permutes it in place), so regenerate per run.
    # VDB_BENCH_INGEST=1 instead starts from a HOST numpy array and times
    # the double-buffered host->HBM stream + build together.
    if ingest:
        from vector_database_tpu.runtime.native_store import (
            stream_rows_to_device,
        )

        def stream_in(host):
            return stream_rows_to_device(
                lambda s, rows: host[s:s + rows], n, d
            )

        def make(seed):
            rng = np.random.RandomState(seed)
            return rng.rand(n, d).astype(np.float32) * 2.0 - 1.0
    else:
        def make(seed):
            v = (
                jax.random.uniform(
                    jax.random.PRNGKey(seed), (n, d), jnp.float32
                )
                * 2.0 - 1.0
            )
            return v.block_until_ready()

    def drop(idx):
        for buf in (idx.vectors, idx.orig_row, idx.dim, idx.mid, idx.low,
                    idx.high, idx.leaf_start, idx.leaf_count):
            buf.delete()

    mesh = None
    if sharded or want_sharded_field:
        from vector_database_tpu.parallel import (
            build_index_sharded,
            make_mesh,
        )

        mesh = make_mesh()

        def build_shard(vecs):
            return build_index_sharded(
                vecs, mesh, leaf_size=leaf, donate=True, tie_break=tie
            )

    if sharded:
        build = build_shard
    else:
        def build(vecs):
            return build_index_fused(
                vecs, leaf_size=leaf, donate=True, tie_break=tie
            )

    if ingest:
        base_build = build

        def build(host):
            return base_build(stream_in(host))

    # Warm-up: compile the build program; free its outputs before the
    # timed run (at 10M the index's vector copy is ~5G of HBM).
    idx = build(make(0))
    jax.block_until_ready(idx.orig_row)
    drop(idx)

    # best of two timed builds
    dt = float("inf")
    for seed in (1, 2):
        vecs = make(seed)
        t0 = time.time()
        idx = build(vecs)
        jax.block_until_ready((idx.orig_row, idx.vectors))
        dt = min(dt, time.time() - t0)
        drop(idx)

    reference_rate = 10_000_000 / 180.0  # README.md:93-100
    rate = n / dt
    tag = ("_sharded" if sharded else "") + ("_ingest" if ingest else "")
    out.update({
        "metric": f"index_build_throughput_{d}d_n{n}_leaf{leaf}{tag}",
        "value": round(rate, 1),
        "unit": "vectors/s",
        "vs_baseline": round(rate / reference_rate, 3),
    })

    # ---- sharded-build field -------------------------------------------
    if want_sharded_field:
        def drop_sharded(sidx):
            for buf in (sidx.vectors, sidx.orig_row, sidx.dim,
                        sidx.mid, sidx.low, sidx.high,
                        sidx.leaf_start, sidx.leaf_count):
                buf.delete()

        # warm up: the first call compiles
        sidx = build_shard(make(3))
        jax.block_until_ready(sidx.orig_row)
        drop_sharded(sidx)
        vecs = make(4)
        t0 = time.time()
        sidx = build_shard(vecs)
        jax.block_until_ready((sidx.orig_row, sidx.vectors))
        s_dt = time.time() - t0
        drop_sharded(sidx)
        out["build_sharded_vps"] = round(n / s_dt, 1)
        out["build_sharded_devices"] = int(
            np.prod(list(mesh.shape.values()))
        )

    # ---- serving certification -------------------------------------------
    if want_serve:
        out.update(_serve_bench(
            n, d, leaf, serve_q, truth_q, probes_list, serve_reps,
            buckets=int(os.environ.get("VDB_BENCH_BUCKETS", 4096)),
        ))

    print(json.dumps(out))


def _serve_bench(n, d, leaf, q, truth_q, probes_list, reps, buckets=4096):
    """Clustered-data serving: full packed scan + pruned operating points.

    Returns the extra JSON fields. Clustered c = n/1000, sigma 0.05 —
    the synthetic stand-in for deep-image's neighbor structure used by
    every recall number in this repo (benchmarks/recall_qps.py)."""
    import jax
    import jax.numpy as jnp

    from vector_database_tpu import build_index_fused, exact_knn
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
        pallas_scan_knn_packed_rt,
    )

    k = 10
    c = max(64, n // 1000)
    centers = (
        jax.random.uniform(jax.random.PRNGKey(10), (c, d), jnp.float32)
        * 2 - 1
    )
    assign = jax.random.randint(jax.random.PRNGKey(11), (n,), 0, c)
    train = centers[assign] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(12), (n, d), jnp.float32
    )
    test = centers[
        jax.random.randint(jax.random.PRNGKey(13), (q,), 0, c)
    ] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(14), (q, d), jnp.float32
    )
    test = jnp.asarray(np.asarray(test))  # host copy -> fresh device buf
    index = build_index_fused(train, leaf_size=leaf, donate=True)
    # serving reads only the leaf-major matrix; free the node tables
    for buf in (index.orig_row, index.dim, index.mid, index.low,
                index.high, index.leaf_start, index.leaf_count):
        buf.delete()
    vectors = index.vectors

    # exact oracle on a subset (HIGHEST-precision streamed scan): recall
    # noise at truth_q=1024, k=10 is ~0.3 pt — plenty for a 0.95 gate
    truth = np.asarray(exact_knn(vectors, test[:truth_q], k=k)[0])
    want = [set(r.tolist()) for r in truth]
    denom = max(1, sum(len(w) for w in want))

    def recall(rows):
        rows = np.asarray(rows)[:truth_q]
        return sum(
            len(set(rows[i].tolist()) & want[i])
            for i in range(len(want))
        ) / denom

    t0 = time.time()
    pack = pack_database(vectors, buckets=buckets)
    jax.block_until_ready(pack.vb)
    pack_s = time.time() - t0

    q_tile = min(512, max(256, q))
    qstack = jnp.broadcast_to(test, (reps, *test.shape))

    def chain(fn):
        @jax.jit
        def chained(pk, qs, p):
            def body(carry, batch):
                rows, _ = fn(pk, batch, p)
                return carry + jnp.sum(rows).astype(jnp.float32), None
            acc, _ = jax.lax.scan(body, jnp.float32(0), qs)
            return acc

        return chained

    # full scan: QPS (chained) + recall (one plain call)
    full_chained = chain(
        lambda pk, qs, p: pallas_scan_knn_packed(
            pk, qs, k=k, q_tile=q_tile
        )
    )
    full_chained(pack, qstack, 0).block_until_ready()  # compile + warm
    t0 = time.time()
    full_chained(pack, qstack, 0).block_until_ready()
    full_qps = q * reps / (time.time() - t0)
    rows, _ = pallas_scan_knn_packed(pack, test, k=k, q_tile=q_tile)
    full_recall = recall(rows)

    fields = {
        "serve_n": n,
        "serve_q": q,
        "serve_buckets": buckets,
        "serve_pack_s": round(pack_s, 2),
        "serve_full_qps": round(full_qps),
        "serve_full_recall": round(full_recall, 4),
    }

    # pruned operating points through ONE runtime-probes program
    nb = pack.vb.shape[0]
    pts = sorted({min(p, nb) for p in probes_list})
    pmax = max(pts)
    if pmax < nb:  # pruning only makes sense with blocks to skip
        rt_chained = chain(
            lambda pk, qs, p: pallas_scan_knn_packed_rt(
                pk, qs, p, k=k, probes_max=pmax, q_tile=q_tile
            )
        )
        pruned = []
        warm = False
        for p in pts:
            pj = jnp.int32(p)
            if not warm:
                # ONE compile for all p
                rt_chained(pack, qstack, pj).block_until_ready()
                warm = True
            t0 = time.time()
            rt_chained(pack, qstack, pj).block_until_ready()
            qps = q * reps / (time.time() - t0)
            rows, _ = pallas_scan_knn_packed_rt(
                pack, test, pj, k=k, probes_max=pmax, q_tile=q_tile
            )
            pruned.append({
                "probes": p,
                "stream_fraction": round(p / nb, 4),
                "qps": round(qps),
                "recall": round(recall(rows), 4),
            })
        fields["serve_pruned"] = pruned
        ok = [pt for pt in pruned if pt["recall"] >= 0.95]
        ok.append({"probes": nb, "qps": round(full_qps),
                   "recall": round(full_recall, 4)})
        best = max(ok, key=lambda pt: pt["qps"])
        fields["serve_headline_qps"] = best["qps"]
        fields["serve_headline_recall"] = best["recall"]
        fields["serve_headline_probes"] = best["probes"]

    # ---- sharded serving: full + the headline pruned point over the mesh
    # serving path; the pruned point rides the sharded RUNTIME-probes
    # program
    if os.environ.get("VDB_BENCH_SERVE_SHARDED", "1") == "1":
        headline_p = None
        if "serve_headline_probes" in fields and \
                fields["serve_headline_probes"] < nb:
            headline_p = fields["serve_headline_probes"]
        elif pts and pts[0] < nb:
            headline_p = pts[len(pts) // 2]
        fields.update(_serve_sharded_leg(
            pack, vectors, test, qstack, recall, k=k, q_tile=q_tile,
            buckets=buckets, reps=reps, q=q, n=n, probes=headline_p,
        ))
    return fields


def _serve_sharded_leg(pack, vectors, test, qstack, recall, *, k, q_tile,
                       buckets, reps, q, n, probes):
    """Mesh serving certification: pack_database_sharded + the shard_map
    serving program (parallel/scan.py), full scan + ONE pruned operating
    point through the sharded runtime-probes program. On one device this
    records the pure SPMD overhead; on P devices the same program is the
    QPS multiplier. Frees the single-device pack first and donates the
    rerank matrix into the reshard, so the device holds index.vectors +
    the sharded pack, not a third copy."""
    import jax
    import jax.numpy as jnp

    from vector_database_tpu.parallel import make_mesh, pack_database_sharded
    from vector_database_tpu.parallel.forest import merge_topk
    from vector_database_tpu.parallel.scan import _sharded_serve_fn

    for buf in (pack.vb, pack.vn):
        buf.delete()
    if pack.cent is not None:
        pack.cent.delete()
        pack.rad.delete()

    mesh = make_mesh()
    t0 = time.time()
    sdb = pack_database_sharded(
        vectors, mesh, buckets=buckets, donate=n > 2_000_000
    )
    jax.block_until_ready(sdb.vb)
    fields = {
        "serve_sharded_devices": int(np.prod(list(mesh.shape.values()))),
        "serve_sharded_pack_s": round(time.time() - t0, 2),
    }
    nb_loc = sdb.vb.shape[1]
    db = (sdb.vb, sdb.vn, sdb.vectors, sdb.orig_row, sdb.cent, sdb.rad)

    def chain(serve, rt):
        @jax.jit
        def chained(db, qs, p):
            vb, vn, vecs, orig, cent, rad = db

            def body(carry, batch):
                extra = (p,) if rt else ()
                rows_p, key_p = serve(vb, vn, vecs, orig, batch, cent,
                                      rad, *extra)
                rows, _ = merge_topk(rows_p, key_p, k=k)
                return carry + jnp.sum(rows).astype(jnp.float32), None

            acc, _ = jax.lax.scan(body, jnp.float32(0), qs)
            return acc

        return chained

    serve = _sharded_serve_fn(
        mesh, sdb.axis, sdb.n_loc, sdb.block, sdb.m, sdb.bits,
        sdb.metric, k, q_tile, None, False, None, None,
    )
    full_chained = chain(serve, rt=False)
    full_chained(db, qstack, jnp.int32(0)).block_until_ready()
    t0 = time.time()
    full_chained(db, qstack, jnp.int32(0)).block_until_ready()
    fields["serve_sharded_full_qps"] = round(q * reps / (time.time() - t0))
    rows_p, key_p = serve(*db[:4], test, *db[4:])
    rows, _ = merge_topk(rows_p, key_p, k=k)
    fields["serve_sharded_full_recall"] = round(recall(rows), 4)

    if probes is not None and probes < nb_loc:
        pserve = _sharded_serve_fn(
            mesh, sdb.axis, sdb.n_loc, sdb.block, sdb.m, sdb.bits,
            sdb.metric, k, q_tile, None, False, None, nb_loc,
        )
        pj = jnp.int32(probes)
        rt_chained = chain(pserve, rt=True)
        rt_chained(db, qstack, pj).block_until_ready()
        t0 = time.time()
        rt_chained(db, qstack, pj).block_until_ready()
        rows_p, key_p = pserve(*db[:4], test, *db[4:], pj)
        rows, _ = merge_topk(rows_p, key_p, k=k)
        fields["serve_sharded_pruned"] = {
            "probes": probes,
            "qps": round(q * reps / (time.time() - t0)),
            "recall": round(recall(rows), 4),
        }
    return fields


def _device_fields():
    """The device every number was taken on; fails off an accelerator."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("bench.py: no accelerator found (JAX platform cpu)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in smi.split(","))
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": name,
        "power_limit": power,
    }


if __name__ == "__main__":
    sys.exit(main())
