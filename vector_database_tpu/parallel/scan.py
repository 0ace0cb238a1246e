"""Sharded bucket-scan serving: the multi-device QPS multiplier.

The single-device serving path streams the whole packed database through
one device's memory per batch (``ops/pallas_knn.py``) — its QPS ceiling is
that device's scan rate. The measured crossover (benchmarks/crossover.py)
says the BSP tree prunes nothing at >=16 effective dimensions, so past one
device's ceiling the ONLY lever for the high-dimensional engine is to
shard the *database rows* across the mesh:

- each device owns ``n / P`` rows, packed ONCE into its local transposed
  bf16 block layout (``pack_database_sharded`` runs the pack inside
  ``shard_map`` — rows never leave their shard);
- a query batch is replicated; every device runs the full single-device
  serving program (bucket scan + exact f32 rerank + local top-k) against
  its 1/P-th of the stream — P x the aggregate memory bandwidth and
  matrix throughput;
- the per-shard ``[Q, k]`` results (already mapped to GLOBAL row ids)
  merge with one all-gather top-k (``merge_topk``) — the only
  cross-device traffic, O(P * Q * k).

Exactness matches the single-device path: every member of the global top-k
is in its own shard's local top-k, so the union contains the exact answer
(up to the same per-shard bucket-selection recall, which *improves* with P
— fewer rows compete per bucket).

The per-shard scan takes the platform's route (``scan_route``): the GPU
kernel on GPUs, the plain XLA scan on the CPU — the same program runs on
the 8-virtual-device CPU mesh of the tests. This is the distributed form
of the serving answer to the
reference's intended qdrant-style benchmarks (reference README.md:102-103);
the reference itself has no distributed story (README.md:89-98).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vector_database_tpu.ops.pallas_knn import (
    DEFAULT_D_ALIGN,
    PackedDB,
    _cell_summary_body,
    _round_up,
    _scan_knn_packed_impl,
    _summary_cell,
)
from vector_database_tpu.parallel.forest import merge_topk


@dataclasses.dataclass
class ShardedPackedDB:
    """A database row-sharded over ``mesh[axis]``, packed per shard.

    ``vb``/``vn`` are the per-shard transposed bf16 block layout and norm
    rows (see ``ops/pallas_knn.py``); ``vectors`` the per-shard f32 rerank
    rows (+inf padding past the real rows); ``orig_row`` maps each local
    row to its global id (-1 padding). All carry a leading shard dim
    placed over ``mesh[axis]`` — each device holds only its slice.
    """

    vb: jax.Array  # [Pq, nb, D_pad, block] bf16
    vn: jax.Array  # [Pq, nb, 1, block] f32
    vectors: jax.Array  # [Pq, n_loc, D] f32, +inf pad rows
    orig_row: jax.Array  # [Pq, n_loc] int32 global rows, -1 pad
    n: int  # global row count
    n_loc: int  # rows per shard (uniform)
    block: int
    m: int
    bits: int
    metric: str
    mesh: Mesh
    axis: str
    # per-shard pruning summaries (probes=): cell centroids + radii
    cent: jax.Array | None = None  # [Pq, nc, D] f32
    rad: jax.Array | None = None  # [Pq, nc] f32

    @property
    def num_shards(self) -> int:
        return self.vb.shape[0]


@functools.lru_cache(maxsize=None)
def _pad_reshard_fn(mesh: Mesh, axis: str, n: int, d: int, shards: int,
                    n_loc: int, cosine: bool):
    """jit(normalize + +inf row-pad + ``[P, n_loc, d]`` reshard) in ONE
    step. Memory discipline: at 10M x 96 each database copy is ~4-5 GB of
    HBM, so the pack pipeline must never hold more than two at once —
    this step's residents are exactly {input, resharded output}; the
    ``donate`` path deletes the input right after dispatch. Buffer
    donation can't help here: the row pad changes the buffer
    size, so XLA could never alias input and output."""

    def pad(v):
        v = jnp.asarray(v, jnp.float32)
        if cosine:
            from vector_database_tpu.ops.exact import normalize_rows

            v = normalize_rows(v)
        # +inf pad rows: never selected by the rerank (distance = inf),
        # zeroed before entering the packed blocks by the shard pack
        v = jnp.pad(
            v, ((0, shards * n_loc - n), (0, 0)),
            constant_values=jnp.inf,
        )
        return v.reshape(shards, n_loc, d)

    return jax.jit(
        pad,
        out_shardings=NamedSharding(mesh, P(axis, None, None)),
    )


@functools.lru_cache(maxsize=None)
def _pack_sharded_fn(mesh: Mesh, axis: str, n_loc: int, d: int,
                     block: int, d_align: int, ip: bool):
    """jit(shard_map(local pack)): each shard packs its own rows — no
    host round-trip, no row ever crossing a shard boundary. Takes the
    already-resharded ``[P, n_loc, d]`` rerank array (which stays alive
    as ``ShardedPackedDB.vectors``) and emits only the bf16 blocks +
    norm rows, so this step's big residents are {rerank array, blocks}."""
    d_pad = _round_up(d, d_align)
    n_pad = _round_up(n_loc, block)
    nb = n_pad // block
    scale = -1.0 if ip else -2.0
    cell = _summary_cell(block)
    cpb = block // cell

    def local(vp, nv):
        vp, nv = vp[0], nv[0]
        if n_loc < block:
            # tiny shard: one partial block — pad it up (cheap) so the
            # blockwise path below never slices out of bounds
            vp = jnp.pad(vp, ((0, block - n_loc), (0, 0)))

        # ENTIRELY blockwise: the whole shard pack (zeroing, norm row,
        # bf16 transpose, pruning summaries) runs inside ONE lax.map so
        # no full-size f32 temporary ever materializes. The previous
        # whole-shard formulation held TWO [n_pad, d_pad] f32 copies
        # (the d-padded input + its zeroed twin, ~4 GB each at
        # 10M x 96) next to the rerank array and the bf16 blocks.
        # Blockwise peak is {rerank array, bf16 blocks, per-block
        # transients}.
        #
        # The last block may be partial; rather than padding the shard
        # to n_pad (a full copy — XLA materializes pads), its slice
        # start is CLAMPED in-bounds and rows that re-read the previous
        # block's tail are masked out alongside the cross-shard +inf
        # padding (an inf column would otherwise produce -inf scores
        # that win every bucket).
        rows_total = vp.shape[0]

        def one(i):
            st = jnp.maximum(
                jnp.minimum(i * block, rows_total - block), 0
            )
            # position p of block i MUST hold row i*block + p — the
            # serve kernel reconstructs ids that way — so the clamped
            # slice is rolled left by the clamp offset (its wrapped
            # tail re-reads earlier rows; `real` masks it out along
            # with rows past the shard's valid count)
            blk = jax.lax.dynamic_slice(vp, (st, 0), (block, d))
            blk = jnp.roll(blk, st - i * block, axis=0)
            rows = i * block + jnp.arange(block)
            real = rows < nv
            blk = jnp.pad(blk, ((0, 0), (0, d_pad - d)))
            vz = jnp.where(real[:, None], blk, 0.0)
            vnb = (
                jnp.zeros((block,))
                if ip else jnp.sum(vz * vz, axis=1)
            )
            vnb = jnp.where(real, vnb, jnp.float32(3.0e38))
            vbb = jnp.swapaxes((scale * vz).astype(jnp.bfloat16), 0, 1)
            cent, rad = _cell_summary_body(vz, real, cpb=cpb, cell=cell)
            return vbb, vnb, cent, rad

        vb, vn, cent, rad = jax.lax.map(one, jnp.arange(nb))
        cent = cent.reshape(nb * cpb, d_pad)[:, :d]
        return (
            vb[None], vn.reshape(nb, 1, block)[None],
            cent[None], rad.reshape(nb * cpb)[None],
        )

    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis)),
        out_specs=(
            P(axis, None, None, None), P(axis, None, None),
            P(axis, None, None), P(axis, None),
        ),
    )
    return jax.jit(smapped)


def pack_database_sharded(
    vectors,
    mesh: Mesh,
    *,
    axis: str = "data",
    block: int = 8192,
    buckets: int = 4096,
    d_align: int = DEFAULT_D_ALIGN,
    metric: str = "l2",
    orig_rows=None,
    donate: bool = False,
) -> ShardedPackedDB:
    """Row-shard ``vectors`` over ``mesh[axis]`` and pack each shard once.

    ``vectors`` may be a host array or an already row-sharded device
    array; rows are split into P contiguous blocks. ``orig_rows``
    optionally maps input rows to external ids (defaults to
    ``arange(n)``; a ``BSPIndex``'s ``orig_row`` when serving a
    leaf-major matrix). ``buckets``/``block``/``d_align`` as in
    ``pack_database``.

    ``donate=True`` (device-array input only) frees the caller's buffer
    as soon as the resharded copy exists — at 10M x 96 the input, the
    rerank copy, and the bf16 blocks are ~4 + 4 + 2 GB, so a device
    short of memory need not hold an extra copy during the pack.
    """
    if metric not in ("l2", "cosine", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    on_device = isinstance(vectors, jax.Array)
    n, d = vectors.shape
    if n == 0:
        # parity with pack_database: a zero-block pack has nothing to scan
        raise ValueError("pack_database_sharded: empty database (0 rows)")
    m = min(buckets, block)
    if block % m:
        raise ValueError("block must be a multiple of buckets")
    shards = mesh.shape[axis]
    n_loc = -(-n // shards)
    n_pad_rows = n_loc * shards
    nb = _round_up(n_loc, block) // block
    bits = max(1, (nb - 1).bit_length())
    if bits > 16:
        raise ValueError(
            "shard too large for this block size: raise `block` so the "
            "per-shard block count stays <= 65536"
        )

    if orig_rows is None:
        orig_rows = np.arange(n, dtype=np.int32)
    orig = np.full((n_pad_rows,), -1, np.int32)
    orig[:n] = np.asarray(orig_rows, np.int32)
    n_valid = np.clip(n - n_loc * np.arange(shards), 0, n_loc).astype(
        np.int32
    )
    # Ship the small host arrays FIRST: once the reshard + pack below are
    # dispatched, device memory transiently holds the donated input
    # (freed only past in-flight usage), the rerank copy, pack relayout
    # temps, and the blocks — the peak a small device-put would add to.
    orig_sh = jax.device_put(
        orig.reshape(shards, n_loc), NamedSharding(mesh, P(axis, None))
    )
    nv = jax.device_put(
        jnp.asarray(n_valid), NamedSharding(mesh, P(axis))
    )
    if on_device:
        # already on device: normalize/pad/reshard there in one step —
        # no host round-trip of the whole matrix
        vecs_sh = _pad_reshard_fn(
            mesh, axis, n, d, shards, n_loc, metric == "cosine",
        )(vectors)
        if donate:
            # free the caller's copy as soon as the reshard is dispatched
            # (PjRt defers the actual free past in-flight usage)
            vectors.delete()
    else:
        host = np.asarray(vectors, np.float32)
        if metric == "cosine":
            norms = np.linalg.norm(host, axis=1, keepdims=True)
            host = host / np.maximum(norms, 1e-30)
        vp = np.full((n_pad_rows, d), np.inf, np.float32)
        vp[:n] = host
        vecs_sh = jax.device_put(
            vp.reshape(shards, n_loc, d),
            NamedSharding(mesh, P(axis, None, None)),
        )

    vb, vn, cent, rad = _pack_sharded_fn(
        mesh, axis, n_loc, d, block, d_align, metric == "ip"
    )(vecs_sh, nv)
    return ShardedPackedDB(
        vb=vb, vn=vn, vectors=vecs_sh, orig_row=orig_sh,
        n=n, n_loc=n_loc, block=block, m=m, bits=bits, metric=metric,
        mesh=mesh, axis=axis, cent=cent, rad=rad,
    )


@functools.lru_cache(maxsize=None)
def _sharded_serve_fn(mesh: Mesh, axis: str, n_loc: int, block: int,
                      m: int, bits: int, metric: str, k: int, q_tile: int,
                      oversample, interpret, probes=None,
                      probes_max=None):
    """jit(shard_map(single-device serve + global-id map)) — traced once
    per configuration; queries are replicated arguments. ``probes``
    enables the pruned scan PER SHARD (each shard streams only that many
    of its LOCAL blocks per query tile; pass a per-shard count).
    ``probes_max`` instead compiles the RUNTIME-probes per-shard program
    (as ``pallas_scan_knn_packed_rt``): the returned fn takes a trailing
    replicated
    int32 scalar — every per-shard probes value in [1, probes_max]
    shares this one program (the sharded twin of
    ``pallas_scan_knn_packed_rt``)."""

    def local(vb, vn, vectors, orig, q, cent, rad, *np_rt):
        vb, vn, vectors, orig = vb[0], vn[0], vectors[0], orig[0]
        cent, rad = cent[0], rad[0]
        pack = PackedDB(
            vb=vb, vn=vn, vectors=vectors, n=n_loc, block=block, m=m,
            bits=bits, metric=metric, cent=cent, rad=rad,
        )
        rows, key = _scan_knn_packed_impl(
            pack, q, k=k, q_tile=q_tile, oversample=oversample,
            probes=np_rt[0] if probes_max is not None else probes,
            probes_max=probes_max, interpret=interpret,
        )
        if metric == "ip":
            # merge ascending on -dot; padding -inf dots -> +inf keys
            key = jnp.where(jnp.isfinite(key), -key, jnp.inf)
        grows = jnp.where(
            rows >= 0, orig[jnp.clip(rows, 0, n_loc - 1)], -1
        )
        return grows[None], key[None]

    in_specs = [
        P(axis, None, None, None), P(axis, None, None),
        P(axis, None, None), P(axis, None), P(),
        P(axis, None, None), P(axis, None),
    ]
    if probes_max is not None:
        in_specs.append(P())  # the replicated runtime probes scalar
    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(axis, None, None), P(axis, None, None)),
        # pallas_call's out ShapeDtypeStructs carry no vma annotation;
        # the kernel consumes only shard-local data, so the varying-axis
        # check adds nothing here
        check_vma=False,
    )
    return jax.jit(smapped)


def sharded_scan_knn(
    db: ShardedPackedDB,
    queries,
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
    probes_max: int | None = None,
    interpret: bool = False,
):
    """k-NN over the sharded packed database: every shard scans its rows
    against the replicated query batch, the ``[P, Q, k]`` shard results
    merge with one all-gather top-k. Returns ``(rows [Q, k], sq_dists)``
    with global row ids (``metric="ip"``: exact dots, highest first).

    ``probes``: the pruned scan per shard — each shard streams only that
    many of its LOCAL blocks per query tile (cell-centroid selection,
    see ``pallas_scan_knn_packed``); composes the mesh multiplier with
    the pruning multiplier.

    ``probes_max``: makes ``probes`` a RUNTIME value bounded by this
    static width — every per-shard probes value in [1, probes_max]
    then shares ONE compiled program, bitwise-equal to the static call
    (the sharded twin of ``pallas_scan_knn_packed_rt``). A fleet
    retuning probes (``calibrate_probes_sharded``) compiles no program
    per value. ``interpret=True`` runs the GPU kernel in the Pallas
    interpreter (tests).
    """
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    nb_loc = db.vb.shape[1]
    if probes_max is not None:
        if probes is None:
            raise ValueError("probes_max requires probes")
        probes_max = min(probes_max, nb_loc)
    elif probes is not None and probes >= nb_loc:
        probes = None  # full per-shard coverage == the exact full scan
    cent, rad = db.cent, db.rad
    if cent is None:
        if probes is not None:
            raise ValueError(
                "probes= needs per-shard summaries; re-pack with this "
                "version's pack_database_sharded"
            )
        # placeholder summaries so the shard_map signature is uniform
        # (never read when probes is None); the -3e38 radius marks them
        cent = jax.device_put(
            jnp.zeros((db.num_shards, 1, queries.shape[1]), jnp.float32),
            NamedSharding(db.mesh, P(db.axis, None, None)),
        )
        rad = jax.device_put(
            jnp.full((db.num_shards, 1), -3.0e38, jnp.float32),
            NamedSharding(db.mesh, P(db.axis, None)),
        )
    fn = _sharded_serve_fn(
        db.mesh, db.axis, db.n_loc, db.block, db.m, db.bits, db.metric,
        k, q_tile, oversample, interpret,
        None if probes_max is not None else probes, probes_max,
    )
    args = [db.vb, db.vn, db.vectors, db.orig_row, queries, cent, rad]
    if probes_max is not None:
        args.append(jnp.asarray(probes, jnp.int32))
    rows_p, key_p = fn(*args)
    rows, key = merge_topk(rows_p, key_p, k=k)
    if db.metric == "ip":
        return rows, jnp.where(jnp.isfinite(key), -key, -jnp.inf)
    return rows, key


def calibrate_probes_sharded(
    db: ShardedPackedDB,
    sample_queries,
    k: int,
    target_recall: float = 0.95,
    *,
    q_tile: int = 256,
    oversample: int | None = None,
    probes_max: int | None = None,
    interpret: bool = False,
) -> int:
    """Smallest PER-SHARD ``probes`` whose recall@k on ``sample_queries``
    (against this sharded pack's own full scan) meets ``target_recall``
    — the mesh twin of ``calibrate_probes``. Compiles exactly TWO
    programs regardless of how many probes values the binary search
    visits: the sharded full scan + ONE runtime-probes sharded program
    (``sharded_scan_knn(probes_max=)``), so a fleet deploy never compiles
    a program per candidate value. Serve the result through either
    entry — static ``probes=`` or the already-compiled ``probes_max=``
    program (bitwise-equal, tested)."""
    q = jnp.atleast_2d(jnp.asarray(sample_queries, jnp.float32))
    nb_loc = db.vb.shape[1]
    if nb_loc <= 1 or target_recall <= 0:
        return nb_loc
    pmax = nb_loc if probes_max is None else min(probes_max, nb_loc)
    full, _ = sharded_scan_knn(
        db, q, k=k, q_tile=q_tile, oversample=oversample,
        interpret=interpret,
    )
    full = np.asarray(full)
    want = [set(r.tolist()) - {-1} for r in full]
    denom = max(1, sum(len(w) for w in want))
    seen: dict = {}

    def recall_at(p: int) -> float:
        if p not in seen:  # a repeat would be a whole serving call
            rows, _ = sharded_scan_knn(
                db, q, k=k, q_tile=q_tile, oversample=oversample,
                probes=p, probes_max=pmax, interpret=interpret,
            )
            rows = np.asarray(rows)
            seen[p] = sum(
                len(set(rows[i].tolist()) & want[i])
                for i in range(len(want))
            ) / denom
        return seen[p]

    lo, hi = 1, pmax
    if pmax < nb_loc and recall_at(pmax) < target_recall:
        # capped search can't hit the target; return the cap (the best
        # available operating point) rather than a misleading interior
        return pmax
    while lo < hi:
        mid = (lo + hi) // 2
        if recall_at(mid) >= target_recall:
            hi = mid
        else:
            lo = mid + 1
    return lo
