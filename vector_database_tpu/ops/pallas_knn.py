"""Fused k-NN bucket scan — the serving hot path.

Every query batch streams the whole packed database (or, pruned, a chosen
subset of its blocks) and keeps, for each query and each of ``m``
interleaved buckets (bucket = database column mod m), the minimum score
over the database together with the index of the *block* it came from:

  for each database block b:
      for each m-wide column slice j of the block:
          score_j = |v|^2 + q . vb[b][:, j]       (bf16 operands, f32 sum)
      acc = min(acc, pack(min_j score_j, b))       (block id in the mantissa)

- the -2 is folded into the packed blocks (``vb = -2v``, exact in bf16),
  so the score is one add on top of the dot;
- the per-query |q|^2 term is dropped — it never changes a comparison, and
  raw f32 values (negative ones included) order correctly;
- the block id rides the low ``bits`` mantissa bits of the f32 minimum
  (a 2^-(23 - bits) relative perturbation of selection). The winning
  bucket keeps ``w = block/m`` candidate rows (one per slice), and the
  exact f32 rerank outside the scan examines all of them.

One ``[Q, m]`` accumulator leaves the scan, so writes and the top-k stay
O(m) per query at any database size.

Two implementations compute that accumulator (``scan_route`` picks one
per platform):

- ``"triton"`` — a Pallas kernel through Triton for the GPU. The grid is
  (query tiles, m / BM); each program owns BQ queries x BM buckets, walks
  the blocks (all, or its pruning tile's block list up to a runtime
  count) and the w slices of each, and keeps its ``[BQ, BM]`` minima in
  registers: no ``[Q, block]`` score tile ever reaches device memory, no
  reduction crosses programs. Query tiles vary fastest in the grid, so
  the programs reading the same columns run together and share them
  through L2.
- ``"xla"`` — the same math in plain ``jnp``/``lax`` (one dot per block,
  slice min, encode, running min). It is the CPU route and the reference
  the kernel is tested against.

Recall: a true neighbor is lost only when a *closer* true neighbor lands
in the same bucket (expected loss ~= (k-1)/(2m) per neighbor — 0.1% for
k=10, m=4096) or when bf16 input rounding pushes its bucket score below
the top-``k*oversample`` bucket cut, which oversampling absorbs.

The exact top-k and the f32 rerank of the shortlist run outside the scan.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Default block: the bucket-interleave and pruning granularity (the scan
# kernel picks its own tiles inside a block).
DEFAULT_BLOCK = 8192
# The packed D axis is padded to a multiple of the bf16 MMA depth; the
# kernel splits it into power-of-two chunks, so no padding column streams.
DEFAULT_D_ALIGN = 16

# Triton-route tiling. A program holds a [_BQ, _BM] f32 minimum tile and
# a dot result of the same size in registers; query tiles of up to
# _HOIST_Q elements stay in registers across the block loop, wider ones
# are re-read per chunk (high D). D is contracted in chunks of at most
# _KC columns so each streamed [chunk, _BM] tile stays small in shared
# memory. 128 x 64 with 4 warps and 3 stages was the fastest of eleven
# configurations timed at 9.99M x 96, q=4096 on an H100 (PERF.md).
_BQ = 128
_BM = 64
_NUM_WARPS = 4
_NUM_STAGES = 3
_KC = 128
_HOIST_Q = 128 * 128


def scan_route(platform: str | None = None) -> str:
    """The bucket-scan implementation for ``platform`` (default: JAX's
    default backend): ``"triton"`` on ``"gpu"``, ``"xla"`` on ``"cpu"``.
    Any other platform raises — no platform falls back to another's
    route or to the Pallas interpreter."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no k-NN scan route for platform {platform!r}")


def _d_chunks(d_pad: int) -> tuple[tuple[int, int], ...]:
    """``(offset, width)`` pieces of a packed D axis: powers of two in
    [16, _KC], widest first (96 -> 64 + 32; 768 -> 6 x 128)."""
    out, off = [], 0
    while off < d_pad:
        c = min(_KC, 1 << ((d_pad - off).bit_length() - 1))
        out.append((off, c))
        off += c
    return tuple(out)


def _pow2_divisor(x: int, cap: int) -> int:
    """Largest power of two that divides ``x``, capped at ``cap``."""
    return min(x & -x, cap)


def _encode(score, b, keep):
    """Pack block id ``b`` into the low mantissa bits of ``score``. The
    map is monotone in ``score`` (negative values included), so a min of
    encodings is the encoding of the min."""
    enc = (jax.lax.bitcast_convert_type(score, jnp.int32) & keep) | b
    return jax.lax.bitcast_convert_type(enc, jnp.float32)


def _scan_kernel(*refs, nloop, w, m, bm, bq, chunks, nk, bits,
                 tiles_per_row, pruned):
    """One program: ``bq`` queries x ``bm`` buckets over every block (or
    the tile's first ``nprobe`` listed blocks). D is contracted in
    ``chunks`` (query chunks held in registers), or — for wide D — in a
    loop over ``nk`` chunks of ``_KC`` columns re-read per block, then
    the ``chunks`` tail."""
    if pruned:
        vn_ref, vb_ref, q_ref, bmap_ref, np_ref, out_ref = refs
    else:
        vn_ref, vb_ref, q_ref, out_ref = refs
    i = pl.program_id(0)  # query tile
    j = pl.program_id(1)  # bucket group
    keep = jnp.int32(~((1 << bits) - 1))
    rows = pl.ds(pl.multiple_of(i * bq, bq), bq)
    qs = [q_ref[rows, pl.ds(off, c)] for off, c in chunks]

    def body(p, acc):
        b = bmap_ref[i // tiles_per_row, p] if pruned else p
        for s in range(w):  # the block's m-wide slices: bucket = col % m
            col = pl.ds(pl.multiple_of(j * bm + s * m, bm), bm)

            def kstep(kk, dot):
                off = pl.ds(pl.multiple_of(kk * _KC, _KC), _KC)
                return dot + pl.dot(q_ref[rows, off], vb_ref[b, off, col])

            dot = jnp.zeros((bq, bm), jnp.float32)
            if nk:
                dot = jax.lax.fori_loop(0, nk, kstep, dot)
            for (off, c), qc in zip(chunks, qs):
                dot = dot + pl.dot(qc, vb_ref[b, pl.ds(off, c), col])
            score = dot + vn_ref[b, 0, col][None, :]
            acc = jnp.minimum(acc, _encode(score, b, keep))
        return acc

    count = np_ref[0] if pruned else nloop
    acc = jax.lax.fori_loop(
        0, count, body, jnp.full((bq, bm), 3.0e38, jnp.float32)
    )
    out_ref[rows, pl.ds(pl.multiple_of(j * bm, bm), bm)] = acc


def _scan_triton(vn, vb, qb, bmap, nprobe, *, bits, m, q_tile, interpret):
    """The Triton-route bucket scan: ``[Q, m]`` encoded minima."""
    nb, d_pad, block = vb.shape
    q = qb.shape[0]
    pruned = bmap is not None
    bm = _pow2_divisor(m, _BM)
    bq = _pow2_divisor(q_tile, _BQ) if pruned else _BQ
    if bm < 16 or bq < 16 or d_pad % 16:
        raise ValueError(
            "the GPU scan kernel needs buckets and the packed D to be "
            f"multiples of 16, and pruned q_tile a multiple of 16 (got "
            f"buckets={m}, D_pad={d_pad}, q_tile={q_tile})"
        )
    # no size cap: the Triton lowering addresses any operand over 4 GiB
    # with 64-bit offsets, so packs past 2^31 bf16 elements scan as is
    q_pad = _round_up(q, bq)
    qb = jnp.pad(qb, ((0, q_pad - q), (0, 0)))
    # narrow D: every chunk's query tile stays in registers; wide D: the
    # full _KC chunks loop (one chunk's tiles in flight at a time)
    nk = 0 if bq * d_pad <= _HOIST_Q else d_pad // _KC
    chunks = tuple(
        (nk * _KC + off, c) for off, c in _d_chunks(d_pad - nk * _KC)
    )
    kernel = functools.partial(
        _scan_kernel, nloop=nb, w=block // m, m=m, bm=bm, bq=bq,
        chunks=chunks, nk=nk, bits=bits,
        tiles_per_row=q_tile // bq if pruned else 1, pruned=pruned,
    )
    args = (vn, vb, qb)
    if pruned:
        args += (bmap, nprobe.reshape(1))
    out = pl.pallas_call(
        kernel,
        grid=(q_pad // bq, m // bm),
        out_shape=jax.ShapeDtypeStruct((q_pad, m), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="knn_bucket_scan",
    )(*args)
    return out[:q]


def _scan_xla(vn, vb, qb, bmap, nprobe, *, bits, m, q_tile):
    """The bucket scan in plain ``jnp``/``lax``: ``[Q, m]`` encoded minima.
    Full scan: one ``[Q, D] @ [D, block]`` dot per block. Pruned: query
    tile t scores block ``bmap[t, p]`` at step p, for the first
    ``nprobe`` steps."""
    nb, d_pad, block = vb.shape
    q = qb.shape[0]
    w = block // m
    keep = jnp.int32(~((1 << bits) - 1))
    init = jnp.float32(3.0e38)

    def slice_min(score):  # [..., block] -> [..., m]
        return score.reshape(*score.shape[:-1], w, m).min(axis=-2)

    if bmap is None:
        def body(b, acc):
            s = jax.lax.dot_general(
                qb, vb[b], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ) + vn[b]
            return jnp.minimum(acc, _encode(slice_min(s), b, keep))

        return jax.lax.fori_loop(0, nb, body, jnp.full((q, m), init))

    tiles = q // q_tile
    qt = qb.reshape(tiles, q_tile, d_pad)

    def body_p(p, acc):
        b = bmap[:, p]  # [tiles]
        s = jax.lax.dot_general(
            qt, vb[b], (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        ) + vn[b]
        return jnp.minimum(
            acc, _encode(slice_min(s), b[:, None, None], keep)
        )

    acc = jax.lax.fori_loop(
        0, nprobe, body_p, jnp.full((tiles, q_tile, m), init)
    )
    return acc.reshape(q, m)


def _bucket_scan(vn, vb, qb, bmap, nprobe, *, bits, m, q_tile, interpret):
    """Route the bucket scan: the Triton kernel when ``interpret`` is set
    (run by the Pallas interpreter) or when ``scan_route()`` says so,
    else the plain XLA version."""
    if interpret or scan_route() == "triton":
        return _scan_triton(
            vn, vb, qb, bmap, nprobe, bits=bits, m=m, q_tile=q_tile,
            interpret=interpret,
        )
    return _scan_xla(vn, vb, qb, bmap, nprobe, bits=bits, m=m,
                     q_tile=q_tile)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PackedDB:
    """Database packed for the serving scan, built ONCE per database.

    Packing reads the f32 matrix and writes the transposed bf16 block
    layout — hoisting it out of the per-batch call saves a full pass over
    the database per batch. ``vectors`` is the original f32 matrix
    (referenced, not copied) for the exact rerank.
    """

    vb: jax.Array  # [nb, D_pad, block] bf16 (-2v; -v for ip)
    vn: jax.Array  # [nb, 1, block] f32 |v|^2 (3e38 pad)
    vectors: jax.Array  # [N, D] float32 (rerank source)
    n: int = dataclasses.field(metadata=dict(static=True))
    block: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    bits: int = dataclasses.field(metadata=dict(static=True))
    # "l2" | "cosine" (normalized L2) | "ip" (maximum inner product)
    metric: str = dataclasses.field(
        default="l2", metadata=dict(static=True)
    )
    # block-pruning summaries (see ``probes=``): [nb, D] centroids and
    # [nb] radii (radius -3e38 marks an all-padding block). None on
    # packs assembled from raw buffers (out-of-core chunk reload).
    cent: jax.Array | None = None
    rad: jax.Array | None = None

    def mask_rows(self, alive) -> "PackedDB":
        """New ``PackedDB`` sharing EVERY buffer except the norm row:
        rows where ``alive`` is False get the 3e38 bucket sentinel, so
        they can never win a bucket. O(N) on device (~40 MB at 10M) —
        no bf16 repack, no host transfer: the cheap half of tombstone
        serving over an immutable pack (``DynamicIndex`` removals).
        Pass the same mask as ``row_mask=`` to the serve call so the
        exact rerank can't return a masked row that shares a winning
        bucket. The pruning summaries (``cent``/``rad``) are shared
        unchanged — masked rows still steer block selection slightly
        until the next compaction repacks (bounded by the compaction
        threshold; selection is approximate by design)."""
        return dataclasses.replace(
            self, vn=_mask_vn(self.vn, jnp.asarray(alive, bool), self.n)
        )


@functools.partial(jax.jit, static_argnames=("n",), donate_argnums=())
def _mask_vn(vn, alive, n):
    nb, _, block = vn.shape
    pad = jnp.zeros((nb * block - n,), bool)
    a = jnp.concatenate([alive, pad]).reshape(nb, 1, block)
    return jnp.where(a, vn, jnp.float32(3.0e38))


def _summary_cell(block: int) -> int:
    """Pruning summary granularity: 32 cells per block (cell >= 32 rows,
    clamped for tiny blocks; must divide block — falls back to one cell
    per block for exotic block sizes)."""
    cell = min(block, max(32, block // 32))
    return block if block % cell else cell


def _cell_summary_body(vblk, rblk, *, cpb, cell):
    """Per-cell (centroid, radius) of ONE block's zeroed rows — the
    shared ``lax.map`` body of ``_block_summaries`` and the sharded
    pack's in-shard_map summaries (``parallel/scan.py``), so the two
    pack flavors can never diverge. ``vblk`` [block, d] with non-real
    rows zeroed, ``rblk`` [block] bool real mask. Empty cells get
    radius -3e38 (the never-select sentinel the pruned selection tests
    with ``rad < -1e38``)."""
    d = vblk.shape[1]
    vc = vblk.reshape(cpb, cell, d)
    rc = rblk.reshape(cpb, cell)
    cnt = jnp.sum(rc, axis=1)
    cent = jnp.sum(vc, axis=1) / jnp.maximum(cnt, 1)[:, None]
    diff = vc - cent[:, None, :]
    d2 = jnp.where(rc, jnp.sum(diff * diff, axis=2), 0.0)
    rad = jnp.sqrt(jnp.max(d2, axis=1))
    return cent, jnp.where(cnt > 0, rad, jnp.float32(-3.0e38))


@functools.partial(jax.jit, static_argnames=("block", "cell", "n_valid"))
def _block_summaries(vectors, *, block, cell, n_valid):
    """Per-CELL ``(centroid [nc, D], radius [nc])`` for block pruning
    (``probes=``), ``cell`` rows per cell, ``block/cell`` cells per
    block. A BSPIndex's leaf-major layout makes each contiguous run of
    rows a spatially coherent tree segment — but a whole 8192-row block
    spans several clusters, so block-level centroids lose their
    discrimination (measured: per-query top-4 block coverage 0.67 at
    cell=block vs 0.89 at block/8 on 200k x 16 clustered). Selection
    scores queries against CELL centroids and takes each block's best
    cell. Rows past ``n_valid`` (pads / +inf rerank sentinels) are
    excluded; an all-padding cell gets radius -3e38 so it is never
    selected. ``lax.map`` over BLOCKS keeps ALL transients per-block —
    including the row pad and the sentinel zeroing, which as
    whole-matrix ops would each hold an extra [N, D] copy (7.7 GB of
    HBM at 10M x 96) next to the matrix and the packed blocks. The
    last block's slice start is clamped in-bounds and rolled so
    position p keeps row i*block + p (the id contract of the serve
    kernel); the wrapped tail re-reads earlier rows and is masked."""
    n, d = vectors.shape
    n_pad = _round_up(n, block)
    nb = n_pad // block
    cpb = block // cell
    if n < block:
        vectors = jnp.pad(vectors, ((0, block - n), (0, 0)))
    rows_total = vectors.shape[0]

    def one(i):
        st = jnp.maximum(jnp.minimum(i * block, rows_total - block), 0)
        blk = jax.lax.dynamic_slice(vectors, (st, 0), (block, d))
        blk = jnp.roll(blk, st - i * block, axis=0)
        real = (i * block + jnp.arange(block)) < n_valid
        vz = jnp.where(real[:, None], blk, 0.0)
        return _cell_summary_body(vz, real, cpb=cpb, cell=cell)

    cent, rad = jax.lax.map(one, jnp.arange(nb))
    return (
        cent.reshape(nb * cpb, d).astype(jnp.float32),
        rad.reshape(nb * cpb).astype(jnp.float32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("block", "d_align", "ip", "n_valid", "cell"),
)
def _pack_blockwise(vectors, *, block, d_align, ip, n_valid, cell):
    """The bf16 pack (zeroing, norm row, -2x bf16 transpose) AND the
    pruning summaries in ONE ``lax.map`` over blocks — the same body as
    the sharded pack (``parallel/scan.py``), so no full-size f32
    temporary ever materializes. The whole-matrix ``_pack`` it replaces
    held two extra [n_pad, d_pad] f32 residents (the pad and its zeroed
    twin, ~5 GB each at 10M x 96) next to the rerank matrix and the
    bf16 blocks. The last block's slice start is clamped in-bounds and
    rolled so position p keeps row ``i*block + p`` (the serve kernel's
    id contract); the wrapped tail re-reads earlier rows and is masked
    along with the caller's +inf sentinel rows."""
    n, d = vectors.shape
    nv = n if n_valid is None else n_valid
    d_pad = _round_up(d, d_align)
    n_pad = _round_up(n, block)
    nb = n_pad // block
    cpb = block // cell
    scale = -1.0 if ip else -2.0
    if n < block:
        vectors = jnp.pad(vectors, ((0, block - n), (0, 0)))
    rows_total = vectors.shape[0]

    def one(i):
        st = jnp.maximum(jnp.minimum(i * block, rows_total - block), 0)
        blk = jax.lax.dynamic_slice(vectors, (st, 0), (block, d))
        blk = jnp.roll(blk, st - i * block, axis=0)
        rows = i * block + jnp.arange(block)
        real = rows < nv
        blk = jnp.pad(blk, ((0, 0), (0, d_pad - d)))
        vz = jnp.where(real[:, None], blk, 0.0)
        vnb = (
            jnp.zeros((block,)) if ip else jnp.sum(vz * vz, axis=1)
        )
        # padded/sentinel rows must never win a bucket (large finite:
        # +inf would break the packed encode's int bit-ops)
        vnb = jnp.where(real, vnb, jnp.float32(3.0e38))
        vbb = jnp.swapaxes((scale * vz).astype(jnp.bfloat16), 0, 1)
        cent, rad = _cell_summary_body(vz, real, cpb=cpb, cell=cell)
        return vbb, vnb, cent, rad

    vb, vn, cent, rad = jax.lax.map(one, jnp.arange(nb))
    return (
        vb,
        vn.reshape(nb, 1, block),
        cent.reshape(nb * cpb, d_pad)[:, :d].astype(jnp.float32),
        rad.reshape(nb * cpb).astype(jnp.float32),
    )


@functools.partial(
    jax.jit, static_argnames=("block", "d_align", "ip", "n_valid")
)
def _pack(vectors, *, block, d_align, ip=False, n_valid=None):
    n, d = vectors.shape
    nv = n if n_valid is None else n_valid
    d_pad = _round_up(d, d_align)
    n_pad = _round_up(n, block)
    nb = n_pad // block
    vp = jnp.pad(vectors, ((0, n_pad - n), (0, d_pad - d)))
    # rows past n_valid are caller padding (possibly +inf rerank
    # sentinels) and must be zeroed before entering the blocks — an inf
    # column would produce -inf scores that win every bucket
    real = jnp.arange(n_pad) < nv
    vp = jnp.where(real[:, None], vp, 0.0)
    # l2: score = |v|^2 - 2 q.v (per-query |q|^2 constant dropped);
    # ip: score = -q.v — same kernel with vn = 0 and blocks scaled -1
    vn = jnp.zeros((n_pad,)) if ip else jnp.sum(vp * vp, axis=1)
    # padded rows must never win a bucket (large finite value: +inf would
    # break the int bit-ops of the packed encode)
    vn = jnp.where(real, vn, jnp.float32(3.0e38)).reshape(nb, 1, block)
    # pre-transposed [nb, D, block] blocks scaled by -2 (exact in bf16):
    # the kernel's per-slice score is then |v|^2 + q.vb in ONE add
    scale = -1.0 if ip else -2.0
    vb = jnp.swapaxes(
        (scale * vp).astype(jnp.bfloat16).reshape(nb, block, d_pad), 1, 2
    )
    return vb, vn


def pack_database(
    vectors: jax.Array,
    *,
    block: int = DEFAULT_BLOCK,
    buckets: int = 4096,
    d_align: int = DEFAULT_D_ALIGN,
    metric: str = "l2",
    rows_valid: int | None = None,
) -> PackedDB:
    """Pack a database for ``pallas_scan_knn_packed``.

    ``buckets`` (m) is the number of per-query shortlist buckets across
    the WHOLE database; expected recall@k ~= 1 - (k-1)/(2m) minus bf16
    input rounding noise (absorbed by ``oversample``). ``block`` is the
    bucket-interleave and pruning granularity (a multiple of
    ``buckets``); the winning bucket keeps ``block/buckets`` candidate
    rows for the exact rerank. ``d_align``: the packed D axis is padded
    to this multiple (a multiple of 16, the bf16 MMA depth; the GPU
    kernel contracts D in power-of-two chunks, so 96 streams unpadded).

    ``metric``: ``"l2"`` (default) squared-Euclidean; ``"cosine"`` —
    rows are unit-normalized at pack time (queries at serve time) and
    the search runs in normalized-L2 space (``cos = 1 - d2/2``, order
    -equivalent — the deep-image-96-ANGULAR treatment); ``"ip"`` —
    maximum inner product: the same scan streams ``-v`` with a zero
    norm row and results come back as ``(rows, dots)`` highest-dot
    first.

    ``rows_valid``: rows past this count are caller padding — they are
    excluded from bucket selection (norm-row sentinel) and should carry
    +inf so the exact rerank can never return them. Lets callers pad
    ragged chunks to a uniform capacity so every chunk shares ONE
    compiled serve program (``out_of_core.ChunkedIndex``).
    """
    vectors = jnp.asarray(vectors, jnp.float32)
    if metric not in ("l2", "cosine", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    if d_align % 16:
        raise ValueError("d_align must be a multiple of 16")
    n, d = vectors.shape
    if n == 0:
        # callers handle emptiness above this layer; a zero-block pack
        # has nothing to scan
        raise ValueError("pack_database: empty database (0 rows)")
    if rows_valid is None:
        rows_valid = n
    if metric == "cosine":
        from vector_database_tpu.ops.exact import normalize_rows

        if rows_valid < n:
            # normalize only the real rows; keep the +inf rerank
            # sentinels (normalizing inf would produce NaN rows)
            real = (jnp.arange(n) < rows_valid)[:, None]
            safe = jnp.where(real, vectors, 1.0)
            vectors = jnp.where(real, normalize_rows(safe), vectors)
        else:
            vectors = normalize_rows(vectors)
    m = min(buckets, block)
    if block % m:
        raise ValueError("block must be a multiple of buckets")
    nb = _round_up(n, block) // block
    bits = max(1, (nb - 1).bit_length())
    if bits > 16:
        raise ValueError(
            "database too large for this block size: raise `block` so "
            "that the number of blocks stays <= 65536"
        )
    n_valid = None if rows_valid == n else rows_valid
    # pack + summaries fused in one blockwise lax.map (no full-size f32
    # temporaries — see _pack_blockwise)
    vb, vn, cent, rad = _pack_blockwise(
        vectors, block=block, d_align=d_align, ip=metric == "ip",
        n_valid=n_valid, cell=_summary_cell(block),
    )
    return PackedDB(
        vb=vb, vn=vn, vectors=vectors, n=n, block=block, m=m, bits=bits,
        metric=metric, cent=cent, rad=rad,
    )


def _select_blocks(pack: PackedDB, queries, qp, *, probes, probes_rt,
                   q_tile):
    """The pruned scan's inputs: ``(qp, bmap, nprobe, inv)`` — the padded
    queries reordered so each ``q_tile`` tile's queries want the same
    blocks, the ``[tiles, probes]`` block map (best first), the clipped
    runtime probe count, and the inverse query permutation."""
    nb = pack.vb.shape[0]
    q = queries.shape[0]
    q_pad = qp.shape[0]
    qt_blocks = q_pad // q_tile
    if pack.cent is None:
        raise ValueError(
            "probes= needs block summaries; this pack was assembled "
            "without them (re-pack with pack_database)"
        )
    # --- per-(query, block) selection key: CELL-CENTROID DISTANCE
    # (the IVF heuristic, at sub-block granularity; a block's key is
    # its best cell's). The principled lower bound
    # max(0, |q-c| - r)^2 was measured far worse: leaf-major blocks
    # overlap enough that most bounds tie at 0 and the ranking
    # collapses (toy 20k x 16: top-4 blocks by centroid distance
    # catch 98.6% of true neighbors; by bound, 64%). Single-pass
    # bf16 dot: its rounding perturbs ~2% of per-QUERY top-4 cell
    # sets, but per-TILE top-P block membership (512 queries x 32
    # cells/block aggregated) was identical to Precision.HIGHEST at
    # every 1M x 96 operating point checked
    # (benchmarks/probe_select.py --sel-bf16). |c|^2 stays exact f32.
    cent, rad = pack.cent, pack.rad
    nc = cent.shape[0]
    cpb = nc // nb
    dots = jax.lax.dot_general(
        queries.astype(jnp.bfloat16), cent.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [Q, nc]
    if pack.metric == "ip":
        key = -dots
    else:
        cc = jnp.sum(cent * cent, axis=1)
        key = cc[None, :] - 2.0 * dots  # |q|^2 constant dropped
    # all-padding cells (radius sentinel -3e38) are never selected
    key = jnp.where(rad[None, :] < -1e38, jnp.inf, key)
    key = key.reshape(q, nb, cpb).min(axis=2)  # [Q, nb]
    # --- group queries so a tile's block lists overlap ---
    top1 = jnp.argmin(key, axis=1)  # [q]
    order = jnp.argsort(top1)
    inv = jnp.argsort(order)
    qp = jnp.concatenate([qp[:q][order], qp[q:]], axis=0)
    key_s = jnp.pad(
        key[order], ((0, q_pad - q), (0, 0)),
        constant_values=jnp.inf,  # pad queries never steer selection
    )
    tile_key = key_s.reshape(qt_blocks, q_tile, nb).min(axis=1)
    # force every tile member's TOP-1 block into its tile's list
    # (when it fits in probes): an outlier query in a mixed tile
    # otherwise loses all its preferred blocks to tile-mates with
    # smaller absolute keys (+2pt recall at the P=nb/6 operating
    # point, measured 200k x 16)
    f = (top1[:, None] == jnp.arange(nb, dtype=top1.dtype)[None, :])
    f = jnp.pad(f[order], ((0, q_pad - q), (0, 0)))
    f = f.reshape(qt_blocks, q_tile, nb).any(axis=1)
    tile_key = jnp.where(f, -jnp.inf, tile_key)
    _, bmap = jax.lax.top_k(-tile_key, probes)  # [tiles, probes]
    bmap = bmap.astype(jnp.int32)
    nprobe = jnp.clip(jnp.asarray(probes_rt, jnp.int32), 1, probes)
    return qp, bmap, nprobe, inv


def _shortlist_rows(
    pack: PackedDB,
    queries: jax.Array,  # [Q, D] float32, already metric-normalized
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
    probes_max: int | None = None,
    interpret: bool = False,
):
    """Bucket scan + bucket top-k: the ``[Q, k_scan * block/m]``
    candidate row ids (leaf-major; may include ids >= ``pack.n`` and
    sentinel rows — the caller's exact rerank masks them). Never touches
    ``pack.vectors``, so candidates-only callers may pass a ``[0, D]``
    placeholder there.

    ``probes``: scan only this many database blocks per query tile of
    ``q_tile`` queries (chosen by cell-centroid distance, queries sorted
    so a tile's queries want the same blocks) instead of all of them —
    the approximate high-QPS mode; see ``pallas_scan_knn_packed``. A
    static ``probes=p`` is the runtime form with ``probes_max=p``.

    ``interpret=True`` runs the GPU kernel in the Pallas interpreter
    (tests); otherwise ``scan_route()`` picks the implementation.
    """
    block, m, bits = pack.block, pack.m, pack.bits
    d = queries.shape[1]
    d_pad = pack.vb.shape[1]
    nb = pack.vb.shape[0]
    q = queries.shape[0]
    w = block // m
    if oversample is None:
        oversample = 4
    q_pad = _round_up(q, q_tile)
    qp = jnp.pad(queries, ((0, q_pad - q), (0, d_pad - d)))

    # pruned scan: the block map is built at the static width
    # min(probes_max, nb) (or min(probes, nb) for a static count) and the
    # scan runs a traced count of its columns (clipped in [1, width]) —
    # every probes value up to the width shares ONE compiled program.
    probes_rt = None
    if probes_max is not None:
        if probes is None:
            raise ValueError("probes_max requires probes")
        probes_rt = probes
        probes = min(probes_max, nb)
    elif probes is not None and probes < 1:
        raise ValueError("probes must be >= 1")
    elif probes is not None and probes < nb:
        probes_rt = probes
    inv = bmap = nprobe = None
    if probes_rt is not None:
        qp, bmap, nprobe, inv = _select_blocks(
            pack, queries, qp, probes=probes, probes_rt=probes_rt,
            q_tile=q_tile,
        )

    acc = _bucket_scan(
        pack.vn, pack.vb, qp.astype(jnp.bfloat16), bmap, nprobe,
        bits=bits, m=m, q_tile=q_tile, interpret=interpret,
    )
    # the inverse query permutation is applied to the FINAL
    # [Q, k_scan*w] row list, not here: permuting the [Q, m]
    # accumulator gathers far more elements for the same answer
    cand_d = acc[:q]

    # top-k buckets by (approximate) score; each winning bucket carries
    # w = block/m candidate rows (one per slice of the winning block).
    # The block id rides the winners' low mantissa bits and f32 negation
    # is a sign-bit flip, so decoding the k_scan top-k VALUES avoids a
    # whole-[Q, m] bitcast + mask and a gather.
    k_scan = min(k * oversample, m)
    neg, pos = jax.lax.top_k(-cand_d, k_scan)
    blk = jax.lax.bitcast_convert_type(-neg, jnp.int32) & jnp.int32(
        (1 << bits) - 1
    )
    rows3 = (
        blk[:, :, None] * block
        + (jnp.arange(w, dtype=jnp.int32) * m)[None, None, :]
        + pos[:, :, None]
    )
    rows = rows3.reshape(q, k_scan * w)
    # pruned mode sorted the queries so tile-mates share block lists;
    # undo that on the small final row list
    return rows if inv is None else rows[inv]


def _scan_knn_packed_impl(
    pack: PackedDB,
    queries: jax.Array,  # [Q, D] float32
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
    probes_max: int | None = None,
    interpret: bool = False,
    row_mask: jax.Array | None = None,
):
    """Exact-reranked k-NN over a pre-packed database (the serving path):
    ``(rows [Q, k], sq_dists [Q, k])`` — for ``metric="ip"`` packs the
    second output is exact DOTS, highest first.

    ``row_mask``: optional ``[N]`` bool — rows where it is False are
    excluded from the RERANK (scored +inf, row id -1). Pair it with
    ``PackedDB.mask_rows(row_mask)`` (which rebuilds only the norm row)
    for exact tombstone serving over an immutable pack: the mask half
    keeps dead rows out of the shortlist's winning buckets, this half
    keeps shortlisted bucket-mates from being returned.

    ``oversample`` widens the bucket shortlist the exact rerank examines
    (default 4: ``4 * k`` buckets).

    ``probes``: approximate high-QPS mode — stream only this many
    database blocks per query tile instead of all of them. Blocks are
    ranked per tile by the centroid/radius lower bound (exact: a block
    whose bound exceeds a true neighbor's distance cannot contain it),
    and queries are grouped so tile-mates want the same blocks; recall
    degrades gracefully as probes shrinks (measure with
    ``benchmarks/recall_qps.py --probes``). ``probes >= num_blocks`` (or
    None) is the exact full scan. Returned distances are always exact
    f32 for whatever rows are returned.

    This is the unjitted body; the public entry is the jitted
    ``pallas_scan_knn_packed`` below. It is also the per-shard program of
    the mesh serving path (``parallel/scan.py`` calls it inside
    ``shard_map``, where the outer jit is the caller's).
    """
    if pack.metric == "cosine":
        from vector_database_tpu.ops.exact import normalize_rows

        queries = normalize_rows(queries)
    n = pack.n
    q = queries.shape[0]
    vectors = pack.vectors
    short_rows = _shortlist_rows(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes, probes_max=probes_max, interpret=interpret,
    )

    # f32 exact rerank of the shortlist
    safe = jnp.clip(short_rows, 0, n - 1)
    cand = vectors[safe]  # [Q, k_scan*w, D]
    if pack.metric == "ip":
        # exact dots; selection key = -dot (lower better, like d2)
        key = -jnp.sum(cand * queries[:, None, :], axis=-1)
    else:
        diff = cand - queries[:, None, :]
        key = jnp.sum(diff * diff, axis=-1)
    # exclude index pads AND +inf sentinel rows (rows_valid= packs,
    # ragged shard pads). For l2 a sentinel row scores +inf naturally,
    # but for ip it scores -inf/NaN and would WIN top_k — mask on the
    # key's finiteness, which catches both metrics.
    key = jnp.where(
        (short_rows < n) & jnp.isfinite(key), key, jnp.inf
    )
    if row_mask is not None:
        # tombstone exclusion: a dead row sharing a winning bucket must
        # not consume a result slot (masked here, it ranks last and the
        # oversampled shortlist fills the k from live rows)
        key = jnp.where(row_mask[safe], key, jnp.inf)
    kk = min(k, short_rows.shape[1])
    fneg, fpos = jax.lax.top_k(-key, kk)
    rows = jnp.take_along_axis(short_rows, fpos, axis=1)
    out_key = -fneg
    rows = jnp.where(jnp.isfinite(out_key), rows, -1)
    if k > kk:  # pad to the documented [Q, k] contract
        rows = jnp.pad(rows, ((0, 0), (0, k - kk)), constant_values=-1)
        out_key = jnp.pad(
            out_key, ((0, 0), (0, k - kk)), constant_values=jnp.inf
        )
    if pack.metric == "ip":
        # report dots, highest first (padding -> -inf)
        return rows, jnp.where(jnp.isfinite(out_key), -out_key, -jnp.inf)
    return rows, out_key


pallas_scan_knn_packed = jax.jit(
    _scan_knn_packed_impl,
    static_argnames=(
        "k", "q_tile", "oversample", "probes", "probes_max", "interpret"
    ),
)


def _scan_knn_packed_rt_entry(
    pack: PackedDB,
    queries: jax.Array,
    probes,  # runtime scalar (int or traced int32)
    *,
    k: int,
    probes_max: int,
    q_tile: int = 256,
    oversample: int | None = None,
    interpret: bool = False,
    row_mask: jax.Array | None = None,
):
    return _scan_knn_packed_impl(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes, probes_max=probes_max, interpret=interpret,
        row_mask=row_mask,
    )


pallas_scan_knn_packed_rt = jax.jit(
    _scan_knn_packed_rt_entry,
    static_argnames=("k", "probes_max", "q_tile", "oversample", "interpret"),
)
pallas_scan_knn_packed_rt.__doc__ = """\
Runtime-probes pruned serving: like ``pallas_scan_knn_packed(probes=p)``
but ``probes`` is a TRACED scalar bounded by the static ``probes_max`` —
every probes value in [1, probes_max] shares one compiled program (the
block map is built ``min(probes_max, nb)`` wide; ``lax.top_k`` sorts, so
its first ``p`` entries are exactly the static map). Results are
bitwise-identical to the static-probes call. Use for deploy-time
calibration (``calibrate_probes``) and for serving fleets that retune
probes without compiling a program per value; steady-state
fixed-probes serving can keep the static entry (the selection top-k is
``probes_max`` wide here, marginally more work when
``probes_max >> probes``)."""


def _scan_candidates_impl(
    pack: PackedDB,
    queries: jax.Array,  # [Q, D] float32
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
    interpret: bool = False,
):
    """Bucket-shortlist candidate row ids WITHOUT the on-device f32
    rerank: ``[Q, k_scan * block/m]`` leaf-major ids, possibly including
    ids >= ``pack.n`` and +inf sentinel rows — the caller's exact rerank
    must mask both (mirror ``_scan_knn_packed_impl``'s tail).

    Exists for the transfer-bound out-of-core serving path
    (``out_of_core.ChunkedIndex.knn(host_rerank=True)``): only the packed
    blocks + norm row stream to the device (196 B/row at D=96 vs 580 with
    the f32 rerank matrix), and the exact rerank gathers the few
    candidate rows per query from the host-side (possibly memmapped)
    chunk vectors. ``pack.vectors`` may therefore be a ``[0, D]``
    placeholder — this path never reads it.
    """
    if pack.metric == "cosine":
        from vector_database_tpu.ops.exact import normalize_rows

        queries = normalize_rows(queries)
    return _shortlist_rows(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes, interpret=interpret,
    )


pallas_scan_knn_candidates = jax.jit(
    _scan_candidates_impl,
    static_argnames=("k", "q_tile", "oversample", "probes", "interpret"),
)


def calibrate_probes(
    pack: PackedDB,
    sample_queries,
    k: int,
    target_recall: float = 0.95,
    *,
    q_tile: int = 256,
    oversample: int | None = None,
    probes_max: int | None = None,
    interpret: bool = False,
) -> int:
    """Smallest ``probes`` whose recall@k on ``sample_queries`` (against
    this pack's own full scan) meets ``target_recall`` — binary search
    over the block count. The serving-knob analogue of
    ``search.calibrate_radius``: measure once at deploy time, then serve
    with the returned value. Recall is measured relative to the FULL
    scan (the exact-rerank ceiling the pruned mode approaches), on this
    sample's query/batch mix — pruning is a batch mode, so calibrate
    with a sample that looks like production traffic.

    Compiles exactly TWO programs regardless of how many probes values
    the search visits (the full-scan reference + ONE runtime-probes
    program via ``pallas_scan_knn_packed_rt``), where a per-value
    compilation would compile ~log2(nb) programs (11 at 10M).
    ``probes_max`` caps the search (and the
    shared program's block-map width); default: all ``nb`` blocks.
    Serve the result through either entry — static ``probes=`` or the
    already-compiled rt program."""
    q = jnp.atleast_2d(jnp.asarray(sample_queries, jnp.float32))
    nb = pack.vb.shape[0]
    if nb <= 1 or target_recall <= 0:
        return nb
    pmax = nb if probes_max is None else min(probes_max, nb)
    full, _ = pallas_scan_knn_packed(
        pack, q, k=k, q_tile=q_tile, oversample=oversample,
        interpret=interpret,
    )
    import numpy as np

    full = np.asarray(full)
    want = [set(r.tolist()) - {-1} for r in full]
    denom = max(1, sum(len(w) for w in want))

    seen: dict[int, float] = {}

    def recall_at(p: int) -> float:
        # memoized: the capped-search guard below evaluates recall_at(pmax)
        # and the binary search can revisit values — each evaluation is a
        # full serving call on the sample batch
        if p in seen:
            return seen[p]
        rows, _ = pallas_scan_knn_packed_rt(
            pack, q, jnp.int32(p), k=k, probes_max=pmax, q_tile=q_tile,
            oversample=oversample, interpret=interpret,
        )
        rows = np.asarray(rows)
        hits = sum(
            len(set(rows[i].tolist()) & want[i]) for i in range(len(want))
        )
        seen[p] = hits / denom
        return seen[p]

    lo, hi = 1, pmax  # recall_at(nb) == 1.0 by construction
    if pmax < nb and recall_at(pmax) < target_recall:
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


def pallas_scan_knn(
    vectors: jax.Array,  # [N, D] float32
    queries: jax.Array,  # [Q, D] float32
    *,
    k: int,
    block: int = DEFAULT_BLOCK,
    q_tile: int = 256,
    buckets: int = 4096,
    oversample: int | None = None,
    probes: int | None = None,
    metric: str = "l2",
    interpret: bool = False,
):
    """One-shot convenience: pack + serve. For steady-state serving call
    ``pack_database`` once and ``pallas_scan_knn_packed`` per batch — the
    packing pass costs more than a whole 1024-query batch."""
    pack = pack_database(
        jnp.asarray(vectors, jnp.float32), block=block, buckets=buckets,
        metric=metric,
    )
    return pallas_scan_knn_packed(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes, interpret=interpret,
    )
