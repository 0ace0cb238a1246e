"""Streaming exact k-NN: blocked matmul scan with a running top-k.

At serving dimensionality (D ≈ 96+) a single-plane BSP descent prunes
almost nothing (the curse of dimensionality: an ε that captures k neighbors
overlaps nearly every split plane — measured: >99% of leaves visited on
clustered 96-d data). On an accelerator the speed-of-light design for
exact k-NN is a bfloat16 matmul scan of the whole matrix — IF the [Q, N]
distance matrix is
never materialized. This op blocks the database axis with ``lax.scan`` and
carries a running [Q, k] top-k:

  traffic  = N·D (read the database once, bf16)
  FLOPs    = 2·Q·N·D on the tensor cores
  temp     = [Q, block] per step

The distances are ``|q|² + |v|² − 2 q·v``; the cross term runs in bfloat16
(inputs are normalized embeddings; error ~1e-2 relative) with float32
accumulation, or full float32 when ``precise=True``. Top-k indices are
exact for any distance gap above the dot-product rounding error; the
returned distances can be recomputed in f32 by the caller if needed.

This is the QPS path of the framework: the BSP tree remains the exact
ε-ball / low-dimensional / boolean engine (where its pruning works), the
scan is the high-dimensional k-NN engine.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.jit,
    static_argnames=("k", "block", "precise", "oversample", "buckets"),
)
def scan_knn(
    vectors: jax.Array,  # [N, D] float32 (leaf-major or raw order)
    queries: jax.Array,  # [Q, D] float32
    *,
    k: int,
    block: int = 65536,
    precise: bool = False,
    oversample: int = 4,
    buckets: int = 256,
    row_mask: jax.Array | None = None,
):
    """Exact k nearest neighbors; returns ``(rows [Q, k], sq_dists [Q, k])``.

    Rows index into ``vectors``; the database is padded to a multiple of
    ``block`` internally (padded rows get +inf distance).

    With ``precise=False`` the scan runs two-stage: a bfloat16 matmul pass
    selects an ``oversample * k`` shortlist, then a float32 rerank of the
    shortlist restores exact ranking (bf16 rounding only loses a true
    neighbor if it falls outside the 4k shortlist — tie-tight clusters
    beyond that need ``precise=True``).

    ``row_mask``: optional ``[N]`` bool — rows where False are excluded
    from the result set (filtered k-NN: the device-batched form of the
    reference's caller predicate, MemoryVectorIndex.cs:237-241). The
    filter rides the scan itself (masked rows score +inf inside each
    block) — never a post-filter of an unfiltered top-k, so no allowed
    row is displaced by disallowed ones. Exactness matches the chosen
    mode: ``precise=True`` is exact at any selectivity; the bucketed
    default keeps its usual (block, bucket)-collision loss model, now
    among ALLOWED rows only — and a sparse allowlist has no crowd to
    absorb a collision (two allowed rows in one bucket permanently drop
    one), so pass ``precise=True`` for highly selective filters.
    """
    n, d = vectors.shape
    q = queries.shape[0]
    k_scan = min(k * oversample, n) if not precise else k
    buckets = min(buckets, block)
    if block % buckets:
        raise ValueError("block must be a multiple of buckets")
    nb = -(-n // block)
    n_pad = nb * block
    padded = vectors
    if n_pad != n:
        padded = jnp.pad(vectors, ((0, n_pad - n), (0, 0)))

    dtype = jnp.float32 if precise else jnp.bfloat16
    vb = padded.astype(dtype).reshape(nb, block, d)
    vn = jnp.sum(padded * padded, axis=1).reshape(nb, block)
    if row_mask is not None:
        row_mask = jnp.asarray(row_mask, bool)
        if row_mask.shape != (n,):  # static shapes: checked at trace
            raise ValueError(
                f"row_mask must have shape ({n},) matching the database "
                f"rows, got {row_mask.shape}"
            )
        # fold the filter into the norm row: masked rows score +inf in
        # every block, so selection — bucket mins, shortlists, rerank —
        # never sees them (rerank keys on the shortlist, which is
        # already filtered)
        mask_p = jnp.pad(row_mask, (0, n_pad - n)).reshape(nb, block)
        vn = jnp.where(mask_p, vn, jnp.inf)
    qc = queries.astype(dtype)

    row_in_block = jnp.arange(block, dtype=jnp.int32)

    def step(carry, xs):
        best_d, best_i = carry  # [Q, k_scan], [Q, k_scan]
        vblk, vnblk, b = xs
        # a default-precision f32 matmul may run in reduced precision; the
        # precise path requests true f32 (HIGHEST). The bf16 path takes
        # the default.
        cross = jax.lax.dot_general(
            qc, vblk.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST if precise else None,
        )
        d2 = vnblk[None, :] - 2.0 * cross  # |v|^2 - 2 q.v (monotone in true d2)
        rows = b * block + row_in_block
        valid = rows < n
        d2 = jnp.where(valid[None, :], d2, jnp.inf)
        # Block-local shortlist. Rather than a lax.top_k over every
        # column of the block, reduce each block to `buckets` candidates with a fused
        # one-pass bucket-min — the i-th true neighbor is lost only if two
        # of the true top-k collide in the same (block, bucket), so recall
        # is governed by total buckets (blocks * buckets >> k^2). The
        # precise path keeps the exact sort as the validation tool.
        if precise:
            # cap the per-block selection at the block width (k may
            # exceed it); the running merge accumulates across blocks
            neg, pos = jax.lax.top_k(-d2, min(k_scan, block))
            blk_d = -neg
            blk_rows = jnp.where(jnp.isfinite(blk_d), rows[pos], -1)
        else:
            # INTERLEAVED buckets (bucket = column % buckets): contiguous
            # buckets collapse when the database is stored similarity-
            # sorted (e.g. a BSPIndex's leaf-major layout puts all of a
            # query's neighbors in one bucket); interleaving spreads them.
            width = block // buckets
            d2b = d2.reshape(q, width, buckets)
            arg = jnp.argmin(d2b, axis=1).astype(jnp.int32)
            blk_d = jnp.take_along_axis(d2b, arg[:, None, :], 1)[:, 0, :]
            off = jnp.arange(buckets, dtype=jnp.int32)
            blk_rows = b * block + arg * buckets + off[None, :]
            # all-padded buckets (partial last block) must not surface
            # phantom row ids >= n
            blk_rows = jnp.where(jnp.isfinite(blk_d), blk_rows, -1)
        # exact merge of the two small shortlists
        cat_d = jnp.concatenate([best_d, blk_d], axis=1)
        cat_i = jnp.concatenate([best_i, blk_rows], axis=1)
        mneg, mpos = jax.lax.top_k(-cat_d, k_scan)
        return (
            -mneg, jnp.take_along_axis(cat_i, mpos, axis=1)
        ), None

    init = (
        jnp.full((q, k_scan), jnp.inf, jnp.float32),
        jnp.full((q, k_scan), -1, jnp.int32),
    )
    (best_d, best_i), _ = jax.lax.scan(
        step, init, (vb, vn, jnp.arange(nb, dtype=jnp.int32))
    )
    qn = jnp.sum(queries * queries, axis=1, keepdims=True)

    def pad_to_k(rows_out, d2_out):
        # k > n: pad to the documented [Q, k] contract (-1 / +inf)
        short = k - rows_out.shape[1]
        if short > 0:
            rows_out = jnp.pad(rows_out, ((0, 0), (0, short)),
                               constant_values=-1)
            d2_out = jnp.pad(d2_out, ((0, 0), (0, short)),
                             constant_values=jnp.inf)
        return rows_out, d2_out

    if precise:
        return pad_to_k(best_i, jnp.maximum(best_d + qn, 0.0))

    # float32 rerank of the bf16 shortlist — also when k_scan <= k
    # (e.g. n <= k): the shortlist IS the result set then, but its bf16
    # scores (~1e-2 relative) would misorder downstream exact merges
    rows = jnp.where(best_i >= 0, best_i, 0)
    cand = vectors[rows]  # [Q, k_scan, D]
    diff = cand - queries[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(best_i >= 0, d2, jnp.inf)
    neg, pos = jax.lax.top_k(-d2, min(k, k_scan))
    out_rows = jnp.take_along_axis(best_i, pos, axis=1)
    out_d2 = -neg
    return pad_to_k(jnp.where(jnp.isfinite(out_d2), out_rows, -1), out_d2)
