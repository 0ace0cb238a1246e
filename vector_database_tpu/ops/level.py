"""One level of the level-synchronous BSP index build.

This is the device formulation of the reference's per-level work:

- the segmented per-dimension mean/variance reduction is the set-oriented
  statistics statement of ``dbo.BuildIndex`` (reference DDL.sql:118-152) and
  the Welford pass of the sequential walker (reference
  VectorIndex/IndexBuilder.cs:57-68, 159-197), computed for *every* live
  range of the level in one pass over the ``[N, D]`` matrix;
- split dimension selection alternates argmax / argmin of the per-dimension
  variance by level parity (IndexBuilder.cs:75-79, DDL.sql:151);
- the partition predicate is ``value > mid``, with ``id > mean_id`` as the
  tie-break on the plane (IndexBuilder.cs:113-123, DDL.sql:157-184), and a
  pure id partition when the split dimension has zero variance
  (DDL.sql:100).

Everything here is shape-static and jit-compiled once per
(num_segments, leaf_size) bucket; the host loop in ``builder.py`` drives it
once per tree level. Points that have been retired into leaf buckets stay in
the arrays with ``seg == -1`` and zero weight, which keeps shapes static
across levels (XLA requirement) at the cost of O(N·D) work per level —
the same ``O(N · log N · D)`` total as the reference.

The tie-break id statistic ``mean_id`` is exact: per-segment id sums are
kept in base-2^b int32 limbs (7-bit up to ~16M rows; the caller passes a
narrower plan from ``sorted_build.id_limb_plan`` beyond — uncapped) and
divided with exact long division — the int32
equivalent of the reference's Int128 ``Stats.IdN`` (Stats.cs:26), with no
wide-integer or float64 path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def level_math(
    vectors: jax.Array,  # [N, D] float32
    row_ids: jax.Array,  # [N] int32 (dense row ordinals, used for tie-breaks)
    seg: jax.Array,  # [N] int32; dense segment id at this level, -1 = retired
    leaf_of_point: jax.Array,  # [N] int32; node id of the leaf, -1 = not yet
    use_max: jax.Array,  # bool scalar: split on max-variance dim (else min)
    node_base: jax.Array,  # int32 scalar: node id of segment 0 at this level
    *,
    num_segments: int,
    leaf_size: int,
    axis_name: str | None = None,
    dim_axis_name: str | None = None,
    id_limb_bits: int | None = None,
    id_limbs: int | None = None,
):
    """Compute split stats for every live segment and reassign every point.

    Returns a dict with per-segment stats (first ``num_segments`` entries;
    the host slices to the live count) and the updated per-point state.

    With ``axis_name`` set (inside ``shard_map`` over a mesh axis holding a
    row shard of the matrix), the per-segment partial statistics are merged
    with ``psum`` across the mesh, so every shard sees identical
    global stats and the partition stays purely local — one tree, built
    data-parallel. This is the mesh form of the distributed build the
    reference never had (SURVEY.md §2.2: psum of per-dimension partial
    ``(n, Σ, M2)`` stats).

    With ``dim_axis_name`` set as well, the D axis is ALSO sharded
    (tensor-parallel stats for very wide vectors): each shard computes
    moments for its dimension slice, the per-shard argmax/argmin candidates
    are compared globally, and the winning shard broadcasts the split
    values — only [S]-sized collectives cross the dim axis.
    """
    S = num_segments
    n, d = vectors.shape

    if axis_name is None:
        allsum = lambda x: x
    else:
        allsum = lambda x: jax.lax.psum(x, axis_name)

    active = seg >= 0
    segidx = jnp.where(active, seg, 0)
    w = active.astype(vectors.dtype)

    # --- segmented stats: count, mean, M2 ---
    # Single-pass moments: m2 = sum(x^2) - n*mean^2, clamped at 0. With
    # vectors normalized to ~[-1, 1] the f32 cancellation error is bounded
    # by ~1e-7 * count, which only perturbs split-dimension choice between
    # near-constant dimensions — tree shape, never search correctness
    # (near-zero variances collapsing to exactly 0 take the degenerate
    # id-partition path, and the zero-progress guard backstops the rest).
    # One fewer O(N*D) pass and no [N, D] temporary vs the two-pass form.
    cnt = allsum(
        jax.ops.segment_sum(active.astype(jnp.int32), segidx, num_segments=S)
    )
    sums = allsum(
        jax.ops.segment_sum(vectors * w[:, None], segidx, num_segments=S)
    )
    sumsq = allsum(
        jax.ops.segment_sum(
            vectors * vectors * w[:, None], segidx, num_segments=S
        )
    )
    cnt_f = jnp.maximum(cnt, 1).astype(vectors.dtype)
    mean = sums / cnt_f[:, None]
    m2 = jnp.maximum(sumsq - cnt_f[:, None] * mean * mean, 0.0)

    # --- id statistics for the tie-break on the split plane ---
    # Exact mean id (the reference's Int128 ``Stats.IdN``, Stats.cs:26):
    # per-segment id sums in base-2^bits limbs (each segment_sum stays
    # within int32 by the id_limb_plan bound) + exact long division.
    # floor(mean) always lies in [min_id, max_id - 1] for >= 2 distinct
    # ids, so a forced id-partition is guaranteed to make progress.
    from vector_database_tpu.ops.sorted_build import (
        _ID_LIMB_BITS,
        _ID_LIMBS,
        _exact_mean_id,
    )

    bits = _ID_LIMB_BITS if id_limb_bits is None else id_limb_bits
    nlimbs = _ID_LIMBS if id_limbs is None else id_limbs
    mask = (1 << bits) - 1
    aid = jnp.where(active, row_ids, 0)
    limb_sums = [
        allsum(
            jax.ops.segment_sum(
                (aid >> (bits * l)) & mask,
                segidx,
                num_segments=S,
            )
        )
        for l in range(nlimbs)
    ]
    mean_id = _exact_mean_id(limb_sums, cnt, bits)

    # --- split dimension: alternating max/min variance by level parity ---
    # argmax/argmin take the first occurrence on ties, matching the
    # deterministic MaxBy of the reference walker.
    split_local = jnp.where(
        use_max, jnp.argmax(m2, axis=1), jnp.argmin(m2, axis=1)
    ).astype(jnp.int32)
    take = lambda a: jnp.take_along_axis(a, split_local[:, None], axis=1)[:, 0]

    if dim_axis_name is None:
        split_dim = split_local
        mid = take(mean)
        m2_at = take(m2)
        p_dim = split_dim[segidx]
        value = jnp.take_along_axis(vectors, p_dim[:, None], axis=1)[:, 0]
    else:
        # Tensor-parallel split selection over dimension shards: compare
        # the per-shard best variance globally ([S]-sized collectives
        # only), tie-break on the lowest global dimension (first-occurrence
        # semantics), then the owning shard broadcasts plane and values.
        offset = jax.lax.axis_index(dim_axis_name) * d
        lval = take(m2)
        gdim = split_local + offset
        best = jnp.where(
            use_max,
            jax.lax.pmax(lval, dim_axis_name),
            jax.lax.pmin(lval, dim_axis_name),
        )
        cand = jnp.where(lval == best, gdim, jnp.int32(2**31 - 1))
        split_dim = jax.lax.pmin(cand, dim_axis_name)
        mine = (split_dim >= offset) & (split_dim < offset + d)
        local_col = jnp.clip(split_dim - offset, 0, d - 1)
        take_g = lambda a: jnp.take_along_axis(
            a, local_col[:, None], axis=1
        )[:, 0]
        mid = jax.lax.psum(
            jnp.where(mine, take_g(mean), 0.0), dim_axis_name
        )
        m2_at = jax.lax.psum(
            jnp.where(mine, take_g(m2), 0.0), dim_axis_name
        )
        p_dim = split_dim[segidx]
        p_col = jnp.clip(p_dim - offset, 0, d - 1)
        v_local = jnp.take_along_axis(vectors, p_col[:, None], axis=1)[:, 0]
        value = jax.lax.psum(
            jnp.where(mine[segidx], v_local, 0.0), dim_axis_name
        )

    degenerate = m2_at == 0.0  # zero variance on the split dim -> id partition

    is_internal = cnt > leaf_size

    # --- per-point branch decision ---
    p_mid = mid[segidx]
    p_meanid = mean_id[segidx]
    by_id = row_ids > p_meanid
    go_high = jnp.where(
        degenerate[segidx],
        by_id,
        (value > p_mid) | ((value == p_mid) & by_id),
    )

    # Zero-progress guard: if fp rounding of the mean ever puts every point of
    # a segment on one side, force the id partition so both children are
    # nonempty and the build is guaranteed to terminate.
    hi_cnt = allsum(
        jax.ops.segment_sum(
            (go_high & active).astype(jnp.int32), segidx, num_segments=S
        )
    )
    stuck = is_internal & ((hi_cnt == 0) | (hi_cnt == cnt))
    go_high = jnp.where(stuck[segidx], by_id, go_high)

    # --- dense child numbering: children of the r-th internal segment get
    # segments 2r (low) and 2r+1 (high); node ids follow the same order. ---
    is_int_i = is_internal.astype(jnp.int32)
    internal_rank = jnp.cumsum(is_int_i) - is_int_i  # exclusive prefix sum
    num_internal = jnp.sum(is_int_i)

    p_internal = active & is_internal[segidx]
    new_seg = jnp.where(
        p_internal, 2 * internal_rank[segidx] + go_high.astype(jnp.int32), -1
    )
    became_leaf = active & ~is_internal[segidx]
    new_leaf = jnp.where(became_leaf, node_base + segidx, leaf_of_point)

    return {
        "cnt": cnt,
        "split_dim": split_dim,
        "mid": mid,
        "mean_id": mean_id,
        "degenerate": degenerate,
        # id-partitioned nodes: no plane separates the children, so the
        # search must always descend both (stored as dim = -2; the
        # reference's NULL-Dimension, DDL.sql:193-194)
        "dual": degenerate | stuck,
        "num_internal": num_internal,
        "new_seg": new_seg,
        "new_leaf": new_leaf,
    }


level_step = jax.jit(
    level_math,
    static_argnames=(
        "num_segments", "leaf_size", "axis_name", "dim_axis_name",
        "id_limb_bits", "id_limbs",
    ),
)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, (int(x) - 1).bit_length())
