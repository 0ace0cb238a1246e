"""Level-synchronous BSP index builder.

Accelerator re-design of the reference index build. The reference offers two
formulations of the same algorithm:

- a sequential per-range tree walker (VectorIndex/IndexBuilder.cs:23-213):
  one node at a time, two passes over its points;
- a level-synchronous SQL loop (DDL.sql:44-202): one pass per *level*, doing
  the stats and the partition for every live range in set-oriented
  statements.

This builder adopts the second shape, because a whole-level segmented
reduction + partition over a device-resident ``[N, D]`` matrix is exactly
what XLA executes well: ~log2(N / leaf_size) jit-compiled device passes total,
instead of ~2N sequential node visits.

The host loop only moves O(num_segments) scalars per level (split dim, mid,
count) to assemble the node table; all O(N·D) work stays on device.

``leaf_size=1`` reproduces the reference tree contract exactly (every range
is split until singletons, IndexBuilder.cs:81-88); larger leaf buckets trade
tree depth for rerank width, like ``MemoryVectorIndex``'s ``listThreshold``
(MemoryVectorIndex.cs:25).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vector_database_tpu.models.bsp import BSPIndex
from vector_database_tpu.ops.level import level_step, next_pow2
from vector_database_tpu.ops.sorted_build import (
    id_limb_plan,
    segment_capacity,
    sorted_build,
    sorted_build_donating,
)


@functools.lru_cache(maxsize=None)
def _sharded_level_fn(mesh: Mesh, axis: str, dim_axis: Optional[str],
                      num_segments: int, leaf_size: int,
                      id_bits: int = 7, id_limbs: int = 5):
    """jit(shard_map(level_step)) over a row-sharded matrix.

    Per-point arrays are sharded along ``axis``; per-segment stats come back
    replicated (merged inside via psum/pmin/pmax across the mesh). With
    ``dim_axis`` the D axis is additionally sharded (tensor-parallel stats,
    SURVEY.md §2.2 TP row). Cached so each combination traces exactly once.
    """

    def fn(vectors, row_ids, seg, leaf, use_max, node_base):
        return level_step(
            vectors, row_ids, seg, leaf, use_max, node_base,
            num_segments=num_segments, leaf_size=leaf_size, axis_name=axis,
            dim_axis_name=dim_axis, id_limb_bits=id_bits,
            id_limbs=id_limbs,
        )

    sh = P(axis)
    rep = P()
    smapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis, dim_axis), sh, sh, sh, rep, rep),
        out_specs={
            "cnt": rep, "split_dim": rep, "mid": rep, "mean_id": rep,
            "degenerate": rep, "dual": rep, "num_internal": rep,
            "new_seg": sh, "new_leaf": sh,
        },
    )
    return jax.jit(smapped)


def build_index(
    vectors,
    *,
    leaf_size: int = 1,
    max_levels: Optional[int] = None,
    progress: Optional[Callable[[int, int, int], None]] = None,
    emit: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
    axis: str = "data",
    dim_axis: Optional[str] = None,
) -> BSPIndex:
    """Build a variance-split BSP index over ``vectors``.

    Args:
      vectors: ``[N, D]`` array (any float type; cast to float32).
      leaf_size: stop splitting ranges at this size. 1 = reference shape.
      max_levels: optional hard cap on tree depth; remaining ranges become
        (oversized) leaf buckets.
      progress: optional callback ``(level, live_segments, active_points)`` —
        the moral equivalent of the reference's throttled progress log
        (IndexBuilder.cs:43-53).
      emit: optional callback ``(node_base, dim, mid, low, high)`` invoked
        with each level's numpy node block THE MOMENT it is computed —
        nodes stream to the consumer before the build finishes, the
        push-form of the reference's lazy pull enumeration
        (``yield (rangeId, RangeValue)``, IndexBuilder.cs:23-25, 81-92).
        Node ids are ``node_base + i`` for row ``i`` of the block;
        ``dim == -1`` rows are leaves, ``-2`` dual splits.
      mesh: optional device mesh. When given, rows are sharded over
        ``mesh[axis]`` and each level merges per-shard segment statistics
        with XLA collectives — one *global* tree, built data-parallel.
      axis: mesh axis name holding the row shards.

    Returns:
      A ``BSPIndex`` with dense node ids in level-major order (root = 0).
    """
    vectors = jnp.asarray(vectors, dtype=jnp.float32)
    n, d = vectors.shape
    if n == 0:
        raise ValueError("cannot build an index over zero vectors")
    if leaf_size < 1:
        raise ValueError("leaf_size must be >= 1")

    n_pad = n
    if mesh is not None:
        shards = mesh.shape[axis]
        n_pad = ((n + shards - 1) // shards) * shards

    row_ids = jnp.arange(n_pad, dtype=jnp.int32)
    seg = jnp.where(row_ids < n, 0, -1).astype(jnp.int32)
    leaf_of_point = jnp.full((n_pad,), -1, dtype=jnp.int32)
    if n_pad != n:
        vectors = jnp.pad(vectors, ((0, n_pad - n), (0, 0)))

    if mesh is not None:
        if dim_axis is not None and d % mesh.shape[dim_axis]:
            raise ValueError(
                "vector dim must divide evenly across the dim_axis shards"
            )
        row_sh = NamedSharding(mesh, P(axis))
        mat_sh = NamedSharding(mesh, P(axis, dim_axis))
        vectors = jax.device_put(vectors, mat_sh)
        row_ids = jax.device_put(row_ids, row_sh)
        seg = jax.device_put(seg, row_sh)
        leaf_of_point = jax.device_put(leaf_of_point, row_sh)

    # Host-side node table accumulators, one numpy block per level.
    lvl_dim: list[np.ndarray] = []
    lvl_mid: list[np.ndarray] = []
    lvl_low: list[np.ndarray] = []
    lvl_high: list[np.ndarray] = []

    s_live = 1
    node_base = 0
    use_max = True
    level = 0
    num_leaves = 0
    # Safety cap: forced progress shrinks every internal segment each level,
    # but adversarial data can still be skewed; default to a generous bound.
    hard_cap = max_levels if max_levels is not None else n + 64

    # exact mean-id tie statistics need an int32-safe limb plan for n
    id_bits, id_limbs = id_limb_plan(n)

    while True:
        s_pad = next_pow2(s_live)
        if mesh is None:
            out = level_step(
                vectors,
                row_ids,
                seg,
                leaf_of_point,
                jnp.asarray(use_max),
                jnp.asarray(node_base, dtype=jnp.int32),
                num_segments=s_pad,
                leaf_size=leaf_size,
                id_limb_bits=id_bits,
                id_limbs=id_limbs,
            )
        else:
            out = _sharded_level_fn(mesh, axis, dim_axis, s_pad, leaf_size,
                                    id_bits, id_limbs)(
                vectors,
                row_ids,
                seg,
                leaf_of_point,
                jnp.asarray(use_max),
                jnp.asarray(node_base, dtype=jnp.int32),
            )
        # one blocking device-to-host copy for all four per-level
        # outputs instead of four separate np.asarray fetches per level
        host = jax.device_get({k: out[k][:s_live]
                               for k in ("cnt", "split_dim", "mid", "dual")})
        cnt, split_dim = host["cnt"], host["split_dim"]
        mid, dual = host["mid"], host["dual"]
        # dual (id-partitioned) nodes have no separating plane: dim = -2
        split_dim = np.where(dual, -2, split_dim)
        mid = np.where(dual, 0.0, mid).astype(np.float32)

        is_int = cnt > leaf_size
        num_internal = int(is_int.sum())
        at_cap = level + 1 >= hard_cap and num_internal > 0

        if progress is not None:
            progress(level, s_live, int(cnt.sum()))

        if at_cap:
            # Forcibly retire every remaining segment as an oversized leaf.
            is_int = np.zeros_like(is_int)
            num_internal = 0
            leaf_of_point = jnp.where(
                seg >= 0, node_base + seg, leaf_of_point
            )
        else:
            seg = out["new_seg"]
            leaf_of_point = out["new_leaf"]

        rank = np.cumsum(is_int) - is_int
        next_base = node_base + s_live
        num_leaves += s_live - num_internal
        lvl_dim.append(np.where(is_int, split_dim, -1).astype(np.int32))
        lvl_mid.append(np.where(is_int, mid, 0.0).astype(np.float32))
        lvl_low.append(
            np.where(is_int, next_base + 2 * rank, -1).astype(np.int32)
        )
        lvl_high.append(
            np.where(is_int, next_base + 2 * rank + 1, -1).astype(np.int32)
        )
        if emit is not None:
            emit(node_base, lvl_dim[-1], lvl_mid[-1], lvl_low[-1],
                 lvl_high[-1])

        if num_internal == 0:
            num_nodes = next_base
            break

        node_base = next_base
        s_live = 2 * num_internal
        use_max = not use_max
        level += 1

    depth = level + 1
    node_dim = jnp.asarray(np.concatenate(lvl_dim))
    node_mid = jnp.asarray(np.concatenate(lvl_mid))
    node_low = jnp.asarray(np.concatenate(lvl_low))
    node_high = jnp.asarray(np.concatenate(lvl_high))

    leaf_start, leaf_count, sorted_vectors, orig_row = _finalize(
        vectors, leaf_of_point, num_segments=next_pow2(num_nodes), n=n
    )
    leaf_start = leaf_start[:num_nodes]
    leaf_count = leaf_count[:num_nodes]
    leaf_cap = int(jnp.max(leaf_count))

    return BSPIndex(
        dim=node_dim,
        mid=node_mid,
        low=node_low,
        high=node_high,
        leaf_start=leaf_start,
        leaf_count=leaf_count,
        vectors=sorted_vectors,
        orig_row=orig_row,
        depth=depth,
        leaf_cap=leaf_cap,
        num_leaves=num_leaves,
    )


def build_index_fused(
    vectors,
    *,
    leaf_size: int = 1,
    max_levels: Optional[int] = None,
    stats_subsample: Optional[int] = None,
    donate: bool = False,
    tie_break: str = "positional",
    progress: Optional[Callable[[int, int, int], None]] = None,
    split: str = "alternate",
) -> BSPIndex:
    """Single-compile build: the whole level loop in one device program.

    Scatter-free sorted-segment formulation (``ops/sorted_build.py``): no
    per-level host round-trips, no [N]-sized scatters or sorts, and the
    output layout is produced in place — exactly one XLA compile per
    (n, d, leaf_size). This is the production path for the <30 s / 10M
    benchmark target. Tree shape can differ from ``build_index`` in the
    last float ulp of the split planes (prefix-sum vs scatter-sum order);
    the search contract is identical.

    ``tie_break``: how rows exactly on the split plane (and degenerate
    zero-variance segments) divide. ``"positional"`` (default) halves the
    tied set by rank — exact with zero extra passes. ``"mean_id"``
    reproduces the reference rule ``id > floor(mean(ids))``
    (IndexBuilder.cs:113-123, DDL.sql:100-110) with exact limb-summed id
    statistics, for reference tree-shape parity.

    ``progress``: optional host callback ``(level, live_segments,
    active_rows)`` streamed from INSIDE the compiled while_loop via
    ``jax.debug.callback`` — the reference's throttled console log
    (IndexBuilder.cs:43-53) for the one-compile path. Each distinct
    callback object compiles its own program; pass a stable function.

    ``split``: ``"alternate"`` (default) is the reference's max/min-stdev
    parity rule (IndexBuilder.cs:75-79, DDL.sql:151); ``"max"`` splits on
    the max-variance dimension at EVERY level — no zero-variance plane is
    ever chosen while any dimension still discriminates, which keeps
    every split strict and makes single-branch descent
    (:func:`~vector_database_tpu.search.locate`) exact. Used by the
    boolean/KB mode.
    """
    vectors = jnp.asarray(vectors, dtype=jnp.float32)
    n, d = vectors.shape
    if n == 0:
        raise ValueError("cannot build an index over zero vectors")
    if leaf_size < 1:
        raise ValueError("leaf_size must be >= 1")
    if tie_break not in ("positional", "mean_id"):
        raise ValueError("tie_break must be 'positional' or 'mean_id'")
    if split not in ("alternate", "max"):
        raise ValueError("split must be 'alternate' or 'max'")
    # mean-id ties: pick the widest int32-safe limb for this n (7-bit to
    # ~16M rows, narrower beyond — uncapped like the reference's Int128)
    id_bits, id_limbs = id_limb_plan(n) if tie_break == "mean_id" \
        else (7, 5)

    s_max = segment_capacity(n, leaf_size)
    m_max = 2 * n
    hard_cap = max_levels if max_levels is not None else n + 64
    if stats_subsample is None:
        # Above ~500k rows, subsample the variance ranking pass (the split
        # planes themselves stay exact) — 4x less prefix-sum traffic and
        # the [N, D] prefix transients shrink below the HBM squeeze point.
        stats_subsample = 4 if n > 500_000 else 1

    build_fn = sorted_build_donating if donate else sorted_build
    nd, nm, nl, nh, nls, nlc, pid, pvec, total_nodes, level = build_fn(
        vectors,
        jnp.arange(n, dtype=jnp.int32),
        jnp.int32(n),
        s_max=s_max,
        m_max=m_max,
        leaf_size=leaf_size,
        max_levels=hard_cap,
        stats_subsample=stats_subsample,
        tie_break=tie_break,
        progress_cb=progress,
        split=split,
        id_limb_bits=id_bits,
        id_limbs=id_limbs,
    )
    m = int(total_nodes)
    depth = int(level)
    leaf_count = nlc[:m]
    leaf_cap = int(jnp.max(leaf_count))
    num_leaves = int(jnp.sum(nd[:m] == -1))  # -2 = dual internal, not leaf

    return BSPIndex(
        dim=nd[:m],
        mid=nm[:m],
        low=nl[:m],
        high=nh[:m],
        leaf_start=nls[:m],
        leaf_count=leaf_count,
        vectors=pvec,
        orig_row=pid,
        depth=depth,
        leaf_cap=leaf_cap,
        num_leaves=num_leaves,
    )


@functools.partial(jax.jit, static_argnames=("num_segments", "n"))
def _finalize(vectors, leaf_of_point, *, num_segments, n):
    """Reorder points leaf-major and compute per-node bucket slices.

    Padding rows (sharded builds pad N up to the mesh size) carry
    ``leaf_of_point == -1``; they are remapped past every real node so they
    sort to the tail and are sliced away.
    """
    leaf = jnp.where(
        leaf_of_point < 0, num_segments, leaf_of_point
    ).astype(jnp.int32)
    order = jnp.argsort(leaf, stable=True).astype(jnp.int32)
    counts = jax.ops.segment_sum(
        jnp.ones_like(leaf), leaf, num_segments=num_segments + 1
    )[:num_segments]
    starts = jnp.cumsum(counts) - counts
    return starts.astype(jnp.int32), counts.astype(jnp.int32), \
        vectors[order[:n]], order[:n]
