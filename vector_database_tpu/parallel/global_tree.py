"""Sharded fused build: ONE global tree over row-sharded data.

This is the multi-device form of the production builder
(``ops/sorted_build.py`` with ``axis_name`` set): rows live sharded over
``mesh[axis]``, every level's segment statistics are merged with ``psum``
across the mesh, and the partition moves rows only within their own
shard. The
result is a single global BSP tree — the reference's defining capability
of building one index over data bigger than local memory
(/root/reference/README.md:91-100, FileRangeStore.cs:18-43) — with the
dataset never resident on any one device.

Layout: the node table is replicated (small — [2N] ints/floats of tree
structure); the vectors stay sharded, each shard holding its rows in local
leaf-major order; each leaf owns one contiguous (start, count) run PER
SHARD. Search runs the replicated-table traversal once and reranks
shard-locally; exactness is preserved because every in-radius row lies in
some shard's run of a reached leaf.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vector_database_tpu.ops.sorted_build import (
    _sorted_build_impl,
    id_limb_plan,
    segment_capacity,
)
from vector_database_tpu.search import _rerank, _traverse


@dataclasses.dataclass
class ShardedBSPIndex:
    """A global BSP tree whose vectors are row-sharded over a mesh.

    Node table (replicated, ``[num_nodes]``): same semantics as
    ``BSPIndex``. Leaf runs are per-shard: ``leaf_start``/``leaf_count``
    are ``[P, num_nodes]`` — leaf ``m`` holds rows
    ``[leaf_start[p, m], +leaf_count[p, m])`` of shard ``p``'s local
    arrays. ``vectors``/``orig_row`` are ``[n_pad, D]``/``[n_pad]``
    sharded along rows; each shard's block is its local leaf-major order.
    """

    dim: jax.Array
    mid: jax.Array
    low: jax.Array
    high: jax.Array
    leaf_start: jax.Array  # [P, M] local run starts
    leaf_count: jax.Array  # [P, M] local run lengths
    vectors: jax.Array  # [n_pad, D] sharded P(axis)
    orig_row: jax.Array  # [n_pad] sharded
    n: int
    depth: int
    leaf_cap: int  # max LOCAL run length
    num_leaves: int
    mesh: Mesh
    axis: str

    @property
    def num_nodes(self) -> int:
        return self.dim.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_shards(self) -> int:
        return self.leaf_start.shape[0]

    def leaf_count_global(self) -> jax.Array:
        """Global per-node leaf sizes (sum of the per-shard runs)."""
        return jnp.sum(self.leaf_count, axis=0)


@dataclasses.dataclass
class ShardedRows:
    """Pre-sharded build inputs: the process-local ingest form.

    Made by :func:`make_sharded_rows`, which loads ONLY the rows owned by
    this process's devices — the multi-controller answer to round 2's
    "full matrix on every host" gap (the reference's abandoned in-RAM
    parallel build, reference README.md:91-98). Pass to
    ``build_index_sharded`` in place of a host matrix.
    """

    vectors: jax.Array  # [n_pad, D] global array, P(axis, None)
    row_ids: jax.Array  # [n_pad] global ids, P(axis)
    n_valid: jax.Array  # [P] real-row count per shard, P(axis)
    n: int  # global row count
    mesh: Mesh
    axis: str


def _as_reader(source, n):
    """Normalize a row source to ``(reader(lo, hi) -> np.ndarray, n)``.

    Accepts a full array (convenience), a ``NativeVectorStore``-like
    object (``.rows(start, count)`` + ``len``), or a callable row-range
    reader with an explicit ``n``.
    """
    if callable(source):
        if n is None:
            raise ValueError("a callable row source needs n=")
        return source, n
    if hasattr(source, "rows"):
        return (lambda lo, hi: source.rows(lo, hi - lo)), len(source)
    arr = np.asarray(source, np.float32)
    return (lambda lo, hi: arr[lo:hi]), arr.shape[0]


def make_sharded_rows(
    source,
    mesh: Mesh,
    *,
    axis: str = "data",
    n: Optional[int] = None,
) -> ShardedRows:
    """Assemble the row-sharded global arrays for ``build_index_sharded``,
    materializing ONLY the rows owned by this process's devices.

    ``source``: a host matrix, a store with ``.rows(start, count)``, or a
    callable ``(lo, hi) -> rows`` (then ``n`` is required). Shard ``p`` of
    ``mesh[axis]`` owns global rows ``[p*ceil(n/P), ...)``; on a
    multi-controller pod each process calls this with the same source
    *description* and reads just its slice — nothing row-sized exists on
    any host beyond its own shards (``jax.make_array_from_process_local_
    data`` stitches the process-local blocks into one global array).
    Requires a 1-D placement of ``axis`` shards (the mesh's other axes,
    if any, must not shard rows).
    """
    import jax as _jax

    reader, n = _as_reader(source, n)
    shards = mesh.shape[axis]
    n_loc = -(-n // shards)
    n_pad = n_loc * shards
    d = np.asarray(reader(0, 1)).shape[1]

    vec_sh = NamedSharding(mesh, P(axis, None))
    row_sh = NamedSharding(mesh, P(axis))
    # which shard indices live on this process (contiguous for the
    # standard mesh orderings)
    if len(mesh.shape) == 1:
        my = [
            p for p, dev in enumerate(mesh.devices.flat)
            if dev.process_index == _jax.process_index()
        ]
    elif _jax.process_count() > 1:
        # a silent fall-through would make EVERY process read ALL rows
        # (the full-matrix-per-host design this function exists to kill)
        # and then crash in device_put on non-addressable devices
        raise ValueError(
            "make_sharded_rows requires a 1-D mesh on multi-controller "
            "runs; reshape the row axis into its own mesh or build "
            "per-slice (parallel.multislice)"
        )
    else:
        # single process owns every device: reading all shards IS the
        # process-local slice, and device_put below places them directly
        my = list(range(shards))
    blocks, ids, valid = [], [], []
    for p in my:
        lo, hi = p * n_loc, min((p + 1) * n_loc, n)
        rows = np.zeros((n_loc, d), np.float32)
        if hi > lo:
            rows[: hi - lo] = np.asarray(reader(lo, hi), np.float32)
        blocks.append(rows)
        ids.append(np.arange(p * n_loc, (p + 1) * n_loc, dtype=np.int32))
        valid.append(max(hi - lo, 0))
    local_vec = np.concatenate(blocks) if blocks else np.zeros(
        (0, d), np.float32
    )
    local_ids = np.concatenate(ids) if ids else np.zeros((0,), np.int32)
    local_valid = np.asarray(valid, np.int32)
    if len(mesh.shape) == 1:
        vec = _jax.make_array_from_process_local_data(
            vec_sh, local_vec, (n_pad, d)
        )
        row_ids = _jax.make_array_from_process_local_data(
            row_sh, local_ids, (n_pad,)
        )
        n_valid = _jax.make_array_from_process_local_data(
            row_sh, local_valid, (shards,)
        )
    else:
        vec = _jax.device_put(local_vec, vec_sh)
        row_ids = _jax.device_put(local_ids, row_sh)
        n_valid = _jax.device_put(local_valid, row_sh)
    return ShardedRows(
        vectors=vec, row_ids=row_ids, n_valid=n_valid, n=n,
        mesh=mesh, axis=axis,
    )


@functools.lru_cache(maxsize=None)
def _sharded_build_fn(mesh: Mesh, axis: str, n_loc: int, d: int,
                      s_max: int, m_max: int, leaf_size: int,
                      max_levels: int, stats_subsample: int,
                      tie_break: str, id_bits: int, id_limbs: int,
                      donate: bool = False):
    """jit(shard_map(sorted build)) — traced once per configuration.

    ``donate=True`` donates the input row shards into the SPMD program
    (the buffer is dead after the first level's permutation, exactly as
    in ``sorted_build_donating``) — one fewer [n_loc, D] resident per
    device.
    """

    def local(vec, ids, nv):
        nd, nm, nl, nh, nls, nlc, pid, pvec, total, level = (
            _sorted_build_impl(
                vec, ids, nv[0],
                s_max=s_max, m_max=m_max, leaf_size=leaf_size,
                max_levels=max_levels, stats_subsample=stats_subsample,
                axis_name=axis, tie_break=tie_break,
                id_limb_bits=id_bits, id_limbs=id_limbs,
            )
        )
        return nd, nm, nl, nh, nls[None], nlc[None], pid, pvec, total, level

    rep = P()
    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis)),
        out_specs=(
            rep, rep, rep, rep,  # node table: replicated
            P(axis, None), P(axis, None),  # leaf runs: per-shard
            P(axis), P(axis, None),  # pid, sorted vectors: row-sharded
            rep, rep,  # total_nodes, depth
        ),
    )
    return jax.jit(smapped, donate_argnums=(0,) if donate else ())


def build_index_sharded(
    vectors,
    mesh: Mesh,
    *,
    axis: str = "data",
    leaf_size: int = 1,
    max_levels: Optional[int] = None,
    stats_subsample: Optional[int] = None,
    tie_break: str = "positional",
    donate: bool = False,
) -> ShardedBSPIndex:
    """Build one global tree with rows sharded over ``mesh[axis]``.

    The tree is identical to ``build_index_fused``'s (bit-exact whenever
    the f32 segment sums are order-independent, e.g. integer-valued data;
    otherwise equal up to summation-order ulps in the split planes). Each
    chip only ever holds ``n / P`` rows — this is the >HBM-per-chip
    single-tree build.

    ``vectors`` may be a host array (it is placed shard-by-shard), an
    already row-sharded device array, or a :class:`ShardedRows` from
    ``make_sharded_rows`` — the process-local ingest form for
    multi-controller pods, where no host ever materializes more than its
    own row shards.

    ``donate=True`` consumes the input row-shard buffers (device-array or
    ShardedRows input): the rows are dead after the first level's
    permutation, so donating removes one [n/P, D] resident per chip —
    the same HBM headroom lever as ``build_index_fused(donate=True)``.
    """
    if isinstance(vectors, ShardedRows):
        if vectors.mesh != mesh or vectors.axis != axis:
            raise ValueError("ShardedRows built for a different mesh/axis")
        n = vectors.n
        shards = mesh.shape[axis]
        n_loc = -(-n // shards)
        vec, row_ids, n_valid = (
            vectors.vectors, vectors.row_ids, vectors.n_valid
        )
        d = vec.shape[1]
    else:
        n, d = vectors.shape
        if n == 0:
            raise ValueError("cannot build an index over zero vectors")
        shards = mesh.shape[axis]
        n_loc = -(-n // shards)
        n_pad = n_loc * shards

        vec = jnp.asarray(vectors, jnp.float32)
        if n_pad != n:
            vec = jnp.pad(vec, ((0, n_pad - n), (0, 0)))
        row_ids = jnp.arange(n_pad, dtype=jnp.int32)
        n_valid = np.clip(n - n_loc * np.arange(shards), 0, n_loc).astype(
            np.int32
        )

        vec = jax.device_put(vec, NamedSharding(mesh, P(axis, None)))
        row_ids = jax.device_put(row_ids, NamedSharding(mesh, P(axis)))
        n_valid = jax.device_put(
            jnp.asarray(n_valid), NamedSharding(mesh, P(axis))
        )
    if n == 0:
        raise ValueError("cannot build an index over zero vectors")
    if leaf_size < 1:
        raise ValueError("leaf_size must be >= 1")

    s_max = segment_capacity(n, leaf_size)
    m_max = 2 * n
    hard_cap = max_levels if max_levels is not None else n + 64
    if stats_subsample is None:
        # mirror build_index_fused's auto policy, keyed on the PER-SHARD
        # row count (the [n_loc/k, D] prefix transients are what squeeze
        # a device). The fused single-device path subsamples at 4 above
        # 500k rows; with subsample=1 the AOT buffer dump shows an
        # extra ~11 G at 10M rows/device (gate copy + x^2 transient +
        # the cumsum's [D, N] relayout, each [N, D]-sized), not any
        # shard_map-specific relayout as round 3 guessed.
        stats_subsample = 4 if n_loc > 500_000 else 1
    # the limb plan is bounded by the GLOBAL row count: per-shard limb
    # cumsums are psum-merged, so the global segment sums carry n terms
    id_bits, id_limbs = id_limb_plan(n) if tie_break == "mean_id" \
        else (7, 5)

    fn = _sharded_build_fn(
        mesh, axis, n_loc, d, s_max, m_max, leaf_size, hard_cap,
        stats_subsample, tie_break, id_bits, id_limbs, donate,
    )
    nd, nm, nl, nh, nls, nlc, pid, pvec, total, level = fn(
        vec, row_ids, n_valid
    )
    m = int(total)
    depth = int(level)
    leaf_count = nlc[:, :m]
    leaf_cap = int(jnp.max(leaf_count))
    num_leaves = int(jnp.sum(nd[:m] == -1))

    return ShardedBSPIndex(
        dim=nd[:m],
        mid=nm[:m],
        low=nl[:m],
        high=nh[:m],
        leaf_start=nls[:, :m],
        leaf_count=leaf_count,
        vectors=pvec,
        orig_row=pid,
        n=n,
        depth=depth,
        leaf_cap=leaf_cap,
        num_leaves=num_leaves,
        mesh=mesh,
        axis=axis,
    )


def to_bsp(index: ShardedBSPIndex):
    """Gather a sharded tree into a single-device ``BSPIndex`` (host-side;
    for checkpointing or single-chip serving of a mesh-built tree).

    Rows are re-packed leaf-major globally (shard-p runs of each leaf
    concatenate in shard order), so every leaf becomes one contiguous
    global run.
    """
    from vector_database_tpu.models.bsp import BSPIndex

    p = index.num_shards
    m = index.num_nodes
    vec = np.asarray(index.vectors)
    orig = np.asarray(index.orig_row)
    n_loc = vec.shape[0] // p
    starts = np.asarray(index.leaf_start)  # [P, M]
    counts = np.asarray(index.leaf_count)
    g_count = counts.sum(axis=0)
    g_start = np.concatenate([[0], np.cumsum(g_count)[:-1]]).astype(
        np.int32
    )

    # Vectorized repack: each (leaf, shard) run is contiguous in both
    # the source (shard-local leaf range) and the destination (shards
    # concatenate in shard order inside each leaf's global run), and the
    # runs enumerate in (leaf asc, shard asc) = destination order — so
    # the whole permutation is ONE gather built from run lengths. The
    # per-leaf Python loop this replaces ran num_leaves * P interpreter
    # iterations (~10M at the default leaf_size=1 on a 10M-row tree).
    leaves = np.nonzero(np.asarray(index.dim) == -1)[0]
    lens = counts[:, leaves].T.ravel()  # [L*P] in (leaf, shard) order
    src0 = (
        (np.arange(p, dtype=np.int64) * n_loc)[None, :]
        + starts[:, leaves].T
    ).ravel()
    total = int(lens.sum())
    assert total == index.n, (total, index.n)
    run_id = np.repeat(np.arange(lens.size), lens)
    run_begin = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pos_in_run = np.arange(total) - np.repeat(run_begin, lens)
    src = src0[run_id] + pos_in_run
    out_vec = vec[src]
    out_row = orig[src]

    return BSPIndex(
        dim=index.dim,
        mid=index.mid,
        low=index.low,
        high=index.high,
        leaf_start=jnp.asarray(g_start),
        leaf_count=jnp.asarray(g_count.astype(np.int32)),
        vectors=jnp.asarray(out_vec),
        orig_row=jnp.asarray(out_row),
        depth=index.depth,
        leaf_cap=int(g_count.max()) if m else 0,
        num_leaves=index.num_leaves,
    )


@functools.lru_cache(maxsize=None)
def _shard_search_fn(mesh: Mesh, axis: str, max_leaves: int,
                     max_stack: int, leaf_cap: int):
    """jit(shard_map(traverse + local rerank)); node tables are passed as
    replicated *arguments* (a closure capture would ship them as
    compile-payload constants). Cached per configuration."""

    def local(dim, mid, low, high, lstart, lcount, vecs, orig, q, radius):
        lstart, lcount = lstart[0], lcount[0]
        leaves, _, ov = _traverse(
            dim, mid, low, high, q, radius,
            max_leaves=max_leaves, max_stack=max_stack,
        )
        rows, d2, match, ncand, _ = _rerank(
            lstart, lcount, vecs, orig, leaves, q, radius,
            leaf_cap=leaf_cap,
        )
        return (
            rows[None], d2[None], ov,
            jnp.sum(match, axis=1).astype(jnp.int32)[None],
            ncand.astype(jnp.int32)[None],
        )

    ax = axis
    rep = P()
    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            rep, rep, rep, rep,  # node table: replicated
            P(ax, None), P(ax, None), P(ax, None), P(ax),  # local data
            rep, rep,  # queries, radius
        ),
        out_specs=(
            P(ax, None, None), P(ax, None, None), rep,
            P(ax, None), P(ax, None),
        ),
    )
    return jax.jit(smapped)


def _shard_local_search(index: ShardedBSPIndex, queries, radius,
                        max_leaves: int):
    """Per-shard (rows, d2, overflow, counts, candidates): the traversal
    consumes only replicated inputs, so every shard computes it without
    communication; the rerank reads the shard's local rows."""
    fn = _shard_search_fn(
        index.mesh, index.axis, max_leaves, index.depth + 2,
        max(index.leaf_cap, 1),
    )
    return fn(
        index.dim, index.mid, index.low, index.high,
        index.leaf_start, index.leaf_count, index.vectors,
        index.orig_row, queries, radius,
    )


def search_global(
    index: ShardedBSPIndex,
    queries,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """Exact ε-ball search on the sharded global tree.

    Returns ``(rows [Q, P*C], sq_dists [Q, P*C], count [Q],
    overflow [Q])`` — matching global rows with -1 / +inf padding.
    """
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    radius = jnp.float32(radius)
    max_leaves = min(max_leaves, max(index.num_leaves, 1))
    rows_p, d2_p, ov, cnt, _ = _shard_local_search(
        index, queries, radius, max_leaves
    )
    p, q, c = rows_p.shape
    rows = jnp.moveaxis(rows_p, 0, 1).reshape(q, p * c)
    d2 = jnp.moveaxis(d2_p, 0, 1).reshape(q, p * c)
    return rows, d2, jnp.sum(cnt, axis=0), ov


def _knn_global_async(
    index: ShardedBSPIndex,
    queries,
    k: int,
    radius,
    *,
    max_leaves: int = 256,
):
    """Dispatch-only form of ``knn_global``: returns ``(rows, d2, ov)``
    DEVICE arrays with no host sync, so callers looping over several
    indexes (``knn_multislice``) can enqueue every slice's program
    before materializing any result."""
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    radius = jnp.float32(radius)
    max_leaves = min(max_leaves, max(index.num_leaves, 1))
    rows_p, d2_p, ov, _, _ = _shard_local_search(
        index, queries, radius, max_leaves
    )
    from vector_database_tpu.parallel.forest import merge_topk

    rows, d2 = merge_topk(rows_p, d2_p, k=k)
    return rows, d2, ov


def knn_global(
    index: ShardedBSPIndex,
    queries,
    k: int,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """k nearest within ``radius`` on the sharded tree: per-shard rerank,
    global top-k merge (the all-gather of the per-shard [Q, k] results
    is the only cross-device traffic). Returns ``(rows [Q, k], sq_dists [Q, k])``."""
    # the merge is dispatched BEFORE the overflow check: the check's
    # scalar transfer then overlaps the merge compute instead of
    # serializing every call in front of it
    out_rows, out_d2, ov = _knn_global_async(
        index, queries, k, radius, max_leaves=max_leaves
    )
    out = (out_rows, out_d2)
    if bool(jnp.any(ov)):
        import warnings

        ovq = ov if ov.ndim == 1 else jnp.any(ov, axis=0)
        warnings.warn(
            "knn_global: the per-shard leaf buffer overflowed for "
            f"{int(jnp.sum(ovq))} queries; their "
            "candidate sets are truncated (results may miss neighbors). "
            "Raise max_leaves or use the sharded scan "
            "(sharded_scan_knn) for non-selective queries.",
            RuntimeWarning,
            stacklevel=2,
        )
    return out
