"""Sharded forest: the N-axis (database size) scaling story.

SURVEY.md §5: the reference's only scaling axis is data volume on one
machine (the mmap store); the device equivalent is sharding the vector count
across the mesh. Each shard owns a contiguous block of rows and its own BSP
tree; a query fans out to every shard in SPMD (one ``shard_map``), each
device walks its local tree and reranks its local candidates, and the
per-shard top-k results are merged into a global top-k — one all-gather
(SURVEY.md §2.2's "allgather-top-k merge").

Exactness is preserved: every member of the global top-k within ``radius``
is in its own shard's top-k, so the union of shard results contains the
global answer.

Shard trees differ in size, so node tables and vector blocks are padded to
the max across shards; padded vectors are +inf (never match) and padded
nodes are unreachable leaves.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vector_database_tpu.builder import build_index_fused
from vector_database_tpu.search import _rerank, _traverse


@functools.partial(jax.jit, static_argnames=("k",))
def merge_topk(rows_p, d2_p, *, k):
    """Exact global top-k over per-shard [P, Q, C] shortlists.

    Module-level jit: every mesh serving path (forest, sharded tree,
    sharded scan) reuses ONE cache entry per shape instead of retracing
    per call. The all-gather of the shard-laid-out inputs is inserted by
    XLA when the replicated-output top-k consumes them.
    """
    p, q, c = rows_p.shape
    rows_f = jnp.moveaxis(rows_p, 0, 1).reshape(q, p * c)
    d2_f = jnp.moveaxis(d2_p, 0, 1).reshape(q, p * c)
    neg, pos = jax.lax.top_k(-d2_f, min(k, p * c))
    out_rows = jnp.take_along_axis(rows_f, pos, axis=1)
    d2 = -neg
    return jnp.where(jnp.isfinite(d2), out_rows, -1), d2


@dataclasses.dataclass
class ShardedForest:
    """Per-shard BSP trees, stacked [P, ...] and placed shard-per-device."""

    dim: jax.Array  # [P, M]
    mid: jax.Array
    low: jax.Array
    high: jax.Array
    leaf_start: jax.Array
    leaf_count: jax.Array
    vectors: jax.Array  # [P, Nmax, D]
    orig_row: jax.Array  # [P, Nmax] global rows
    depth: int
    leaf_cap: int
    num_shards: int
    mesh: Mesh
    axis: str


def build_forest(
    vectors,
    mesh: Mesh,
    *,
    axis: str = "data",
    leaf_size: int = 8,
) -> ShardedForest:
    """Split rows into contiguous blocks, one BSP tree per shard.

    On a real pod each host builds its own block; on a single host the
    blocks are built sequentially and the stacked tables are placed with
    the shard dim over ``mesh[axis]``.
    """
    vectors = np.asarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    shards = mesh.shape[axis]
    if n < shards:
        raise ValueError(
            f"build_forest needs at least one vector per shard "
            f"(n={n} < shards={shards}); use build_index for tiny sets"
        )
    bounds = np.linspace(0, n, shards + 1).astype(int)

    indexes, offsets = [], []
    for p in range(shards):
        lo, hi = bounds[p], bounds[p + 1]
        indexes.append(
            build_index_fused(vectors[lo:hi], leaf_size=leaf_size)
        )
        offsets.append(lo)

    m_max = max(ix.num_nodes for ix in indexes)
    n_max = max(ix.n for ix in indexes)
    depth = max(ix.depth for ix in indexes)
    leaf_cap = max(ix.leaf_cap for ix in indexes)

    def stack(get, pad_value, width):
        cols = [np.asarray(get(ix)) for ix in indexes]
        out = np.full(
            (shards, width), pad_value, dtype=cols[0].dtype
        )
        for p, c in enumerate(cols):
            out[p, : c.shape[0]] = c
        return jnp.asarray(out)

    vec = np.full((shards, n_max, d), np.inf, dtype=np.float32)
    orig = np.full((shards, n_max), -1, dtype=np.int32)
    for p, ix in enumerate(indexes):
        vec[p, : ix.n] = np.asarray(ix.vectors)
        orig[p, : ix.n] = np.asarray(ix.orig_row) + offsets[p]

    sh = lambda *rest: NamedSharding(mesh, P(axis, *rest))
    forest = ShardedForest(
        dim=jax.device_put(stack(lambda i: i.dim, -1, m_max), sh(None)),
        mid=jax.device_put(stack(lambda i: i.mid, 0.0, m_max), sh(None)),
        low=jax.device_put(stack(lambda i: i.low, -1, m_max), sh(None)),
        high=jax.device_put(stack(lambda i: i.high, -1, m_max), sh(None)),
        leaf_start=jax.device_put(
            stack(lambda i: i.leaf_start, 0, m_max), sh(None)
        ),
        leaf_count=jax.device_put(
            stack(lambda i: i.leaf_count, 0, m_max), sh(None)
        ),
        vectors=jax.device_put(jnp.asarray(vec), sh(None, None)),
        orig_row=jax.device_put(jnp.asarray(orig), sh(None)),
        depth=depth,
        leaf_cap=leaf_cap,
        num_shards=shards,
        mesh=mesh,
        axis=axis,
    )
    return forest


@functools.lru_cache(maxsize=None)
def _forest_local_fn(mesh: Mesh, axis: str, k: int, max_leaves: int,
                     max_stack: int, leaf_cap: int):
    """jit(shard_map(per-shard walk + rerank + local top-k)) — traced once
    per configuration (the ``_shard_search_fn`` pattern: radius is an
    ARGUMENT, not a capture, so each same-shape call reuses the cache)."""

    def local(dim, mid, low, high, lstart, lcount, vecs, orig, q, radius):
        dim, mid, low, high = dim[0], mid[0], low[0], high[0]
        lstart, lcount, vecs, orig = lstart[0], lcount[0], vecs[0], orig[0]
        leaves, _, ov = _traverse(
            dim, mid, low, high, q, radius,
            max_leaves=max_leaves, max_stack=max_stack,
            axis_name=axis,
        )
        rows, d2, _, _, _ = _rerank(
            lstart, lcount, vecs, orig, leaves, q, radius,
            leaf_cap=leaf_cap,
        )
        neg, pos = jax.lax.top_k(-d2, min(k, d2.shape[1]))
        top_rows = jnp.take_along_axis(rows, pos, axis=1)
        return top_rows[None], (-neg)[None], ov[None]

    rep = P()
    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None),
            P(axis, None), P(axis, None),
            P(axis, None), P(axis, None),
            P(axis, None, None), P(axis, None),
            rep, rep,
        ),
        out_specs=(
            P(axis, None, None), P(axis, None, None),
            P(axis, None),
        ),
    )
    return jax.jit(smapped)


def forest_knn(
    forest: ShardedForest,
    queries,
    k: int,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """Global k-NN within ``radius``: SPMD per-shard walk + top-k merge.

    Returns ``(rows [Q, k], sq_dists [Q, k], overflow [P, Q])``; rows are
    global row ids, -1 / +inf padding when fewer than k matches exist.
    """
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    radius = jnp.float32(radius)
    fn = _forest_local_fn(
        forest.mesh, forest.axis, k, max_leaves, forest.depth + 2,
        forest.leaf_cap,
    )
    rows_p, d2_p, ov = fn(
        forest.dim, forest.mid, forest.low, forest.high,
        forest.leaf_start, forest.leaf_count, forest.vectors,
        forest.orig_row, queries, radius,
    )
    rows, d2 = merge_topk(rows_p, d2_p, k=k)
    return rows, d2, ov
