"""Batched lockstep tree search with exact rerank.

Device re-design of the reference's two query paths:

- the recursive-CTE walk of ``dbo.Search`` (reference DDL.sql:234-295):
  from the root, descend low when ``mid >= q[dim] - radius`` and high when
  ``mid <= q[dim] + radius`` — possibly *both* — and collect reached leaves;
- the sequential DFS of ``MemoryVectorIndex.Find``
  (MemoryVectorIndex.cs:242-345).

Here thousands of queries run that walk in lockstep: a ``lax.while_loop``
DFS with an explicit per-query stack, vmapped over the query batch, so every
step is a ``[Q]``-wide gather from the SoA node table. The stack bound is
exact: a DFS that pops one node and pushes at most two children keeps at most
``depth + 1`` pending entries.

The traversal returns a candidate *superset* (axis-aligned plane tests only);
the rerank computes exact distances over the gathered leaf buckets and
filters — the same contract as the reference, where the caller's predicate
performs exact verification (MemoryVectorIndex.cs:237-241, README.md:72).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from vector_database_tpu.models.bsp import BSPIndex


@dataclasses.dataclass
class SearchResult:
    """Result of a batched radius search.

    Attributes:
      rows: ``[Q, C]`` int32 — matching original input rows, -1 padding.
      sq_dists: ``[Q, C]`` float32 — squared distances, +inf at padding.
      count: ``[Q]`` int32 — number of matches per query.
      candidates: ``[Q]`` int32 — candidates examined per query (the
        generalization of the reference tests' predicate-call statistic,
        MemoryVectorIndexTests.cs:191-196).
      cand_rows: ``[Q, C]`` int32 — every candidate row the traversal
        surfaced, before the exact filter (-1 padding): the reference's
        raw ``dbo.Search`` output contract (candidate superset,
        README.md:72).
      overflow: ``[Q]`` bool — leaf buffer overflowed; results for that
        query may be incomplete (retry with larger ``max_leaves``).
    """

    rows: jax.Array
    sq_dists: jax.Array
    count: jax.Array
    candidates: jax.Array
    cand_rows: jax.Array
    overflow: jax.Array

    def match_rows(self, i: int) -> np.ndarray:
        """Matching original rows of query ``i`` as a numpy array."""
        r = np.asarray(self.rows[i])
        return r[r >= 0]


@functools.partial(
    jax.jit, static_argnames=("max_leaves", "max_stack", "axis_name")
)
def _traverse(dim, mid, low, high, queries, radius, *, max_leaves,
              max_stack, axis_name=None):
    """Masked dual-branch descent; returns reached leaf node ids per query.

    ``axis_name``: when running inside ``shard_map`` over sharded node
    tables, the while-loop carry must be marked device-varying up front
    (the body makes it varying, and shard_map's vma checker requires the
    init to match)."""

    # Pack the per-node fields into one [M, 4] row so each visit costs ONE
    # scalar-row gather instead of four — random gathers from the node
    # table are the traversal's dominant cost (each small load is its
    # own memory transaction regardless of payload width).
    packed = jnp.stack(
        [dim, jax.lax.bitcast_convert_type(mid, jnp.int32), low, high],
        axis=1,
    )

    def one(q):
        def cond(st):
            return st[1] > 0

        def body(st):
            stack, sp, leaves, nl, ov = st
            node = stack[sp - 1]
            sp = sp - 1
            row = packed[node]
            d = row[0]
            m = jax.lax.bitcast_convert_type(row[1], jnp.float32)
            is_leaf = d == -1
            # dim == -2: id/position-partitioned node — no plane separates
            # the children, always descend both (the reference's
            # NULL-Dimension branch, DDL.sql:276-277, 291-292)
            dual = d == -2
            can = nl < max_leaves
            put = is_leaf & can
            leaves = jnp.where(
                put, leaves.at[jnp.clip(nl, 0, max_leaves - 1)].set(node),
                leaves,
            )
            nl = nl + put.astype(jnp.int32)
            ov = ov | (is_leaf & ~can)

            qd = q[jnp.maximum(d, 0)]
            vis_lo = (~is_leaf) & (dual | (m >= qd - radius))
            vis_hi = (~is_leaf) & (dual | (m <= qd + radius))
            stack = jnp.where(vis_hi, stack.at[sp].set(row[3]), stack)
            sp = sp + vis_hi.astype(jnp.int32)
            stack = jnp.where(vis_lo, stack.at[sp].set(row[2]), stack)
            sp = sp + vis_lo.astype(jnp.int32)
            return stack, sp, leaves, nl, ov

        init = (
            jnp.zeros((max_stack,), jnp.int32),  # stack[0] = root = 0
            jnp.int32(1),
            jnp.full((max_leaves,), -1, jnp.int32),
            jnp.int32(0),
            jnp.asarray(False),
        )
        if axis_name is not None:
            init = jax.lax.pcast(init, axis_name, to="varying")
        _, _, leaves, nl, ov = jax.lax.while_loop(cond, body, init)
        return leaves, nl, ov

    return jax.vmap(one)(queries)


@functools.partial(jax.jit, static_argnames=("max_leaves", "depth"))
def _traverse_bfs(dim, mid, low, high, queries, radius, *, max_leaves,
                  depth):
    """Level-synchronous frontier expansion — the recursive-CTE
    formulation (reference DDL.sql:255-294) run for a whole query batch:
    a ``[Q, F]`` frontier matrix, ONE iteration per tree level.

    The DFS (:func:`_traverse`) runs one while-loop iteration per visited
    node (~2x reached leaves); this runs ``depth + 1`` iterations total,
    each a batched gather + masked expand + left-compaction.

    Not the default: the traversal is gather/sort-bound, not
    iteration-bound — the per-level ``[Q, 2F]`` argsort compaction costs
    more than the DFS's extra iterations, and total node-table gather
    traffic is ~F/2 x higher. Kept as the faithful set-oriented
    formulation and for backends where sorts are cheap; ``search``
    defaults to the DFS.

    Reached leaves stay in the frontier as terminal entries (a leaf
    "expands" to itself), so the frontier IS the leaf buffer when the
    loop ends; entries dropped past width F set the overflow flag, the
    same contract as the DFS.
    """
    f = max_leaves
    q = queries.shape[0]
    lane = jnp.arange(f, dtype=jnp.int32)

    def body(_, st):
        node, act, ov = st
        nd = jnp.where(act, dim[node], -3)  # -3: inactive slot
        m = mid[node]
        qd = jnp.take_along_axis(queries, jnp.maximum(nd, 0), axis=1)
        is_leaf = nd == -1
        internal = act & (nd != -1)
        dual = nd == -2
        vis_lo = internal & (dual | (m >= qd - radius))
        vis_hi = internal & (dual | (m <= qd + radius))
        c0 = jnp.where(
            act & is_leaf, node, jnp.where(vis_lo, low[node], -1)
        )
        c1 = jnp.where(vis_hi, high[node], -1)
        cand = jnp.concatenate([c0, c1], axis=1)  # [Q, 2F]
        valid = cand >= 0
        cnt = jnp.sum(valid, axis=1)
        # left-compact the valid entries (stable: keeps sibling order)
        order = jnp.argsort(~valid, axis=1, stable=True)[:, :f]
        node = jnp.take_along_axis(cand, order, axis=1)
        act = lane[None, :] < jnp.minimum(cnt, f)[:, None]
        ov = ov | (cnt > f)
        return jnp.where(act, node, -1), act, ov

    init = (
        jnp.full((q, f), -1, jnp.int32).at[:, 0].set(0),
        jnp.zeros((q, f), bool).at[:, 0].set(True),
        jnp.zeros((q,), bool),
    )
    node, act, ov = jax.lax.fori_loop(0, depth + 1, body, init)
    return jnp.where(act, node, -1), jnp.sum(act, axis=1), ov


@functools.partial(jax.jit, static_argnames=("leaf_cap",))
def _rerank(
    leaf_start, leaf_count, vectors, orig_row, leaves, queries, radius,
    *, leaf_cap,
):
    """Expand leaf buckets to rows, compute exact distances, filter."""
    valid_leaf = leaves >= 0
    lv = jnp.where(valid_leaf, leaves, 0)
    lsc = jnp.stack([leaf_start, leaf_count], axis=1)[lv]  # [Q, L, 2]
    starts = lsc[..., 0]
    cnts = jnp.where(valid_leaf, lsc[..., 1], 0)
    k = jnp.arange(leaf_cap, dtype=jnp.int32)
    rows = starts[:, :, None] + k[None, None, :]  # [Q, L, K]
    rvalid = k[None, None, :] < cnts[:, :, None]
    rows = jnp.where(rvalid, rows, 0)
    q = queries.shape[0]
    rows = rows.reshape(q, -1)
    rvalid = rvalid.reshape(q, -1)

    cand = vectors[rows]  # [Q, C, D]
    diff = cand - queries[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    match = rvalid & (d2 <= radius * radius)
    cand_rows = jnp.where(rvalid, orig_row[rows], -1)
    out_rows = jnp.where(match, cand_rows, -1)
    d2 = jnp.where(match, d2, jnp.inf)
    return out_rows, d2, match, jnp.sum(rvalid, axis=1), cand_rows


def search(
    index: BSPIndex,
    queries,
    radius: float,
    *,
    max_leaves: Optional[int] = None,
    auto_grow: bool = True,
    traversal: str = "dfs",
) -> SearchResult:
    """Find all vectors within inclusive L2 ``radius`` of each query.

    Exact (no false negatives, no false positives): the traversal provably
    never prunes a subtree containing an in-radius point, and the rerank
    filters by true distance.

    Args:
      index: a built ``BSPIndex``.
      queries: ``[Q, D]`` (or ``[D]``) query vectors.
      radius: inclusive L2 match radius.
      max_leaves: per-query leaf-buffer width; defaults to a modest guess.
      auto_grow: if a query overflows the leaf buffer, re-run everything with
        a doubled buffer until complete (host-side retry loop).
      traversal: ``"dfs"`` (default) — per-query stack walk, one step
        per visited node; ``"bfs"`` — level-synchronous frontier
        expansion, one step per tree level. Identical results and
        overflow semantics. BFS runs far fewer sequential steps but pays
        a per-level sort compaction (the walk is gather-bound, not
        iteration-bound); DFS is the serving default (the two have not
        been timed against each other on the H100).
    """
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    radius = jnp.float32(radius)
    num_leaf_nodes = index.num_leaves
    if max_leaves is None:
        max_leaves = min(256, num_leaf_nodes)
    max_stack = index.depth + 2
    # auto-grow safety: the rerank gathers [Q, max_leaves*leaf_cap, D]
    # floats; cap that buffer at ~2 GB so a non-selective query (high-dim
    # + wide radius: the tree prunes nothing) degrades to a reported
    # overflow instead of an OOM. Callers wanting completeness beyond the
    # cap should use the scan paths.
    budget_rows = (2 << 30) // (4 * queries.shape[0] * index.d)
    grow_cap = max(
        min(num_leaf_nodes, budget_rows // max(index.leaf_cap, 1)), 1
    )
    max_leaves = min(max_leaves, grow_cap)

    while True:
        if traversal == "bfs":
            leaves, _, ov = _traverse_bfs(
                index.dim, index.mid, index.low, index.high, queries,
                radius, max_leaves=max_leaves, depth=index.depth,
            )
        else:
            leaves, _, ov = _traverse(
                index.dim, index.mid, index.low, index.high, queries,
                radius, max_leaves=max_leaves, max_stack=max_stack,
            )
        if auto_grow and bool(jnp.any(ov)) and max_leaves < grow_cap:
            max_leaves = min(max_leaves * 2, grow_cap)
            continue
        break

    rows, d2, match, ncand, cand_rows = _rerank(
        index.leaf_start, index.leaf_count, index.vectors, index.orig_row,
        leaves, queries, radius, leaf_cap=index.leaf_cap,
    )
    return SearchResult(
        rows=rows,
        sq_dists=d2,
        count=jnp.sum(match, axis=1).astype(jnp.int32),
        candidates=ncand.astype(jnp.int32),
        cand_rows=cand_rows,
        overflow=ov,
    )


@functools.partial(jax.jit, static_argnames=("depth", "ties_high"))
def _descend(dim, mid, low, high, queries, *, depth, ties_high=False):
    """Single-branch lockstep descent: each query follows ONE root→leaf
    path (``depth`` fixed iterations of [Q]-wide gathers — no stack, no
    frontier). Returns ``(leaf_node_id, saw_dual)`` per query; a set
    ``saw_dual`` flag means the path crossed a dim == -2 node, where the
    single-branch choice is a guess (see :func:`locate`). ``ties_high``
    mirrors the build's plane-tie routing (``BSPIndex.ties_high``):
    trie-exported trees route ``q[dim] == mid`` high, builder trees
    route it low here (their build-time rule is id-based either way)."""
    packed = jnp.stack(
        [dim, jax.lax.bitcast_convert_type(mid, jnp.int32), low, high],
        axis=1,
    )

    def body(_, st):
        node, saw_dual = st
        row = packed[node]  # [Q, 4]: one row gather per visit, not four
        d = row[:, 0]
        m = jax.lax.bitcast_convert_type(row[:, 1], jnp.float32)
        qd = jnp.take_along_axis(
            queries, jnp.maximum(d, 0)[:, None], axis=1
        )[:, 0]
        go_high = (qd >= m) if ties_high else (qd > m)
        nxt = jnp.where(go_high, row[:, 3], row[:, 2])
        # dual (dim == -2) nodes have NO separating plane (tie/degenerate
        # partitions: the chosen dim had zero variance, but rows may still
        # differ on OTHER dims) — a single-branch walk can only guess.
        # Take the low child and report the guess via ``saw_dual`` so the
        # caller can fall back to the exact dual-descent search.
        nxt = jnp.where(d == -2, row[:, 2], nxt)
        return jnp.where(d == -1, node, nxt), saw_dual | (d == -2)

    q = queries.shape[0]
    return jax.lax.fori_loop(
        0, depth + 1, body,
        (jnp.zeros((q,), jnp.int32), jnp.zeros((q,), bool)),
    )


@functools.partial(jax.jit, static_argnames=("leaf_cap",))
def _locate_in_leaf(
    leaf_start, leaf_count, vectors, orig_row, leaf, queries, *, leaf_cap
):
    lsc = jnp.stack([leaf_start, leaf_count], axis=1)[leaf]  # [Q, 2]
    start = lsc[:, 0]
    cnt = lsc[:, 1]
    k = jnp.arange(leaf_cap, dtype=jnp.int32)
    rows = start[:, None] + k[None, :]  # [Q, K]
    valid = k[None, :] < cnt[:, None]
    rows = jnp.where(valid, rows, 0)
    eq = jnp.all(vectors[rows] == queries[:, None, :], axis=-1) & valid
    first = jnp.argmax(eq, axis=1)
    hit = jnp.take_along_axis(eq, first[:, None], axis=1)[:, 0]
    found = jnp.take_along_axis(rows, first[:, None], axis=1)[:, 0]
    return jnp.where(hit, orig_row[found], -1)


def locate(index: BSPIndex, queries) -> jax.Array:
    """Exact-match point lookup: the original row whose vector EQUALS each
    query, or -1 — by single-branch descent (one root→leaf path per query,
    ``depth`` lockstep steps) plus an equality check in the reached leaf.

    This is the ``radius=0`` fast path: the DFS of :func:`search` visits
    every leaf an ε-ball touches; a point query needs only the one leaf the
    build itself would route the vector to. Dual (dim == -2) nodes — tie or
    zero-variance partitions with no separating plane — are handled by
    fallback: a query whose single-branch path crossed one and missed is
    re-run through the exact dual-descent ``search(q, 0.0)`` (under
    ``split="max"`` trees no dual node exists while any dimension still
    discriminates, so the fast path alone is exact — the boolean/KB mode).
    The remaining inexactness (builder trees only) is a query coordinate
    exactly ON a traversed split plane (``q[dim] == mid`` ties route by id
    at build time, which a query cannot reproduce — impossible for ±1
    boolean encodings, where split planes are strict means; for such
    tie-prone float data use ``search(q, 0.0)``). Trie exports
    (``MemoryVectorIndex.to_bsp``) set ``ties_high`` and their
    deterministic v >= center routing IS reproduced — locate is exact on
    those trees. This is the reference KB game's identification
    endgame, one branch per level (reference README.md:8-15,
    MemoryVectorIndex.cs:114-161's descent).

    Returns: ``[Q]`` int32 original row ids, -1 where absent.
    """
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    leaf, saw_dual = _descend(
        index.dim, index.mid, index.low, index.high, queries,
        depth=index.depth, ties_high=getattr(index, "ties_high", False),
    )
    rows = _locate_in_leaf(
        index.leaf_start, index.leaf_count, index.vectors, index.orig_row,
        leaf, queries, leaf_cap=index.leaf_cap,
    )
    # A miss below a dual node is inconclusive: the matching row may live
    # in the branch the guess didn't take. Exact fallback for those only.
    miss = np.asarray(saw_dual) & (np.asarray(rows) < 0)
    if miss.any():
        rows = np.array(rows)  # writable host copy
        idxs = np.nonzero(miss)[0]
        res = search(index, queries[idxs], 0.0)
        sub = np.asarray(res.rows)
        for j in range(idxs.size):
            hits = sub[j][sub[j] >= 0]
            if hits.size:
                rows[idxs[j]] = hits[0]
        return jnp.asarray(rows)
    return rows


def calibrate_radius(
    vectors,
    sample_queries,
    k: int,
    quantile: float = 0.95,
    *,
    max_sample: int = 65536,
) -> float:
    """Pick an ε for radius-bounded k-NN: the ``quantile`` of the k-th
    neighbor distance over a query sample (computed exactly on the device).
    Searching with this radius yields ≥ ~quantile expected recall@k.

    The database side is subsampled to ``max_sample`` rows (strided, so the
    scan stays cheap even at 10M rows); sampling can only *overestimate*
    the k-th neighbor distance, which trades extra candidates for recall —
    never the other way."""
    from vector_database_tpu.ops.exact import exact_knn

    n = vectors.shape[0]
    if n > max_sample:
        stride = -(-n // max_sample)
        vectors = vectors[::stride]
    _, d2 = exact_knn(vectors, sample_queries, k=min(k, vectors.shape[0]))
    kth = jnp.sqrt(d2[:, -1])
    return float(jnp.quantile(kth, quantile))


def knn(
    index: BSPIndex,
    queries,
    k: int,
    radius: Optional[float] = None,
    *,
    max_leaves: Optional[int] = None,
    row_filter=None,
):
    """k nearest neighbors among vectors within ``radius`` of each query.

    Returns ``(rows [Q, k], sq_dists [Q, k])`` with -1 / +inf padding when a
    query has fewer than ``k`` in-radius neighbors. ``radius`` bounds the
    candidate generation (the ANN knob: larger radius = higher recall,
    more candidates); ``radius=None`` auto-calibrates it from the k-th
    neighbor distances of a query sample (95th percentile + 10% margin).

    ``row_filter``: optional ``[N]`` bool over ORIGINAL row ids — rows
    where False are excluded (filtered k-NN; the batched form of the
    reference's caller predicate, MemoryVectorIndex.cs:237-241). Exact
    within the radius: filtering happens before the top-k, on the
    geometric candidate superset. Note the auto-calibrated radius
    ignores the filter — pass ``radius`` explicitly for highly selective
    filters (the k-th allowed neighbor sits farther than the k-th
    overall), or use ``scan_knn(row_mask=...)`` for radius-free exact
    filtered k-NN.
    """
    if radius is None:
        queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
        radius = 1.1 * calibrate_radius(
            index.vectors, queries[: min(64, queries.shape[0])], k, 0.95
        )
    res = search(index, queries, radius, max_leaves=max_leaves)
    sq = res.sq_dists
    if row_filter is not None:
        rf = jnp.asarray(row_filter, bool)
        allowed = rf[jnp.clip(res.rows, 0, rf.shape[0] - 1)] & (
            res.rows >= 0
        )
        sq = jnp.where(allowed, sq, jnp.inf)
    kk = min(k, sq.shape[1])  # candidate width can be < k
    neg, pos = jax.lax.top_k(-sq, kk)
    rows = jnp.take_along_axis(res.rows, pos, axis=1)
    d2 = -neg
    rows = jnp.where(jnp.isfinite(d2), rows, -1)
    if k > kk:  # honor the documented [Q, k] -1/+inf padding contract
        rows = jnp.pad(rows, ((0, 0), (0, k - kk)), constant_values=-1)
        d2 = jnp.pad(
            d2, ((0, 0), (0, k - kk)), constant_values=jnp.inf
        )
    # overflow check AFTER dispatching the top-k: the scalar transfer
    # overlaps the merge instead of serializing it
    if bool(jnp.any(res.overflow)):
        import warnings

        warnings.warn(
            "knn: the leaf buffer overflowed at its growth cap for "
            f"{int(jnp.sum(res.overflow))} queries; their candidate sets "
            "are truncated (results may miss neighbors). Use scan_knn / "
            "pallas_scan_knn for non-selective high-dimensional queries.",
            RuntimeWarning,
            stacklevel=2,
        )
    return rows, d2
