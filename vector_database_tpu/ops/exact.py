"""Exact brute-force search — the recall oracle and the QPS floor.

The reference tests validate every index against a brute-force linear scan
(MempryVectorIndex.Tests/MemoryVectorIndexTests.cs:161-163). On an
accelerator the "linear scan" is a matmul and is itself a very fast
baseline: for normalized/angular data, ``Q·N·D`` FLOPs ride the tensor
cores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def pairwise_sq_dists(queries: jax.Array, vectors: jax.Array) -> jax.Array:
    """Squared L2 distances ``[Q, N]`` via the matmul expansion.

    ``|q - v|^2 = |q|^2 + |v|^2 - 2 q.v`` — one big matmul instead of a
    memory-bound broadcast-subtract.

    Precision note: a *default*-precision f32 matmul may run in reduced
    precision (TF32 on a GPU, one bf16 pass elsewhere — errors large
    enough to scramble neighbor ranks inside tight clusters). This is the
    exactness ORACLE, so it pins ``Precision.HIGHEST`` (true f32).
    """
    qn = jnp.sum(queries * queries, axis=1, keepdims=True)
    vn = jnp.sum(vectors * vectors, axis=1)
    cross = jnp.dot(
        queries, vectors.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.maximum(qn + vn[None, :] - 2.0 * cross, 0.0)


@jax.jit
def exact_sq_dists(queries: jax.Array, vectors: jax.Array) -> jax.Array:
    """Squared L2 distances ``[Q, N]`` via direct subtraction.

    Numerically identical to the rerank path of the tree search (same
    operation shape), so oracle-vs-index comparisons do not disagree on
    boundary points. O(Q·N·D) memory traffic — use only for tests.
    """
    diff = queries[:, None, :] - vectors[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def exact_ball(vectors, queries, radius, *, use_matmul: bool = False):
    """Boolean match matrix ``[Q, N]``: within inclusive L2 ``radius``."""
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    vectors = jnp.asarray(vectors, jnp.float32)
    d2 = (pairwise_sq_dists if use_matmul else exact_sq_dists)(queries, vectors)
    return d2 <= jnp.float32(radius) * jnp.float32(radius)


def exact_knn(vectors, queries, *, k: int, block: int | None = None):
    """Exact k nearest neighbors: ``(indices [Q, k], sq_dists [Q, k])``.

    Above ``block`` rows the distance matrix is streamed in ``[Q, block]``
    tiles under one ``lax.scan`` with a running top-k merge — the full
    ``[Q, N]`` matrix at 10M x 1024 queries is 40 GB and cannot
    materialize in device memory; the streamed form peaks at the tile. Identical
    results (exact f32 distances, HIGHEST-precision contraction).

    ``block=None`` scales the tile with the batch: the f32 ``[Q, block]``
    tile is capped at ~2 GiB (a [4096, 1M] tile would be 15 GB).
    """
    if block is None:
        q_rows = int(jnp.shape(queries)[0]) or 1
        block = max(65_536, min(1_000_000, (1 << 29) // q_rows))
    return _exact_knn_impl(vectors, queries, k=k, block=block)


@functools.partial(jax.jit, static_argnames=("k", "block"))
def _exact_knn_impl(vectors, queries, *, k: int, block: int):
    queries = jnp.asarray(queries, jnp.float32)
    vectors = jnp.asarray(vectors, jnp.float32)
    n = vectors.shape[0]
    if n <= block:
        d2 = pairwise_sq_dists(queries, vectors)
        neg, idx = jax.lax.top_k(-d2, min(k, n))
        if k > n:  # pad to the [Q, k] contract like the streamed path
            idx = jnp.pad(idx, ((0, 0), (0, k - n)), constant_values=-1)
            neg = jnp.pad(
                neg, ((0, 0), (0, k - n)), constant_values=-jnp.inf
            )
        return idx, -neg

    q, d = queries.shape
    nb = -(-n // block)
    vp = jnp.pad(vectors, ((0, nb * block - n), (0, 0)))
    blocks = vp.reshape(nb, block, d)
    bases = jnp.arange(nb, dtype=jnp.int32) * block
    lane = jnp.arange(block, dtype=jnp.int32)
    kk = min(k, n)

    def body(carry, inp):
        cd, ci = carry
        vb, base = inp
        d2 = pairwise_sq_dists(queries, vb)
        d2 = jnp.where((base + lane < n)[None, :], d2, jnp.inf)
        bneg, bpos = jax.lax.top_k(-d2, min(kk, block))
        cat_d = jnp.concatenate([cd, -bneg], axis=1)
        cat_i = jnp.concatenate([ci, base + bpos], axis=1)
        neg, pos = jax.lax.top_k(-cat_d, kk)
        return (
            -neg, jnp.take_along_axis(cat_i, pos, axis=1)
        ), None

    init = (
        jnp.full((q, kk), jnp.inf, jnp.float32),
        jnp.full((q, kk), -1, jnp.int32),
    )
    (cd, ci), _ = jax.lax.scan(body, init, (blocks, bases))
    if kk < k:
        ci = jnp.pad(ci, ((0, 0), (0, k - kk)), constant_values=-1)
        cd = jnp.pad(cd, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
    return ci, cd


@functools.partial(jax.jit, static_argnames=("k",))
def exact_mips(vectors, queries, *, k: int):
    """Exact maximum-inner-product search: ``(indices [Q, k],
    dots [Q, k])``, highest dot first (the oracle for ``metric="ip"``).
    ``k > n`` pads with -1 / -inf (the same contract as ``exact_knn``)."""
    dots = jnp.dot(
        jnp.asarray(queries, jnp.float32),
        jnp.asarray(vectors, jnp.float32).T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    kk = min(k, dots.shape[1])
    best, idx = jax.lax.top_k(dots, kk)
    if kk < k:
        idx = jnp.pad(idx, ((0, 0), (0, k - kk)), constant_values=-1)
        best = jnp.pad(
            best, ((0, 0), (0, k - kk)), constant_values=-jnp.inf
        )
    return idx, best


@jax.jit
def normalize_rows(vectors: jax.Array) -> jax.Array:
    """Unit-normalize rows (zero rows stay zero) — cosine/angular metrics
    reduce to L2 over normalized vectors: ``cos = 1 - d2/2``."""
    vectors = jnp.asarray(vectors, jnp.float32)
    norm = jnp.sqrt(jnp.sum(vectors * vectors, axis=1, keepdims=True))
    return vectors / jnp.maximum(norm, 1e-30)
