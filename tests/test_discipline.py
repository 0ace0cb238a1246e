"""jit-purity, donation, and numeric-discipline checks (SURVEY.md §5).

The reference's "race detection" story is documented single-threadedness
plus ``checked`` arithmetic (MemoryRangeStore.cs:5, IndexBuilder.cs:99-104).
The equivalents asserted here:

- **no tracer leaks**: the builders and search paths are pure under jit
  (``jax.checking_leaks``);
- **no recompile churn**: repeated same-shape calls hit the jit cache
  exactly once — compile-per-call is this engine's analogue of a
  pathological lock;
- **donation discipline**: ``donate=True`` actually releases the input
  buffer (the builder's in-place permutation claim is real, not aliased);
- **no NaNs**: the whole build+search pipeline is NaN-free under
  ``jax.debug_nans`` (inf pads are fine and excluded by the flag);
- **no out-of-bounds gathers**: the clip-then-mask gather pattern used by
  the rerank paths passes ``checkify`` index checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import checkify

from vector_database_tpu import build_index_fused, exact_knn
from vector_database_tpu.ops.scan_knn import scan_knn
from vector_database_tpu.search import knn, search
from vector_database_tpu.utils import datasets


@pytest.fixture(scope="module")
def small():
    vecs = datasets.random_uniform(512, 8, seed=41)
    queries = datasets.random_uniform(16, 8, seed=42)
    return np.asarray(vecs), np.asarray(queries)


def test_no_tracer_leaks(small):
    vecs, queries = small
    with jax.checking_leaks():
        index = build_index_fused(vecs, leaf_size=4)
        res = search(index, queries, 0.5)
        res.rows.block_until_ready()


def test_no_recompile_churn(small):
    """Same-shape calls must not retrace: one cache entry per shape."""
    vecs, queries = small

    @jax.jit
    def serve(v, q):
        return scan_knn(v, q, k=5)

    serve(jnp.asarray(vecs), jnp.asarray(queries))
    serve(jnp.asarray(vecs * 0.5), jnp.asarray(queries + 1.0))
    assert serve._cache_size() == 1


def test_donation_releases_input(small):
    vecs, _ = small
    buf = jnp.asarray(vecs)
    build_index_fused(buf, leaf_size=4, donate=True)
    assert buf.is_deleted()


def test_donated_build_matches_undonated(small):
    vecs, queries = small
    a = build_index_fused(vecs, leaf_size=4)
    b = build_index_fused(jnp.asarray(vecs), leaf_size=4, donate=True)
    np.testing.assert_array_equal(np.asarray(a.dim), np.asarray(b.dim))
    np.testing.assert_array_equal(
        np.asarray(a.orig_row), np.asarray(b.orig_row)
    )


def test_pipeline_nan_free(small):
    vecs, queries = small
    with jax.debug_nans(True):
        index = build_index_fused(vecs, leaf_size=4)
        rows, d2 = knn(index, queries, k=5, radius=1.0)
        jnp.asarray(d2).block_until_ready()
        erows, ed2 = exact_knn(vecs, queries, k=5)
        ed2.block_until_ready()


def test_rerank_gathers_in_bounds(small):
    """checkify index checks over the scan+rerank path: the clip-then-mask
    gather contract holds (no reliance on XLA's silent clamping)."""
    vecs, queries = small

    def f(v, q):
        return scan_knn(v, q, k=5)

    checked = checkify.checkify(
        jax.jit(f), errors=checkify.index_checks
    )
    err, (rows, d2) = checked(jnp.asarray(vecs), jnp.asarray(queries))
    err.throw()  # no-op unless a gather went out of bounds
    eidx, _ = exact_knn(vecs, queries, k=5)
    assert set(np.asarray(rows)[0].tolist()) == set(
        np.asarray(eidx)[0].tolist()
    )


def test_parallel_serving_cache_reuse():
    """The mesh serving paths must not retrace
    per call. Second same-shape call hits the jit cache for forest_knn,
    knn_global, and search_global (radius is an argument, not a capture)."""
    from vector_database_tpu.parallel import (
        build_index_sharded,
        knn_global,
        make_mesh,
        search_global,
    )
    from vector_database_tpu.parallel.forest import (
        _forest_local_fn,
        build_forest,
        forest_knn,
        merge_topk,
    )
    from vector_database_tpu.parallel.global_tree import _shard_search_fn

    mesh = make_mesh(8)
    vecs = np.asarray(datasets.random_uniform(320, 6, seed=50))
    qs = np.asarray(datasets.random_uniform(8, 6, seed=51))

    forest = build_forest(vecs, mesh, leaf_size=4)
    _forest_local_fn.cache_clear()
    merge_before = merge_topk._cache_size()
    forest_knn(forest, qs, k=3, radius=1.0)
    inner = _forest_local_fn(
        mesh, forest.axis, 3, 256, forest.depth + 2, forest.leaf_cap
    )
    assert inner._cache_size() == 1
    # same shapes, different radius and data: nothing may retrace
    forest_knn(forest, qs + 0.125, k=3, radius=0.75)
    assert _forest_local_fn.cache_info().currsize == 1
    assert inner._cache_size() == 1
    assert merge_topk._cache_size() == merge_before + 1

    sh = build_index_sharded(vecs, mesh, leaf_size=4)
    _shard_search_fn.cache_clear()
    knn_global(sh, qs, k=3, radius=1.0)
    sfn = _shard_search_fn(
        mesh, sh.axis, min(256, max(sh.num_leaves, 1)), sh.depth + 2,
        max(sh.leaf_cap, 1),
    )
    assert sfn._cache_size() == 1
    knn_global(sh, qs + 0.25, k=3, radius=0.5)
    search_global(sh, qs, 0.5)
    search_global(sh, qs + 0.5, 0.25)
    assert _shard_search_fn.cache_info().currsize == 1
    assert sfn._cache_size() == 1
