"""Sharded packed-scan serving: oracle exactness + jit-cache discipline.

The multi-device QPS multiplier (parallel/scan.py): every shard runs the
single-device serving program (the plain XLA scan here) over its rows,
results merge with one all-gather top-k. Must match the brute-force oracle
on data without bucket collisions, and must not retrace per call.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vector_database_tpu import exact_knn
from vector_database_tpu.parallel import (
    make_mesh,
    pack_database_sharded,
    sharded_scan_knn,
)
from vector_database_tpu.utils import datasets


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_matches_oracle(mesh):
    vecs = np.asarray(datasets.random_uniform(3000, 16, seed=60))
    queries = np.asarray(datasets.random_uniform(32, 16, seed=61))
    db = pack_database_sharded(vecs, mesh, block=128, buckets=128)
    rows, d2 = sharded_scan_knn(db, queries, k=5, q_tile=8)
    erows, ed2 = exact_knn(vecs, queries, k=5)
    # exact distances for whatever was found; full recall over the batch
    hits = 0
    for qi in range(queries.shape[0]):
        got = set(np.asarray(rows)[qi].tolist())
        want = set(np.asarray(erows)[qi].tolist())
        hits += len(got & want)
    assert hits >= 0.97 * queries.shape[0] * 5  # bucketed selection
    np.testing.assert_allclose(
        np.sort(np.asarray(d2), axis=1)[:, 0],
        np.sort(np.asarray(ed2), axis=1)[:, 0],
        rtol=1e-5,
    )


def test_unaligned_rows_and_global_ids(mesh):
    # n deliberately not divisible by shards or block: pad rows must
    # never appear, ids must be global
    vecs = np.asarray(datasets.random_uniform(1037, 8, seed=62))
    queries = vecs[[3, 500, 1036]]
    db = pack_database_sharded(vecs, mesh, block=64, buckets=64)
    rows, d2 = sharded_scan_knn(db, queries, k=1, q_tile=8)
    assert np.asarray(rows)[:, 0].tolist() == [3, 500, 1036]
    assert np.allclose(np.asarray(d2)[:, 0], 0.0, atol=1e-5)
    assert (np.asarray(rows) >= -1).all() and (np.asarray(rows) < 1037).all()


def test_matches_single_chip_path(mesh):
    """The sharded result equals the single-chip packed scan's on the
    same database (same bucket geometry per shard scale)."""
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    vecs = np.asarray(datasets.random_uniform(2048, 8, seed=63))
    queries = np.asarray(datasets.random_uniform(16, 8, seed=64))
    db = pack_database_sharded(vecs, mesh, block=256, buckets=256)
    rows, d2 = sharded_scan_knn(db, queries, k=3, q_tile=8)
    pack = pack_database(vecs, block=2048, buckets=2048)
    srows, sd2 = pallas_scan_knn_packed(pack, queries, k=3, q_tile=8)
    np.testing.assert_allclose(
        np.asarray(d2), np.asarray(sd2), rtol=1e-5, atol=1e-6
    )


def test_cosine_and_ip_metrics(mesh):
    vecs = np.asarray(datasets.random_uniform(512, 8, seed=65)) + 0.1
    queries = np.asarray(datasets.random_uniform(8, 8, seed=66))
    dbc = pack_database_sharded(
        vecs, mesh, block=64, buckets=64, metric="cosine"
    )
    rows, _ = sharded_scan_knn(dbc, queries, k=3, q_tile=8)
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cos = qn @ vn.T
    want = np.argsort(-cos, axis=1)[:, :1]
    assert (np.asarray(rows)[:, :1] == want).all()

    dbi = pack_database_sharded(
        vecs, mesh, block=64, buckets=64, metric="ip"
    )
    irows, dots = sharded_scan_knn(dbi, queries, k=3, q_tile=8)
    ips = queries @ vecs.T
    np.testing.assert_allclose(
        np.asarray(dots)[:, 0], ips.max(axis=1), rtol=1e-5
    )
    assert (np.asarray(irows)[:, 0] == np.argmax(ips, axis=1)).all()


def test_no_per_call_retrace(mesh):
    from vector_database_tpu.parallel.scan import _sharded_serve_fn

    vecs = np.asarray(datasets.random_uniform(600, 8, seed=67))
    queries = np.asarray(datasets.random_uniform(8, 8, seed=68))
    db = pack_database_sharded(vecs, mesh, block=64, buckets=64)
    _sharded_serve_fn.cache_clear()
    sharded_scan_knn(db, queries, k=3, q_tile=8)
    fn = _sharded_serve_fn(
        db.mesh, db.axis, db.n_loc, db.block, db.m, db.bits, db.metric,
        3, 8, None, False, None, None,
    )
    assert fn._cache_size() == 1
    sharded_scan_knn(db, queries + 0.5, k=3, q_tile=8)
    assert _sharded_serve_fn.cache_info().currsize == 1
    assert fn._cache_size() == 1


def test_orig_rows_mapping(mesh):
    """Serving a leaf-major matrix with a BSPIndex's orig_row mapping
    returns original input rows."""
    from vector_database_tpu import build_index_fused

    vecs = np.asarray(datasets.random_uniform(700, 8, seed=69))
    index = build_index_fused(vecs, leaf_size=8)
    db = pack_database_sharded(
        np.asarray(index.vectors), mesh, block=64, buckets=64,
        orig_rows=np.asarray(index.orig_row),
    )
    queries = vecs[[1, 699, 123]]
    rows, d2 = sharded_scan_knn(db, queries, k=1, q_tile=8)
    assert np.asarray(rows)[:, 0].tolist() == [1, 699, 123]


def test_device_array_input(mesh):
    """pack_database_sharded's device fast path (no host round-trip):
    a jnp input produces the same serving results as the host path."""
    import jax.numpy as jnp

    vecs = np.asarray(datasets.random_uniform(900, 8, seed=70))
    queries = vecs[[7, 899]]
    db_h = pack_database_sharded(vecs, mesh, block=64, buckets=64)
    db_d = pack_database_sharded(
        jnp.asarray(vecs), mesh, block=64, buckets=64
    )
    rh, dh = sharded_scan_knn(db_h, queries, k=3, q_tile=8)
    rd, dd = sharded_scan_knn(db_d, queries, k=3, q_tile=8)
    np.testing.assert_array_equal(np.asarray(rh), np.asarray(rd))
    np.testing.assert_allclose(np.asarray(dh), np.asarray(dd), rtol=1e-6)
    # cosine via the device path too
    dc = pack_database_sharded(
        jnp.asarray(vecs + 0.2), mesh, block=64, buckets=64,
        metric="cosine",
    )
    rows, _ = sharded_scan_knn(dc, queries, k=1, q_tile=8)
    assert rows.shape == (2, 1)


def test_donated_device_input(mesh):
    """donate=True frees the caller's device buffer (HBM headroom for
    the 10M harness) while producing identical serving results."""
    import jax
    import jax.numpy as jnp

    vecs = np.asarray(datasets.random_uniform(900, 8, seed=71))
    queries = vecs[[7, 899]]
    db_h = pack_database_sharded(vecs, mesh, block=64, buckets=64)
    dev = jnp.asarray(vecs)
    db_d = pack_database_sharded(
        dev, mesh, block=64, buckets=64, donate=True
    )
    rh, dh = sharded_scan_knn(db_h, queries, k=3, q_tile=8)
    rd, dd = sharded_scan_knn(db_d, queries, k=3, q_tile=8)
    np.testing.assert_array_equal(np.asarray(rh), np.asarray(rd))
    np.testing.assert_allclose(np.asarray(dh), np.asarray(dd), rtol=1e-6)
    assert dev.is_deleted()


def test_ip_ragged_shards(mesh):
    """metric="ip" with a row count that leaves +inf pad rows on the
    last shard: sentinel rows must not win the rerank (regression:
    their -inf/NaN keys displaced every real top-k entry)."""
    rng = np.random.RandomState(83)
    vecs = rng.rand(100, 8).astype(np.float32) * 2 - 1
    # plant the highest-dot rows in the padded final shard
    vecs[95:] *= 50.0
    db = pack_database_sharded(
        vecs, mesh, block=32, buckets=32, metric="ip"
    )
    q = rng.rand(4, 8).astype(np.float32) * 2 - 1
    rows, dots = sharded_scan_knn(db, q, k=5, q_tile=8, oversample=32)
    rows, dots = np.asarray(rows), np.asarray(dots)
    truth = q @ vecs.T
    for i in range(4):
        assert (rows[i] >= 0).all()
        assert set(rows[i].tolist()) == set(
            np.argsort(-truth[i])[:5].tolist()
        )
        np.testing.assert_allclose(
            dots[i], np.sort(truth[i])[::-1][:5], rtol=1e-3, atol=1e-4
        )


def test_pack_sharded_empty_raises():
    import pytest

    from vector_database_tpu.parallel import make_mesh

    with pytest.raises(ValueError, match="empty"):
        pack_database_sharded(np.zeros((0, 8), np.float32), make_mesh())


def test_sharded_probes_full_coverage(mesh):
    """probes = per-shard block count reproduces the unpruned sharded
    scan exactly; a fraction keeps recall close (clustered data)."""
    rng = np.random.RandomState(91)
    centers = rng.rand(32, 8).astype(np.float32) * 2 - 1
    assign = np.sort(rng.randint(0, 32, size=6000))  # leaf-major stand-in
    vecs = (
        centers[assign] + 0.05 * rng.randn(6000, 8)
    ).astype(np.float32)
    queries = (
        centers[rng.randint(0, 32, size=64)]
        + 0.05 * rng.randn(64, 8)
    ).astype(np.float32)
    db = pack_database_sharded(vecs, mesh, block=64, buckets=64)
    nb_loc = db.vb.shape[1]
    r0, d0 = sharded_scan_knn(db, queries, k=5, q_tile=8)
    r1, d1 = sharded_scan_knn(db, queries, k=5, q_tile=8, probes=nb_loc)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1))
    rp, _ = sharded_scan_knn(
        db, queries, k=5, q_tile=8, probes=max(1, nb_loc // 2)
    )
    hits = sum(
        len(set(np.asarray(rp)[i].tolist())
            & set(np.asarray(r0)[i].tolist()))
        for i in range(64)
    )
    assert hits >= 0.7 * 64 * 5


def _clustered(n, seed, n_centers=32, d=8):
    rng = np.random.RandomState(seed)
    centers = rng.rand(n_centers, d).astype(np.float32) * 2 - 1
    assign = np.sort(rng.randint(0, n_centers, size=n))
    vecs = (centers[assign] + 0.05 * rng.randn(n, d)).astype(np.float32)
    queries = (
        centers[rng.randint(0, n_centers, size=64)]
        + 0.05 * rng.randn(64, d)
    ).astype(np.float32)
    return vecs, queries


def test_sharded_runtime_probes_bitwise_equals_static(mesh):
    """The sharded runtime-probes program (probes_max=): every probes
    value in [1, probes_max] must be BITWISE-equal to the static-probes
    sharded call, through ONE compiled program."""
    from vector_database_tpu.parallel.scan import _sharded_serve_fn

    vecs, queries = _clustered(6000, seed=95)
    db = pack_database_sharded(vecs, mesh, block=64, buckets=64)
    nb_loc = db.vb.shape[1]
    _sharded_serve_fn.cache_clear()
    for p in (1, 2, max(1, nb_loc // 2), nb_loc):
        r_st, d_st = sharded_scan_knn(db, queries, k=5, q_tile=8, probes=p)
        r_rt, d_rt = sharded_scan_knn(
            db, queries, k=5, q_tile=8, probes=p, probes_max=nb_loc
        )
        np.testing.assert_array_equal(np.asarray(r_st), np.asarray(r_rt))
        np.testing.assert_array_equal(np.asarray(d_st), np.asarray(d_rt))
    # one rt program served every value; the static side traced per value
    fn_rt = _sharded_serve_fn(
        db.mesh, db.axis, db.n_loc, db.block, db.m, db.bits, db.metric,
        5, 8, None, False, None, nb_loc,
    )
    assert fn_rt._cache_size() == 1
    # probes beyond probes_max clips to the cap rather than erroring
    r_hi, _ = sharded_scan_knn(
        db, queries, k=5, q_tile=8, probes=nb_loc + 100, probes_max=nb_loc
    )
    np.testing.assert_array_equal(np.asarray(r_hi), np.asarray(r_rt))
    import pytest

    with pytest.raises(ValueError, match="probes_max requires"):
        sharded_scan_knn(db, queries, k=5, q_tile=8, probes_max=nb_loc)


def test_calibrate_probes_sharded(mesh):
    """The mesh twin of calibrate_probes: returns the smallest per-shard
    probes meeting the target recall, and every candidate evaluation
    rides ONE runtime-probes program + ONE full-scan program."""
    from vector_database_tpu.parallel.scan import (
        _sharded_serve_fn,
        calibrate_probes_sharded,
    )

    vecs, queries = _clustered(6000, seed=97)
    db = pack_database_sharded(vecs, mesh, block=64, buckets=64)
    nb_loc = db.vb.shape[1]
    _sharded_serve_fn.cache_clear()
    p = calibrate_probes_sharded(db, queries, k=5, target_recall=0.9)
    assert 1 <= p <= nb_loc
    # the result actually meets the target (static serve at p)
    full, _ = sharded_scan_knn(db, queries, k=5, q_tile=256)
    got, _ = sharded_scan_knn(db, queries, k=5, q_tile=256, probes=p)
    hits = sum(
        len(set(np.asarray(got)[i].tolist())
            & (set(np.asarray(full)[i].tolist()) - {-1}))
        for i in range(64)
    )
    assert hits >= 0.9 * sum(
        len(set(np.asarray(full)[i].tolist()) - {-1}) for i in range(64)
    )
    # p-1 (if any) fails the target — p is minimal
    if p > 1:
        below, _ = sharded_scan_knn(
            db, queries, k=5, q_tile=256, probes=p - 1
        )
        bhits = sum(
            len(set(np.asarray(below)[i].tolist())
                & (set(np.asarray(full)[i].tolist()) - {-1}))
            for i in range(64)
        )
        assert bhits < hits
    # compile discipline: ONE rt program + the full scan (plus this
    # test's own static serves) — the calibrate itself added exactly 2
    rt_fn = _sharded_serve_fn(
        db.mesh, db.axis, db.n_loc, db.block, db.m, db.bits, db.metric,
        5, 256, None, False, None, nb_loc,
    )
    assert rt_fn._cache_size() == 1
