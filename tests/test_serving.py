"""PackedServer: stable-shape serving — one compiled program for any
caller batch size, results equal to the underlying engine + oracle."""

import numpy as np

from vector_database_tpu import PackedServer, exact_knn
from vector_database_tpu.ops.pallas_knn import (
    pack_database,
    pallas_scan_knn_packed,
)
from vector_database_tpu.utils import datasets


def make(n=3000, d=12, seed=170, **kw):
    vecs = np.asarray(datasets.random_uniform(n, d, seed=seed))
    srv = PackedServer.from_vectors(vecs, k=5, batch=64, **kw)
    return srv, vecs


def test_matches_engine_and_oracle():
    srv, vecs = make()
    queries = np.asarray(datasets.random_uniform(32, 12, seed=171))
    rows, d2 = srv.query(queries)
    erows, ed2 = exact_knn(vecs, queries, k=5)
    same = sum(
        set(rows[i].tolist()) == set(np.asarray(erows)[i].tolist())
        for i in range(32)
    )
    assert same >= 31  # bucketed scan recall on random data
    np.testing.assert_allclose(
        np.sort(d2, 1), np.sort(np.asarray(ed2), 1), rtol=1e-3, atol=1e-5
    )


def test_ragged_batches_one_compiled_shape():
    """Every caller batch size must flow through the SAME padded shape:
    identical results for a query regardless of the batch it rode in,
    and the padded shape equals the configured batch."""
    srv, vecs = make()
    q = np.asarray(datasets.random_uniform(150, 12, seed=172))
    # one call of 150 = 64 + 64 + 22(padded): waves concatenate cleanly
    rows_all, d_all = srv.query(q)
    assert rows_all.shape == (150, 5)
    # same queries one at a time -> identical answers (shape-invariant)
    rows_one, d_one = srv.query(q[7])
    assert rows_one.shape == (1, 5)
    assert rows_one[0].tolist() == rows_all[7].tolist()
    np.testing.assert_array_equal(d_one[0], d_all[7])


def test_no_retrace_across_batch_sizes():
    """The underlying jitted kernel must see exactly ONE query shape no
    matter what batch sizes callers send."""
    srv, _ = make(d=10, seed=176)  # shape unique to this test
    base = pallas_scan_knn_packed._cache_size()
    for qn in (1, 3, 64, 65, 129):
        srv.query(np.zeros((qn, 10), np.float32))
    assert pallas_scan_knn_packed._cache_size() == base + 1


def test_empty_batch():
    srv, _ = make()
    rows, d2 = srv.query(np.zeros((0, 12), np.float32))
    assert rows.shape == (0, 5) and d2.shape == (0, 5)


def test_default_q_tile_never_exceeds_batch():
    """A q_tile above the batch would pad every wave up (up to 32x the
    scan work); the default must track the configured batch, rounded up
    to the GPU kernel's 16-query tile."""
    srv, _ = make()  # batch=64
    assert srv._q_tile == 64
    srv2, _ = make(seed=177)
    assert PackedServer(srv2._pack, k=5, batch=3)._q_tile == 16
    assert PackedServer(srv2._pack, k=5, batch=40)._q_tile == 48
    assert PackedServer(srv2._pack, k=5, batch=2048)._q_tile == 512


def test_sharded_server_matches_single_chip():
    import jax
    from vector_database_tpu.parallel import make_mesh
    from vector_database_tpu.parallel.scan import pack_database_sharded

    vecs = np.asarray(datasets.random_uniform(2048, 8, seed=173))
    mesh = make_mesh()
    assert len(jax.devices()) >= 2  # conftest provides 8 virtual devices
    sdb = pack_database_sharded(vecs, mesh)
    srv = PackedServer(sdb, k=4, batch=32)
    srv.warmup()
    queries = np.asarray(datasets.random_uniform(50, 8, seed=174))
    rows, d2 = srv.query(queries)
    single = PackedServer(pack_database(vecs), k=4, batch=32)
    srows, sd2 = single.query(queries)
    for i in range(50):
        assert set(rows[i].tolist()) == set(srows[i].tolist())
    np.testing.assert_allclose(np.sort(d2, 1), np.sort(sd2, 1), rtol=1e-5)


def test_ip_metric_scores_are_dots():
    vecs = np.asarray(datasets.random_uniform(500, 6, seed=175))
    srv = PackedServer.from_vectors(vecs, k=3, batch=16, metric="ip")
    q = vecs[[11]]
    rows, dots = srv.query(q)
    assert rows[0, 0] >= 0
    # highest dot first, and it is the true dot
    want = float(np.max(vecs @ q[0]))
    np.testing.assert_allclose(dots[0, 0], want, rtol=1e-3)
    assert dots[0, 0] >= dots[0, 1] >= dots[0, 2]


def test_packed_server_probes_mode():
    from vector_database_tpu.ops.pallas_knn import pack_database
    from vector_database_tpu.serving import PackedServer

    rng = np.random.RandomState(31)
    centers = rng.rand(32, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 32, size=8000)]
        + 0.05 * rng.randn(8000, 8)
    ).astype(np.float32)
    pack = pack_database(vecs, block=512, buckets=256)
    nb = pack.vb.shape[0]
    srv = PackedServer(pack, k=5, batch=64, probes=nb)  # full coverage
    ref = PackedServer(pack, k=5, batch=64)
    qs = vecs[:100]
    r1, d1 = srv.query(qs)
    r0, d0 = ref.query(qs)
    assert np.array_equal(r1, r0) and np.allclose(d1, d0)

def test_min_probe_batch_guards_underfilled_waves():
    """Waves with fewer real queries than min_probe_batch must be served
    by the FULL scan (pruned small batches lose recall), while full waves
    keep the pruned program."""
    import pytest

    from vector_database_tpu.ops.pallas_knn import pack_database
    from vector_database_tpu.serving import PackedServer

    rng = np.random.RandomState(33)
    centers = rng.rand(32, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 32, size=8000)]
        + 0.05 * rng.randn(8000, 8)
    ).astype(np.float32)
    pack = pack_database(vecs, block=512, buckets=256)
    srv = PackedServer(pack, k=5, batch=64, probes=2, min_probe_batch=64)
    srv.warmup()
    full = PackedServer(pack, k=5, batch=64)
    pruned = PackedServer(pack, k=5, batch=64, probes=2)
    qs = np.asarray(datasets.random_uniform(64, 8, seed=181))

    # under-filled wave (32 real rows) == the full scan's answers
    r_small, d_small = srv.query(qs[:32])
    r_full, d_full = full.query(qs[:32])
    assert np.array_equal(r_small, r_full)
    np.testing.assert_array_equal(d_small, d_full)

    # a full wave keeps the pruned program's answers
    r_wave, d_wave = srv.query(qs)
    r_pruned, d_pruned = pruned.query(qs)
    assert np.array_equal(r_wave, r_pruned)
    np.testing.assert_array_equal(d_wave, d_pruned)

    # guard is meaningless without probes
    with pytest.raises(ValueError):
        PackedServer(pack, k=5, batch=64, min_probe_batch=64)
    # a guard no wave can satisfy would silently disable pruning for all
    # traffic — reject it up front
    with pytest.raises(ValueError, match="exceeds batch"):
        PackedServer(
            pack, k=5, batch=64, probes=2, min_probe_batch=128
        )


def test_probes_max_runtime_program_and_set_probes():
    """probes_max serves pruned waves through the runtime-probes program:
    results bitwise-equal to the static pruned server at EVERY retuned
    value, and set_probes compiles nothing new."""
    import pytest

    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed_rt,
    )
    from vector_database_tpu.serving import PackedServer

    rng = np.random.RandomState(37)
    centers = rng.rand(32, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 32, size=8000)]
        + 0.05 * rng.randn(8000, 8)
    ).astype(np.float32)
    pack = pack_database(vecs, block=512, buckets=256)
    nb = pack.vb.shape[0]
    srv = PackedServer(pack, k=5, batch=64, probes=2, probes_max=nb)
    qs = np.asarray(datasets.random_uniform(64, 8, seed=182))
    base = pallas_scan_knn_packed_rt._cache_size()
    for p in (2, 5, nb):
        srv.set_probes(p)
        r_rt, d_rt = srv.query(qs)
        static = PackedServer(pack, k=5, batch=64, probes=p)
        r_st, d_st = static.query(qs)
        np.testing.assert_array_equal(r_rt, r_st)
        np.testing.assert_array_equal(d_rt, d_st)
    # every retuned value rode ONE compiled runtime-probes program
    assert pallas_scan_knn_packed_rt._cache_size() == base + 1

    with pytest.raises(ValueError, match="probes_max requires"):
        PackedServer(pack, k=5, batch=64, probes_max=nb)
    with pytest.raises(ValueError, match="exceeds probes_max"):
        srv.set_probes(nb + 1)
    with pytest.raises(ValueError, match="without probes"):
        PackedServer(pack, k=5, batch=64).set_probes(3)


def test_sharded_server_probes_max():
    """probes_max on a ShardedPackedDB-backed server rides the sharded
    runtime-probes program; answers equal the static pruned server's."""
    from vector_database_tpu.parallel import make_mesh
    from vector_database_tpu.parallel.scan import pack_database_sharded

    rng = np.random.RandomState(39)
    centers = rng.rand(16, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[np.sort(rng.randint(0, 16, size=4096))]
        + 0.05 * rng.randn(4096, 8)
    ).astype(np.float32)
    sdb = pack_database_sharded(vecs, make_mesh(8), block=64, buckets=64)
    nb_loc = sdb.vb.shape[1]
    srv = PackedServer(
        sdb, k=5, batch=32, probes=max(1, nb_loc // 2), probes_max=nb_loc
    )
    qs = np.asarray(datasets.random_uniform(32, 8, seed=183))
    for p in (1, max(1, nb_loc // 2), nb_loc):
        srv.set_probes(p)
        r_rt, d_rt = srv.query(qs)
        static = PackedServer(sdb, k=5, batch=32, probes=p)
        r_st, d_st = static.query(qs)
        np.testing.assert_array_equal(r_rt, r_st)
        np.testing.assert_array_equal(d_rt, d_st)
