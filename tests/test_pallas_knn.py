"""Packed bucket-scan serving (the plain XLA route on CPU) vs the exact
oracle.

The shortlist has one slot per bucket of database rows, so exact-recall
assertions only hold for queries whose neighbors can't collide (self-queries
with distance 0 always win their bucket); statistical recall is asserted
with collision-aware margins.
"""

import numpy as np

from vector_database_tpu import exact_knn
from vector_database_tpu.ops.pallas_knn import pallas_scan_knn
from vector_database_tpu.utils import datasets


def test_self_queries_and_padding():
    # n, d, q all unaligned to block/tile/lane sizes
    vecs = datasets.random_uniform(777, 13, seed=112)
    queries = vecs[[0, 400, 776]]
    rows, d2 = pallas_scan_knn(vecs, queries, k=1, block=128, q_tile=8)
    rows = np.asarray(rows)
    assert rows[:, 0].tolist() == [0, 400, 776]
    assert np.allclose(np.asarray(d2)[:, 0], 0.0, atol=1e-5)
    assert (rows < 777).all()


def test_recall_and_distance_exactness():
    vecs = datasets.random_uniform(8192, 24, seed=110)
    queries = datasets.random_uniform(8, 24, seed=111)
    k = 3
    rows, d2 = pallas_scan_knn(
        vecs, queries, k=k, block=512, q_tile=8, oversample=8
    )
    eidx, _ = exact_knn(vecs, queries, k=k)
    rows, eidx = np.asarray(rows), np.asarray(eidx)
    total = sum(
        len(set(rows[i].tolist()) & set(eidx[i].tolist())) for i in range(8)
    )
    # 64 bucket slots, 3 near-tied uniform-data neighbors: allow collisions
    assert total >= 17  # >= ~70% recall
    # returned distances are true f32 distances of the returned rows
    d2 = np.asarray(d2)
    qs = np.asarray(queries)
    for qi in range(8):
        for j in range(k):
            r = rows[qi, j]
            if r >= 0:
                true = float(np.sum((vecs[r] - qs[qi]) ** 2))
                assert abs(true - d2[qi, j]) < 1e-3


def test_clustered_high_recall():
    rng = np.random.default_rng(113)
    centers = (rng.random((64, 32)) * 2 - 1).astype(np.float32)
    assign = rng.integers(0, 64, 16384)
    vecs = centers[assign] + rng.normal(0, 0.05, (16384, 32)).astype(
        np.float32
    )
    queries = centers[:8] + rng.normal(0, 0.05, (8, 32)).astype(np.float32)
    rows, _ = pallas_scan_knn(
        vecs, queries, k=10, block=1024, q_tile=8, oversample=8
    )
    eidx, _ = exact_knn(vecs, queries, k=10)
    rows, eidx = np.asarray(rows), np.asarray(eidx)
    total = sum(
        len(set(rows[i].tolist()) & set(eidx[i].tolist())) for i in range(8)
    )
    assert total >= 72  # >= 90% recall with 128 bucket slots


def test_metric_cosine():
    # cosine = L2 over unit rows; compare against the normalized oracle
    rng = np.random.default_rng(141)
    vecs = (rng.random((3000, 24)) * 4 - 2).astype(np.float32)
    # non-unit norms so cosine genuinely differs from raw L2
    vecs *= rng.random((3000, 1)).astype(np.float32) * 3 + 0.1
    queries = (rng.random((16, 24)) * 4 - 2).astype(np.float32)
    from vector_database_tpu.ops.exact import normalize_rows

    nv = np.asarray(normalize_rows(vecs))
    nq = np.asarray(normalize_rows(queries))
    eidx, ed2 = exact_knn(nv, nq, k=5)
    rows, d2 = pallas_scan_knn(
        vecs, queries, k=5, block=512, q_tile=8, metric="cosine"
    )
    rows, eidx = np.asarray(rows), np.asarray(eidx)
    hits = sum(
        len(set(rows[i].tolist()) & set(eidx[i].tolist()))
        for i in range(16)
    )
    assert hits >= 72  # >= 90%
    # distances are normalized-space d2: cos = 1 - d2/2 in [-1, 1]
    cos = 1 - np.asarray(d2)[:, 0] / 2
    assert np.all(cos <= 1.0 + 1e-5) and np.all(cos >= -1.0 - 1e-5)


def test_exact_mips_k_exceeds_n():
    """k > n must pad with -1 / -inf (the exact_knn contract), not crash."""
    from vector_database_tpu.ops.exact import exact_mips

    vecs = np.eye(3, 4, dtype=np.float32)
    idx, dots = exact_mips(vecs, vecs[:2], k=5)
    idx, dots = np.asarray(idx), np.asarray(dots)
    assert idx.shape == (2, 5) and dots.shape == (2, 5)
    assert (idx[:, 3:] == -1).all()
    assert np.isneginf(dots[:, 3:]).all()
    assert idx[0, 0] == 0 and idx[1, 0] == 1


def test_pack_empty_database_raises():
    import pytest

    from vector_database_tpu.ops.pallas_knn import pack_database

    with pytest.raises(ValueError, match="empty"):
        pack_database(np.zeros((0, 8), np.float32), block=256, buckets=64)


def test_metric_ip():
    from vector_database_tpu.ops.exact import exact_mips

    rng = np.random.default_rng(142)
    vecs = (rng.random((3000, 24)) * 2 - 1).astype(np.float32)
    vecs *= rng.random((3000, 1)).astype(np.float32) * 2 + 0.1
    queries = (rng.random((16, 24)) * 2 - 1).astype(np.float32)
    eidx, edots = exact_mips(vecs, queries, k=5)
    rows, dots = pallas_scan_knn(
        vecs, queries, k=5, block=512, q_tile=8, metric="ip"
    )
    rows, dots = np.asarray(rows), np.asarray(dots)
    eidx, edots = np.asarray(eidx), np.asarray(edots)
    hits = sum(
        len(set(rows[i].tolist()) & set(eidx[i].tolist()))
        for i in range(16)
    )
    assert hits >= 72
    # dots are exact f32 inner products of the returned rows, descending
    for qi in range(16):
        true = float(np.dot(vecs[rows[qi, 0]], queries[qi]))
        assert abs(true - dots[qi, 0]) < 1e-3
        assert np.all(np.diff(dots[qi]) <= 1e-6)


def test_probes_full_coverage_equals_full_scan():
    """probes >= num_blocks must reproduce the full scan EXACTLY (same
    buckets, same mantissa ids) regardless of the query grouping."""
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    vecs = datasets.random_uniform(3000, 12, seed=150)
    queries = datasets.random_uniform(37, 12, seed=151)
    pack = pack_database(vecs, block=512, buckets=128)
    nb = pack.vb.shape[0]
    assert nb > 1
    fr, fd = pallas_scan_knn_packed(pack, queries, k=4, q_tile=8)
    pr, pd = pallas_scan_knn_packed(
        pack, queries, k=4, q_tile=8, probes=nb
    )
    assert np.array_equal(np.asarray(fr), np.asarray(pr))
    assert np.allclose(np.asarray(fd), np.asarray(pd))


def test_probes_recall_on_clustered_data():
    """Pruned serving over a leaf-major (tree-sorted) database: a
    fraction of the stream retains most of the recall, and distances
    stay exact f32 for whatever rows come back."""
    from vector_database_tpu import build_index_fused
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    rng = np.random.RandomState(7)
    centers = rng.rand(64, 8).astype(np.float32) * 2 - 1
    assign = rng.randint(0, 64, size=40000)
    vecs = (centers[assign] + 0.03 * rng.randn(40000, 8)).astype(
        np.float32
    )
    # enough queries that each sorted tile's 64 queries share block
    # locality — pruning is a BATCH mode (tiles of spread-out queries
    # genuinely need most of the stream; see the kernel docstring)
    queries = (
        centers[rng.randint(0, 64, size=512)]
        + 0.03 * rng.randn(512, 8)
    ).astype(np.float32)
    index = build_index_fused(vecs, leaf_size=16)
    pack = pack_database(index.vectors, block=1024, buckets=512)
    nb = pack.vb.shape[0]  # ~40 blocks
    truth = np.asarray(exact_knn(index.vectors, queries, k=10)[0])

    def recall(rows):
        rows = np.asarray(rows)
        return sum(
            len(set(rows[i].tolist()) & set(truth[i].tolist()))
            for i in range(rows.shape[0])
        ) / (rows.shape[0] * 10)

    full_rows, _ = pallas_scan_knn_packed(pack, queries, k=10, q_tile=64)
    rows, d2 = pallas_scan_knn_packed(
        pack, queries, k=10, q_tile=64, probes=max(1, nb // 3)
    )
    # a third of the stream keeps recall within a few points of the
    # full scan (whose own recall here is bucket-collision-bound)
    assert recall(rows) >= recall(full_rows) - 0.05
    assert recall(rows) >= 0.5
    # distances exact for returned rows
    rows, d2 = np.asarray(rows), np.asarray(d2)
    lm = np.asarray(index.vectors)
    for qi in (0, 17, 63):
        r = rows[qi, 0]
        true = float(((lm[r] - queries[qi]) ** 2).sum())
        assert abs(true - d2[qi, 0]) < 1e-4


def test_probes_requires_summaries_and_bf16():
    import dataclasses as dc

    import pytest

    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    vecs = datasets.random_uniform(2000, 8, seed=152)
    queries = datasets.random_uniform(8, 8, seed=153)
    pack = pack_database(vecs, block=256, buckets=128)
    bare = dc.replace(pack, cent=None, rad=None)  # reloaded-buffer pack
    with pytest.raises(ValueError, match="summaries"):
        pallas_scan_knn_packed(bare, queries, k=3, q_tile=8, probes=2)


def test_pruned_kernel_exact_via_sentinel_block():
    """EXACT check that actually runs the pruned kernel (probes < nb):
    the final block holds only +inf sentinels (rows_valid), so its
    radius sentinel bars it from selection and probes = nb-1 covers
    every real row — the result must equal the full scan bit for bit,
    proving the SMEM block-map DMA indexing, the mantissa ids, and the
    query grouping/ungrouping are lossless."""
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    vecs = datasets.random_uniform(1024, 16, seed=160)  # 4 real blocks
    padded = np.concatenate(
        [np.asarray(vecs), np.full((256, 16), np.inf, np.float32)]
    )
    pack = pack_database(
        padded, block=256, buckets=128, rows_valid=1024
    )
    nb = pack.vb.shape[0]
    assert nb == 5
    queries = datasets.random_uniform(50, 16, seed=161)
    fr, fd = pallas_scan_knn_packed(pack, queries, k=5, q_tile=16)
    pr, pd = pallas_scan_knn_packed(
        pack, queries, k=5, q_tile=16, probes=nb - 1
    )
    assert np.array_equal(np.asarray(fr), np.asarray(pr))
    assert np.allclose(np.asarray(fd), np.asarray(pd))


def test_calibrate_probes():
    """Binary search returns the smallest probes meeting the target
    (recall vs the full scan is prefix-monotone in probes: a tile's
    top-(P+1) block list extends its top-P list)."""
    from vector_database_tpu import build_index_fused
    from vector_database_tpu.ops.pallas_knn import (
        calibrate_probes,
        pack_database,
        pallas_scan_knn_packed,
    )

    rng = np.random.RandomState(13)
    centers = rng.rand(64, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 64, size=50000)]
        + 0.04 * rng.randn(50000, 8)
    ).astype(np.float32)
    index = build_index_fused(vecs, leaf_size=16)
    pack = pack_database(index.vectors, block=1024, buckets=512)
    nb = pack.vb.shape[0]
    qs = (
        centers[rng.randint(0, 64, size=256)]
        + 0.04 * rng.randn(256, 8)
    ).astype(np.float32)
    p = calibrate_probes(pack, qs, k=10, target_recall=0.9, q_tile=64)
    assert 1 <= p <= nb
    full, _ = pallas_scan_knn_packed(pack, qs, k=10, q_tile=64)
    rows, _ = pallas_scan_knn_packed(
        pack, qs, k=10, q_tile=64, probes=p
    )
    full, rows = np.asarray(full), np.asarray(rows)
    want = [set(r.tolist()) - {-1} for r in full]
    hits = sum(
        len(set(rows[i].tolist()) & want[i]) for i in range(256)
    )
    assert hits / max(1, sum(len(w) for w in want)) >= 0.9
    # a target of 1.0-epsilon must still terminate (worst case p = nb)
    p_hi = calibrate_probes(pack, qs[:32], k=5, target_recall=1.0,
                            q_tile=32)
    assert p_hi <= nb


def test_pruned_kernel_exact_cosine():
    """Same sentinel-block exactness as above, through the cosine
    metric (pack-time row normalization + serve-time query
    normalization must commute with the pruned selection)."""
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    vecs = np.asarray(datasets.random_uniform(1024, 16, seed=171)) + 0.2
    padded = np.concatenate(
        [vecs, np.full((256, 16), np.inf, np.float32)]
    )
    pack = pack_database(
        padded, block=256, buckets=128, rows_valid=1024, metric="cosine"
    )
    nb = pack.vb.shape[0]
    queries = datasets.random_uniform(33, 16, seed=172)
    fr, fd = pallas_scan_knn_packed(pack, queries, k=5, q_tile=16)
    pr, pd = pallas_scan_knn_packed(
        pack, queries, k=5, q_tile=16, probes=nb - 1
    )
    assert np.array_equal(np.asarray(fr), np.asarray(pr))
    assert np.allclose(np.asarray(fd), np.asarray(pd))


def test_runtime_probes_matches_static():
    """The runtime-probes program (``pallas_scan_knn_packed_rt``) must be
    bitwise-identical to the static ``probes=p`` call for every p: the
    block map is top-k-sorted, so the first p entries of the
    ``probes_max``-wide map ARE the static map, and the kernel loop just
    stops at the runtime bound."""
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
        pallas_scan_knn_packed_rt,
    )

    rng = np.random.RandomState(23)
    centers = rng.rand(32, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 32, size=8000)]
        + 0.05 * rng.randn(8000, 8)
    ).astype(np.float32)
    pack = pack_database(vecs, block=512, buckets=128)
    nb = pack.vb.shape[0]
    assert nb >= 8
    queries = (
        centers[rng.randint(0, 32, size=64)]
        + 0.05 * rng.randn(64, 8)
    ).astype(np.float32)
    for p in (1, 3, nb // 2, nb):
        sr, sd = pallas_scan_knn_packed(
            pack, queries, k=5, q_tile=16, probes=p
        )
        rr, rd = pallas_scan_knn_packed_rt(
            pack, queries, p, k=5, probes_max=nb, q_tile=16
        )
        assert np.array_equal(np.asarray(sr), np.asarray(rr)), p
        np.testing.assert_array_equal(np.asarray(sd), np.asarray(rd))
    # probes beyond probes_max clips to the cap (same as probes_max)
    cr, _ = pallas_scan_knn_packed_rt(
        pack, queries, nb + 100, k=5, probes_max=nb, q_tile=16
    )
    rr, _ = pallas_scan_knn_packed_rt(
        pack, queries, nb, k=5, probes_max=nb, q_tile=16
    )
    assert np.array_equal(np.asarray(cr), np.asarray(rr))


def test_calibrate_probes_two_compiles():
    """Deploy-time calibration must issue at most TWO fresh programs (a
    remote compile here costs 20s-5min; round-3 verdict weak#4): one
    full-scan reference + one runtime-probes program shared by every
    binary-search step."""
    from vector_database_tpu.ops.pallas_knn import (
        calibrate_probes,
        pack_database,
        pallas_scan_knn_packed,
        pallas_scan_knn_packed_rt,
    )

    rng = np.random.RandomState(29)
    centers = rng.rand(32, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 32, size=20000)]
        + 0.05 * rng.randn(20000, 8)
    ).astype(np.float32)
    pack = pack_database(vecs, block=512, buckets=128)
    qs = (
        centers[rng.randint(0, 32, size=128)]
        + 0.05 * rng.randn(128, 8)
    ).astype(np.float32)
    before = (
        pallas_scan_knn_packed._cache_size(),
        pallas_scan_knn_packed_rt._cache_size(),
    )
    p = calibrate_probes(pack, qs, k=10, target_recall=0.9, q_tile=32)
    after = (
        pallas_scan_knn_packed._cache_size(),
        pallas_scan_knn_packed_rt._cache_size(),
    )
    assert 1 <= p <= pack.vb.shape[0]
    assert after[0] - before[0] <= 1  # the full-scan reference
    assert after[1] - before[1] <= 1  # ONE shared runtime-probes program


def test_blockwise_pack_matches_whole_matrix():
    """The fused blockwise pack (one lax.map: zeroing, norm row, bf16
    transpose, summaries — no full-size f32 temporaries) must reproduce
    the whole-matrix reference pack: vb/vn BITWISE; summaries to f32
    reduction-order ulps (the blockwise body sums over the d_pad lanes)."""
    import jax.numpy as jnp

    from vector_database_tpu.ops.pallas_knn import (
        _block_summaries,
        _pack,
        _pack_blockwise,
        _summary_cell,
    )

    rng = np.random.RandomState(31)
    for n, nv in ((1000, None), (777, 700), (100, None)):
        v = rng.rand(n, 12).astype(np.float32) * 2 - 1
        if nv:
            v[nv:] = np.inf
        block, cell = 256, _summary_cell(256)
        a_vb, a_vn = _pack(
            jnp.asarray(v), block=block, d_align=128, ip=False, n_valid=nv
        )
        a_c, a_r = _block_summaries(
            jnp.asarray(v), block=block, cell=cell,
            n_valid=nv if nv else n,
        )
        b_vb, b_vn, b_c, b_r = _pack_blockwise(
            jnp.asarray(v), block=block, d_align=128, ip=False,
            n_valid=nv, cell=cell,
        )
        np.testing.assert_array_equal(np.asarray(a_vb), np.asarray(b_vb))
        np.testing.assert_array_equal(np.asarray(a_vn), np.asarray(b_vn))
        np.testing.assert_allclose(
            np.asarray(a_c), np.asarray(b_c), rtol=1e-6, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(a_r), np.asarray(b_r), rtol=1e-6, atol=1e-6
        )


def test_mask_rows_tombstone_serving_is_exact():
    """``PackedDB.mask_rows(alive)`` + ``row_mask=`` must equal the
    exact oracle over the LIVE rows when every row owns its own bucket
    (n <= buckets): dead rows can neither win buckets nor be returned
    from a shared winning bucket."""
    import jax.numpy as jnp

    from vector_database_tpu import exact_knn
    from vector_database_tpu.ops.pallas_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    rng = np.random.RandomState(52)
    vecs = rng.rand(600, 12).astype(np.float32) * 2 - 1
    queries = jnp.asarray(rng.rand(32, 12).astype(np.float32) * 2 - 1)
    alive = np.ones(600, bool)
    alive[rng.choice(600, size=150, replace=False)] = False

    pack = pack_database(jnp.asarray(vecs), block=1024, buckets=1024)
    masked = pack.mask_rows(alive)
    # shares everything but the norm row
    assert masked.vb is pack.vb and masked.vectors is pack.vectors
    assert masked.cent is pack.cent and masked.rad is pack.rad

    rows, d2 = pallas_scan_knn_packed(
        masked, queries, k=5, q_tile=8, row_mask=jnp.asarray(alive)
    )
    rows = np.asarray(rows)
    assert alive[rows[rows >= 0]].all()  # no dead row ever returned

    live_rows = np.nonzero(alive)[0]
    erows, ed2 = exact_knn(jnp.asarray(vecs[alive]), queries, k=5)
    for i in range(32):
        got = set(rows[i].tolist()) - {-1}
        want = set(live_rows[np.asarray(erows)[i]].tolist())
        assert got == want
    np.testing.assert_allclose(
        np.sort(np.asarray(d2), 1), np.sort(np.asarray(ed2), 1),
        rtol=1e-4, atol=1e-5,
    )

    # k beyond the live count: filler comes back -1/inf, never dead
    few = np.zeros(600, bool)
    few[live_rows[:3]] = True
    rows3, d23 = pallas_scan_knn_packed(
        pack.mask_rows(few), queries, k=5, q_tile=8,
        row_mask=jnp.asarray(few),
    )
    rows3, d23 = np.asarray(rows3), np.asarray(d23)
    assert ((rows3 >= 0).sum(1) == 3).all()
    assert few[rows3[rows3 >= 0]].all()
    assert np.isinf(d23[rows3 < 0]).all()


def test_auto_block_high_d_fits_vmem():
    """The reference's own 1536-d config (Program.cs:9-31) packs and
    serves at the default block, on the platform route and through the
    GPU kernel in the interpreter: self-queries find themselves."""
    import jax.numpy as jnp

    from vector_database_tpu.ops.pallas_knn import (
        DEFAULT_BLOCK,
        pack_database,
        pallas_scan_knn_packed,
    )

    rng = np.random.RandomState(57)
    vecs = rng.rand(600, 1536).astype(np.float32) * 2 - 1
    queries = vecs[[3, 77, 599]]
    pack = pack_database(jnp.asarray(vecs))
    assert pack.block == DEFAULT_BLOCK
    assert pack.vb.shape[1] == 1536  # a multiple of 16: no D padding
    for interpret in (False, True):
        rows, d2 = pallas_scan_knn_packed(
            pack, jnp.asarray(queries), k=3, q_tile=16,
            interpret=interpret,
        )
        assert np.asarray(rows)[:, 0].tolist() == [3, 77, 599]
        assert np.allclose(np.asarray(d2)[:, 0], 0.0, atol=1e-2)
