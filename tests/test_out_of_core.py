"""Out-of-core chunked index: per-chunk builds + exact cross-chunk merge,
validated against whole-dataset oracles; mmap-store end-to-end."""

import numpy as np

from vector_database_tpu import exact_ball, exact_knn
from vector_database_tpu.out_of_core import ChunkedIndex
from vector_database_tpu.runtime.native_store import NativeVectorStore
from vector_database_tpu.utils import datasets


def build_chunked(n=2200, d=8, chunk=500, seed=140, leaf_size=4):
    vecs = datasets.random_uniform(n, d, seed=seed)
    index = ChunkedIndex(leaf_size=leaf_size)
    for start in range(0, n, chunk):
        index.add_chunk(vecs[start : start + chunk])
    return index, vecs


def test_knn_matches_exact():
    index, vecs = build_chunked()
    assert len(index) == 2200 and index.num_chunks == 5
    queries = vecs[[3, 700, 2199]]
    rows, d2 = index.knn(queries, k=5, oversample=16)
    eidx, ed2 = exact_knn(vecs, queries, k=5)
    assert (rows[:, 0] == np.array([3, 700, 2199])).all()
    np.testing.assert_allclose(
        np.sort(d2, 1), np.sort(np.asarray(ed2), 1), rtol=1e-3, atol=1e-5
    )


def test_radius_search_matches_oracle():
    index, vecs = build_chunked(n=1200, chunk=400)
    queries = datasets.random_uniform(4, 8, seed=141)
    results = index.search(queries, 0.5)
    truth = np.asarray(exact_ball(vecs, queries, 0.5))
    for qi in range(4):
        got = set(results[qi][0].tolist())
        want = set(np.nonzero(truth[qi])[0].tolist())
        assert got == want


def test_from_store_and_persistence(tmp_path):
    vecs = datasets.random_uniform(900, 6, seed=142)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        index = ChunkedIndex.from_store(store, chunk_rows=300, leaf_size=4)
    assert index.num_chunks == 3

    path = str(tmp_path / "idx")
    index.save(path)
    loaded = ChunkedIndex.load(path)
    assert len(loaded) == 900
    q = vecs[[17]]
    a = loaded.search(q, 0.4)[0]
    b = index.search(q, 0.4)[0]
    assert set(a[0].tolist()) == set(b[0].tolist())
    truth = np.asarray(exact_ball(vecs, q, 0.4))
    assert set(a[0].tolist()) == set(np.nonzero(truth[0])[0].tolist())


def test_dim_mismatch():
    index = ChunkedIndex()
    index.add_chunk(np.zeros((10, 4), np.float32))
    import pytest

    with pytest.raises(ValueError):
        index.add_chunk(np.zeros((10, 5), np.float32))


def test_spill_dir(tmp_path):
    # disk-spilled chunk vectors AND packed blocks: same results, RAM
    # holds only tables
    import os

    from vector_database_tpu.utils import datasets

    vecs = np.asarray(datasets.random_uniform(3000, 8, seed=55))
    ci = ChunkedIndex(leaf_size=8, spill_dir=str(tmp_path / "spill"))
    for i in range(0, 3000, 1000):
        ci.add_chunk(vecs[i:i + 1000])
    assert len(os.listdir(tmp_path / "spill")) == 6  # vectors + vb each
    assert isinstance(ci._chunks[0]["vectors"], np.memmap)
    assert isinstance(ci._chunks[0]["vb"], np.memmap)
    rows, d2 = ci.knn(vecs[:8], k=5)
    from vector_database_tpu import exact_knn

    eidx, ed2 = exact_knn(vecs, vecs[:8], k=5)
    assert np.allclose(np.sort(d2, 1), np.sort(np.asarray(ed2), 1),
                       rtol=1e-4, atol=1e-5)


def test_spilled_save_load_roundtrip(tmp_path):
    """A spilled index must save, reload, and
    serve under the O(node-tables) RAM bound — big arrays stream to .npy
    on save and come back memory-mapped on load."""
    from vector_database_tpu import exact_knn
    from vector_database_tpu.utils import datasets

    vecs = np.asarray(datasets.random_uniform(1700, 8, seed=56))
    ci = ChunkedIndex(leaf_size=8, spill_dir=str(tmp_path / "spill"))
    for i in range(0, 1700, 700):  # ragged final chunk on purpose
        ci.add_chunk(vecs[i:i + 700])
    path = str(tmp_path / "saved")
    ci.save(path)
    loaded = ChunkedIndex.load(path)
    assert len(loaded) == 1700
    assert isinstance(loaded._chunks[0]["vectors"], np.memmap)
    assert isinstance(loaded._chunks[0]["vb"], np.memmap)
    rows, d2 = loaded.knn(vecs[[5, 900, 1699]], k=3)
    assert rows[:, 0].tolist() == [5, 900, 1699]
    _, ed2 = exact_knn(vecs, vecs[[5, 900, 1699]], k=3)
    assert np.allclose(np.sort(d2, 1), np.sort(np.asarray(ed2), 1),
                       rtol=1e-4, atol=1e-5)
    # ε-ball also serves from the mapped arrays
    a = loaded.search(vecs[[42]], 0.4)[0]
    b = ci.search(vecs[[42]], 0.4)[0]
    assert set(a[0].tolist()) == set(b[0].tolist())


def test_uniform_serve_program_across_ragged_chunks():
    """Chunks pad to the first chunk's capacity: a ragged final chunk
    reuses the SAME compiled serve program (no per-chunk respecialize)."""
    from vector_database_tpu.utils import datasets

    vecs = np.asarray(datasets.random_uniform(1100, 8, seed=57))
    ci = ChunkedIndex(leaf_size=8)
    ci.add_chunk(vecs[:500])
    ci.add_chunk(vecs[500:1000])
    ci.add_chunk(vecs[1000:])  # 100 rows, padded to 500
    assert {c["cap"] for c in ci._chunks} == {500}
    assert {c["vb"].shape for c in ci._chunks} == {
        ci._chunks[0]["vb"].shape
    }
    rows, d2 = ci.knn(vecs[[0, 1050]], k=3)
    assert rows[:, 0].tolist() == [0, 1050]
    assert np.allclose(d2[:, 0], 0.0, atol=1e-5)


def test_ip_knn_merges_highest_dots():
    """metric="ip": the cross-chunk merge must keep the HIGHEST dots
    (regression: the merge sorted ascending like squared distances and
    returned each chunk's k worst candidates)."""
    rng = np.random.RandomState(61)
    vecs = (rng.rand(600, 8).astype(np.float32) * 2 - 1) * np.linspace(
        0.1, 10.0, 600
    ).astype(np.float32)[:, None]
    index = ChunkedIndex(leaf_size=4, metric="ip")
    index.add_chunk(vecs[:300])
    index.add_chunk(vecs[300:])
    q = rng.rand(3, 8).astype(np.float32) * 2 - 1
    rows, dots = index.knn(q, k=5, oversample=16)
    truth = q @ vecs.T
    for i in range(3):
        want = set(np.argsort(-truth[i])[:5].tolist())
        assert set(rows[i].tolist()) == want
        np.testing.assert_allclose(
            dots[i], np.sort(truth[i])[::-1][:5], rtol=1e-3, atol=1e-4
        )
        assert (np.diff(dots[i]) <= 1e-4).all()  # highest first


def test_ip_ragged_final_chunk():
    """A ragged final chunk packs with rows_valid=: its +inf sentinel
    rows must never win the ip rerank (regression: -inf/NaN keys beat
    every real dot)."""
    rng = np.random.RandomState(62)
    vecs = rng.rand(517, 8).astype(np.float32) * 2 - 1
    index = ChunkedIndex(leaf_size=4, metric="ip")
    index.add_chunk(vecs[:256])
    index.add_chunk(vecs[256:])  # 261 rows: ragged vs block size
    q = rng.rand(2, 8).astype(np.float32) * 2 - 1
    rows, dots = index.knn(q, k=4, oversample=16)
    truth = q @ vecs.T
    for i in range(2):
        assert (rows[i] >= 0).all()
        assert set(rows[i].tolist()) == set(
            np.argsort(-truth[i])[:4].tolist()
        )


def test_cosine_search_normalizes_queries():
    """metric="cosine": search() must score in the same unit-sphere
    space knn() does — a scaled query returns the same angular ball."""
    rng = np.random.RandomState(63)
    vecs = rng.rand(400, 6).astype(np.float32) * 2 - 1
    index = ChunkedIndex(leaf_size=4, metric="cosine")
    index.add_chunk(vecs[:200])
    index.add_chunk(vecs[200:])
    q = vecs[[17, 333]]
    res_unit = index.search(q, 0.4)
    res_scaled = index.search(q * 37.5, 0.4)
    unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    for i in range(2):
        want = set(
            np.nonzero(
                ((unit - qn[i]) ** 2).sum(1) <= 0.4 * 0.4 + 1e-7
            )[0].tolist()
        )
        assert set(res_unit[i][0].tolist()) == want
        assert set(res_scaled[i][0].tolist()) == want


def test_host_rerank_matches_device_rerank():
    """knn(host_rerank=True) — the candidates-only kernel + host f32
    rerank — must agree with the all-on-device path on rows and scores,
    for every metric, including a ragged (sentinel-padded) final chunk."""
    rng = np.random.RandomState(64)
    for metric in ("l2", "cosine", "ip"):
        vecs = rng.rand(517, 8).astype(np.float32) * 2 - 1
        ci = ChunkedIndex(leaf_size=4, metric=metric)
        ci.add_chunk(vecs[:256])
        ci.add_chunk(vecs[256:])  # ragged: 261 rows padded to 256+
        q = rng.rand(5, 8).astype(np.float32) * 2 - 1
        rh, dh = ci.knn(q, k=6, oversample=16, host_rerank=True)
        rd, dd = ci.knn(q, k=6, oversample=16, host_rerank=False)
        assert (rh >= 0).all() and (rd >= 0).all()
        # same neighbor sets; scores equal where rows agree (ties may
        # order differently between np.argsort and lax.top_k)
        for i in range(5):
            assert set(rh[i].tolist()) == set(rd[i].tolist()), metric
        np.testing.assert_allclose(dh, dd, rtol=1e-4, atol=1e-5)


def test_host_rerank_cosine_scaled_queries():
    """Scaled queries must hit the same angular neighbors: the host
    rerank scores against unit-normalized queries (the chunk's space)."""
    rng = np.random.RandomState(65)
    vecs = rng.rand(400, 6).astype(np.float32) * 2 - 1
    ci = ChunkedIndex(leaf_size=4, metric="cosine")
    ci.add_chunk(vecs[:200])
    ci.add_chunk(vecs[200:])
    q = vecs[[17, 333]]
    r1, d1 = ci.knn(q, k=4)
    r2, d2 = ci.knn(q * 41.0, k=4)
    assert r1.tolist() == r2.tolist()
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-5)
    unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    truth = ((unit[None, :, :] - qn[:, None, :]) ** 2).sum(-1)
    for i in range(2):
        assert set(r1[i].tolist()) == set(
            np.argsort(truth[i])[:4].tolist()
        )


def test_host_rerank_k_exceeds_shortlist():
    """k wider than the kernel shortlist pads with -1/inf instead of
    fabricating rows (mirrors the device path's kk < k branch)."""
    rng = np.random.RandomState(66)
    vecs = rng.rand(40, 6).astype(np.float32)
    ci = ChunkedIndex(leaf_size=4, buckets=8, block=8)
    ci.add_chunk(vecs)
    rows, d2 = ci.knn(vecs[[3]], k=39, oversample=1)
    assert rows[0, 0] == 3 and d2[0, 0] < 1e-6
    got = rows[0][rows[0] >= 0]
    assert len(set(got.tolist())) == len(got)  # no duplicates


def test_pinned_serving_matches_streamed():
    """pin() keeps packed blocks resident in HBM (the capacity serving
    mode): results must match streamed serving bit-for-bit in both
    host_rerank modes, survive add_chunk-after-pin, and free on unpin."""
    index, vecs = build_chunked(n=1700, chunk=600)
    q = np.asarray(vecs[[3, 900, 1650]])
    r0, d0 = index.knn(q, k=5)
    r0d, d0d = index.knn(q, k=5, host_rerank=False)
    index.pin()
    r1, d1 = index.knn(q, k=5)
    r1d, d1d = index.knn(q, k=5, host_rerank=False)
    assert r1.tolist() == r0.tolist()
    np.testing.assert_array_equal(d1, d0)
    assert r1d.tolist() == r0d.tolist()
    np.testing.assert_array_equal(d1d, d0d)
    index.pin()  # idempotent
    # mutation keeps the pinned state consistent
    extra = np.asarray(vecs[:600]) * 0.5 + 2.0
    index.add_chunk(extra)
    r2, _ = index.knn(extra[[7]], k=1)
    assert r2[0, 0] == 1700 + 7
    index.unpin()
    assert index._pinned is None
    r3, d3 = index.knn(q, k=5)
    assert (r3[:, 0] == r1[:, 0]).all()


def test_pinned_pipeline_matches_sequential(monkeypatch):
    """The capacity-mode dispatch pipeline (every chunk kernel enqueued
    + async device->host copy BEFORE any host rerank) must be
    bit-identical to the sequential per-chunk path it overlaps
    (VDB_PIN_PIPELINE=0), full and pruned — merge order is unchanged,
    so even tie-breaks agree."""
    rng = np.random.RandomState(77)
    centers = rng.rand(16, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 16, size=4000)]
        + 0.05 * rng.randn(4000, 8)
    ).astype(np.float32)
    index = ChunkedIndex(leaf_size=8, block=256, buckets=128)
    for lo in range(0, 4000, 1500):
        index.add_chunk(vecs[lo : lo + 1500])
    qs = vecs[:32]
    nb = -(-index._capacity // 256)
    index.pin()
    rp, dp = index.knn(qs, k=5, q_tile=8)
    rpp, dpp = index.knn(qs, k=5, q_tile=8, probes=max(1, nb // 2))
    monkeypatch.setenv("VDB_PIN_PIPELINE", "0")
    rs, ds = index.knn(qs, k=5, q_tile=8)
    rsp, dsp = index.knn(qs, k=5, q_tile=8, probes=max(1, nb // 2))
    assert rp.tolist() == rs.tolist()
    np.testing.assert_array_equal(dp, ds)
    assert rpp.tolist() == rsp.tolist()
    np.testing.assert_array_equal(dpp, dsp)
    index.unpin()


def test_pinned_buffers_typed_bf16():
    """The pinned device buffers must land ALREADY typed bf16: a uint16
    buffer would force a per-call bitcast that allocates a full vb copy
    in HBM — fatal at pin()'s advertised capacity."""
    import jax.numpy as jnp

    index, _ = build_chunked(n=700, chunk=400)
    index.pin()
    assert len(index._pinned) == index.num_chunks
    for vb, vn in index._pinned:
        assert vb.dtype == jnp.bfloat16
        assert vn.dtype == jnp.float32
    index.unpin()


def test_add_chunk_over_budget_unpins(monkeypatch):
    """add_chunk on a pinned index whose new chunk exceeds free HBM must
    degrade to streamed serving (warn + unpin), never leave _pinned
    shorter than _chunks."""
    import vector_database_tpu.out_of_core as ooc

    index, vecs = build_chunked(n=800, chunk=400)
    index.pin()
    monkeypatch.setattr(ooc, "_hbm_budget", lambda: 0)
    import pytest

    with pytest.warns(UserWarning, match="unpinned"):
        index.add_chunk(np.asarray(vecs[:400]) + 3.0)
    assert index._pinned is None
    assert index.num_chunks == 3  # the chunk itself was added
    r, _ = index.knn(np.asarray(vecs[[7]]) + 3.0, k=1)
    assert r[0, 0] == 800 + 7


def test_ip_search_raises():
    index = ChunkedIndex(metric="ip")
    index.add_chunk(np.ones((8, 4), np.float32))
    import pytest

    with pytest.raises(ValueError):
        index.search(np.ones((1, 4), np.float32), 1.0)


def test_from_store_small_store_not_padded(tmp_path):
    """A store smaller than one chunk must not be padded to chunk_rows —
    the chunk capacity collapses to the store size."""
    from vector_database_tpu.runtime.native_store import NativeVectorStore

    rng = np.random.RandomState(77)
    vecs = rng.rand(50, 8).astype(np.float32)
    with NativeVectorStore.create(str(tmp_path / "s.vstore"), dims=8) as st:
        st.append(vecs)
        index = ChunkedIndex.from_store(st, chunk_rows=100_000, leaf_size=4)
    assert index.num_chunks == 1
    assert index._chunks[0]["cap"] == 50
    rows, d2 = index.knn(vecs[:4], k=3)
    assert (rows[:, 0] == np.arange(4)).all()


def test_chunked_knn_probes_roundtrip(tmp_path):
    """Pruned serving over chunks: probes=nb equals unpruned, the
    summaries survive save/load, and a pinned index serves pruned."""
    rng = np.random.RandomState(55)
    centers = rng.rand(16, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[rng.randint(0, 16, size=4000)]
        + 0.05 * rng.randn(4000, 8)
    ).astype(np.float32)
    index = ChunkedIndex(leaf_size=8, block=256, buckets=128)
    for lo in range(0, 4000, 1500):
        index.add_chunk(vecs[lo : lo + 1500])
    qs = vecs[:32]
    nb = -(-index._capacity // 256)
    r_full, d_full = index.knn(qs, k=5, q_tile=8)
    r_all, d_all = index.knn(qs, k=5, q_tile=8, probes=nb)
    assert np.array_equal(r_full, r_all)
    assert np.allclose(d_full, d_all)
    r_p, _ = index.knn(qs, k=5, q_tile=8, probes=max(1, nb // 2))
    hits = sum(
        len(set(r_p[i].tolist()) & set(r_full[i].tolist()))
        for i in range(32)
    )
    assert hits >= 0.6 * 32 * 5
    # summaries round-trip through save/load
    index.save(str(tmp_path / "ci"))
    loaded = ChunkedIndex.load(str(tmp_path / "ci"))
    r_l, d_l = loaded.knn(qs, k=5, q_tile=8, probes=nb)
    assert np.array_equal(r_l, r_all) and np.allclose(d_l, d_all)
    # pinned + pruned (the capacity-mode multiplier)
    loaded.pin()
    r_pin, _ = loaded.knn(qs, k=5, q_tile=8, probes=nb)
    assert np.array_equal(r_pin, r_all)
    loaded.unpin()


class _FailingStore:
    """Row source that dies after yielding ``fail_after`` chunks —
    simulates a mid-build crash for the checkpoint/resume contract."""

    def __init__(self, store, fail_after):
        self._store = store
        self._fail_after = fail_after

    def __len__(self):
        return len(self._store)

    def chunks(self, chunk_rows):
        for i, chunk in enumerate(self._store.chunks(chunk_rows)):
            if i >= self._fail_after:
                raise RuntimeError("injected mid-build crash")
            yield chunk


def test_from_store_checkpoint_resume(tmp_path):
    """A crash mid-build must not restart from
    chunk 0. Interrupt after chunk 1 of 3, resume with the same
    arguments, and the result must be BIT-identical to an uninterrupted
    build — node tables, packed blocks, vectors, and query answers."""
    import pytest

    vecs = datasets.random_uniform(1100, 6, seed=147)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        ck = str(tmp_path / "ck")
        with pytest.raises(RuntimeError, match="injected"):
            ChunkedIndex.from_store(
                _FailingStore(store, 1), chunk_rows=400, leaf_size=4,
                checkpoint_dir=ck,
            )
        # chunk 0 completed and is durable
        import json as _json
        import os as _os

        with open(_os.path.join(ck, "resume.json")) as f:
            assert _json.load(f)["chunks_done"] == 1
        resumed = ChunkedIndex.from_store(
            store, chunk_rows=400, leaf_size=4, checkpoint_dir=ck
        )
        fresh = ChunkedIndex.from_store(store, chunk_rows=400, leaf_size=4)
    assert resumed.num_chunks == fresh.num_chunks == 3
    assert len(resumed) == 1100
    for cr, cf in zip(resumed._chunks, fresh._chunks):
        for key in ("dim", "mid", "low", "high", "leaf_start",
                    "leaf_count", "orig_row", "vn", "vb", "vectors",
                    "cent", "rad"):
            np.testing.assert_array_equal(
                np.asarray(cr[key]), np.asarray(cf[key]), err_msg=key
            )
    q = vecs[[3, 512, 1050]]
    rows_r, d_r = resumed.knn(q, k=5)
    rows_f, d_f = fresh.knn(q, k=5)
    np.testing.assert_array_equal(rows_r, rows_f)
    np.testing.assert_array_equal(d_r, d_f)
    # the finished checkpoint dir doubles as a save(): load() just works
    loaded = ChunkedIndex.load(ck)
    rows_l, _ = loaded.knn(q, k=5)
    np.testing.assert_array_equal(rows_l, rows_f)


def test_from_store_checkpoint_param_mismatch(tmp_path):
    import pytest

    vecs = datasets.random_uniform(500, 6, seed=148)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        ck = str(tmp_path / "ck")
        ChunkedIndex.from_store(
            store, chunk_rows=250, leaf_size=4, checkpoint_dir=ck
        )
        with pytest.raises(ValueError, match="different"):
            ChunkedIndex.from_store(
                store, chunk_rows=100, leaf_size=4, checkpoint_dir=ck
            )


def test_from_store_completed_checkpoint_is_noop(tmp_path):
    """Re-running from_store over a COMPLETE checkpoint re-reads no
    device work: every chunk loads from the manifest."""
    vecs = datasets.random_uniform(600, 6, seed=149)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        ck = str(tmp_path / "ck")
        a = ChunkedIndex.from_store(
            store, chunk_rows=200, leaf_size=4, checkpoint_dir=ck
        )
        b = ChunkedIndex.from_store(
            store, chunk_rows=200, leaf_size=4, checkpoint_dir=ck
        )
    assert b.num_chunks == a.num_chunks
    # resumed chunks are memmaps of the checkpoint files, not rebuilt
    assert all(
        getattr(c["vb"], "filename", None) is not None for c in b._chunks
    )
    q = vecs[[7, 300]]
    np.testing.assert_array_equal(a.knn(q, k=4)[0], b.knn(q, k=4)[0])


def test_chunked_knn_min_probe_batch_guard(tmp_path):
    """ChunkedIndex.knn's small-batch pruning guard: calls with fewer
    queries than min_probe_batch serve the full scan (answers identical
    to the unpruned call); min_probe_batch without probes raises."""
    import pytest

    rng = np.random.RandomState(153)
    centers = rng.rand(16, 8).astype(np.float32) * 2 - 1
    vecs = (
        centers[np.sort(rng.randint(0, 16, size=4000))]
        + 0.05 * rng.randn(4000, 8)
    ).astype(np.float32)
    index = ChunkedIndex(leaf_size=8, block=256, buckets=64)
    index.add_chunk(vecs[:2000])
    index.add_chunk(vecs[2000:])
    qs = (
        centers[rng.randint(0, 16, size=8)]
        + 0.05 * rng.randn(8, 8)
    ).astype(np.float32)

    r_full, d_full = index.knn(qs, k=5, q_tile=8)
    r_g, d_g = index.knn(
        qs, k=5, q_tile=8, probes=1, min_probe_batch=64
    )
    np.testing.assert_array_equal(r_g, r_full)
    np.testing.assert_array_equal(d_g, d_full)
    # a filled batch keeps the pruned path (probes=1 really prunes here)
    r_p, _ = index.knn(qs, k=5, q_tile=8, probes=1, min_probe_batch=8)
    assert not np.array_equal(r_p, r_full)

    with pytest.raises(ValueError, match="min_probe_batch"):
        index.knn(qs, k=5, q_tile=8, min_probe_batch=8)


def test_from_store_checkpoint_data_mismatch(tmp_path):
    """Resuming a checkpoint against DIFFERENT data must raise, not mix
    chunks of two datasets: same-length store
    with different content trips the chunk-0 fingerprint; a grown store
    trips the recorded length."""
    import pytest

    vecs_a = datasets.random_uniform(800, 6, seed=154)
    vecs_b = datasets.random_uniform(800, 6, seed=155)
    with NativeVectorStore.create(str(tmp_path / "a"), dims=6) as sa, \
            NativeVectorStore.create(str(tmp_path / "b"), dims=6) as sb, \
            NativeVectorStore.create(str(tmp_path / "c"), dims=6) as sc:
        sa.append(vecs_a)
        sb.append(vecs_b)
        sc.append(vecs_a)
        sc.append(vecs_b[:100])
        ck = str(tmp_path / "ck")
        with pytest.raises(RuntimeError, match="injected"):
            ChunkedIndex.from_store(
                _FailingStore(sa, 1), chunk_rows=400, leaf_size=4,
                checkpoint_dir=ck,
            )
        with pytest.raises(ValueError, match="fingerprint"):
            ChunkedIndex.from_store(
                sb, chunk_rows=400, leaf_size=4, checkpoint_dir=ck
            )
        with pytest.raises(ValueError, match="rows"):
            ChunkedIndex.from_store(
                sc, chunk_rows=400, leaf_size=4, checkpoint_dir=ck
            )
        # the true store still resumes to a complete index
        done = ChunkedIndex.from_store(
            sa, chunk_rows=400, leaf_size=4, checkpoint_dir=ck
        )
    assert len(done) == 800
