"""DynamicIndex: add/remove/search cycles validated against a live numpy
oracle maintained alongside."""

import numpy as np

from vector_database_tpu.dynamic import DynamicIndex
from vector_database_tpu.utils import datasets


class Oracle:
    def __init__(self):
        self.vecs = {}

    def add(self, ids, vectors):
        for i, v in zip(ids, np.atleast_2d(vectors)):
            self.vecs[int(i)] = np.asarray(v, np.float32)

    def remove(self, point, radius):
        gone = [
            i for i, v in self.vecs.items()
            if np.sum((v - point) ** 2) <= radius * radius
        ]
        for i in gone:
            del self.vecs[i]
        return len(gone)

    def search(self, point, radius):
        return {
            i for i, v in self.vecs.items()
            if np.sum((v - point) ** 2) <= radius * radius
        }


def test_add_search_remove_cycle():
    rng = np.random.default_rng(90)
    index = DynamicIndex(leaf_size=4, rebuild_fraction=0.5)
    oracle = Oracle()

    base = datasets.random_uniform(400, 6, seed=91)
    ids = index.add(base)
    oracle.add(ids, base)
    index.compact()

    for step in range(6):
        point = rng.random(6).astype(np.float32) * 2 - 1
        radius = 0.5
        got_ids, got_d2 = index.search(point, radius)[0]
        assert set(got_ids.tolist()) == oracle.search(point, radius), step

        # interleave adds and removes
        extra = rng.random((20, 6)).astype(np.float32) * 2 - 1
        new_ids = index.add(extra)
        oracle.add(new_ids, extra)
        rp = rng.random(6).astype(np.float32) * 2 - 1
        assert index.remove(rp, 0.4) == oracle.remove(rp, 0.4)

    assert len(index) == len(oracle.vecs)


def test_knn_with_pending_delta():
    index = DynamicIndex(leaf_size=4)
    a = index.add(datasets.random_uniform(200, 4, seed=92))
    index.compact()
    target = np.array([0.123, -0.5, 0.9, 0.0], np.float32)
    (tid,) = index.add(target)  # sits in the delta buffer
    ids, d2 = index.knn(target, k=1, radius=1.0)
    assert ids[0, 0] == tid and d2[0, 0] == 0.0


def test_remove_ids():
    index = DynamicIndex(leaf_size=4)
    vecs = datasets.random_uniform(50, 4, seed=93)
    ids = index.add(vecs)
    index.compact()
    assert index.remove_ids(ids[:10]) == 10
    assert len(index) == 40
    got, _ = index.search(vecs[5], 0.0)[0]
    assert got.size == 0


def test_auto_compaction_trigger():
    index = DynamicIndex(leaf_size=4, rebuild_fraction=0.1)
    index.add(datasets.random_uniform(100, 4, seed=94))
    index.compact()
    index.add(datasets.random_uniform(30, 4, seed=95))  # 30% churn
    # delta got folded into the main index
    assert not index._delta_ids
    assert len(index) == 130


def test_save_load_roundtrip(tmp_path):
    index = DynamicIndex(leaf_size=4)
    vecs = datasets.random_uniform(300, 5, seed=96)
    ids = index.add(vecs)
    index.remove_ids(ids[:20])
    index.add(datasets.random_uniform(10, 5, seed=97))  # pending delta
    path = str(tmp_path / "dyn")
    index.save(path)
    loaded = DynamicIndex.load(path)
    assert len(loaded) == len(index) == 290
    q = vecs[50]
    a = loaded.search(q, 0.3)[0]
    b = index.search(q, 0.3)[0]
    assert set(a[0].tolist()) == set(b[0].tolist())
    # ids keep incrementing after reload
    new_ids = loaded.add(np.zeros((1, 5), np.float32))
    assert new_ids[0] == index._next_id


def test_empty_and_remove_all():
    index = DynamicIndex()
    assert index.search(np.zeros(3), 1.0)[0][0].size == 0
    index.add(np.ones((5, 3), np.float32))
    assert index.remove(np.ones(3, np.float32), 0.0) == 5
    assert len(index) == 0


def test_init_builds_once_and_save_skips_rebuild(tmp_path, monkeypatch):
    """__init__(vectors) must not build the same tree twice, and save()
    on an already-compact index must not rebuild (regression: both paths
    paid a full redundant build)."""
    import vector_database_tpu.dynamic as dyn

    calls = [0]
    real = dyn.build_index_fused

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(dyn, "build_index_fused", counting)
    vecs = datasets.random_uniform(200, 4, seed=50)
    index = DynamicIndex(np.asarray(vecs))
    assert calls[0] == 1
    index.save(str(tmp_path / "ck"))  # compact no-op: still 1 build
    assert calls[0] == 1
    index.remove_ids([0])  # tombstone below threshold: no rebuild
    index.compact()  # now dirty: exactly one more build
    assert calls[0] == 2


def test_search_remove_exact_under_overflow(monkeypatch):
    """When the tree walk's candidate buffer overflows at its growth
    cap, search() and remove() must fall back to the exact scan instead
    of silently truncating (regression: dropped matches / immortal
    rows). Overflow is forced by monkeypatching the walk's result."""
    import dataclasses

    import vector_database_tpu.dynamic as dyn

    vecs = np.asarray(datasets.random_uniform(300, 4, seed=51))
    index = DynamicIndex(vecs)
    q = vecs[7]
    radius = 0.6
    truth = np.nonzero(((vecs - q) ** 2).sum(1) <= radius * radius)[0]
    assert truth.size > 3

    real_search = dyn.bsp_search

    def overflowing(idx, queries, r, **kw):
        res = real_search(idx, queries, r, **kw)
        # keep only one candidate and raise the overflow flag
        trunc = np.full(np.asarray(res.rows).shape, -1, np.int32)
        trunc[:, 0] = np.asarray(res.rows)[:, 0]
        return dataclasses.replace(
            res,
            rows=trunc,
            overflow=np.ones(np.asarray(res.overflow).shape, bool),
        )

    monkeypatch.setattr(dyn, "bsp_search", overflowing)
    got = index.search(np.asarray([q]), radius)
    assert set(got[0][0].tolist()) == set(truth.tolist())
    removed = index.remove(q, radius)
    assert removed == truth.size
    assert len(index) == 300 - truth.size
    monkeypatch.setattr(dyn, "bsp_search", real_search)
    after = index.search(np.asarray([q]), radius)
    assert after[0][0].size == 0


def test_add_empty_is_noop():
    index = DynamicIndex()
    ids = index.add([])
    assert ids.size == 0 and len(index) == 0 and index.dims is None
    # the index must remain usable with real-dimension rows afterwards
    index.add(np.ones((2, 3), np.float32))
    assert index.dims == 3 and len(index) == 2
    got = index.add(np.zeros((0,), np.float32))
    assert got.size == 0 and len(index) == 2


def test_knn_packed_matches_exact_and_caches_per_epoch():
    """packed=True serves through the packed bucket scan from a per-epoch
    pack: results match the exact scan (bucketed-scan accuracy model),
    the pack is REUSED while the index is unmutated, and any mutation
    invalidates it so removed rows can never be served."""
    import pytest

    from vector_database_tpu.utils import datasets

    vecs = np.asarray(datasets.random_uniform(3000, 12, seed=412))
    index = DynamicIndex(vectors=vecs, leaf_size=8)
    queries = np.asarray(datasets.random_uniform(64, 12, seed=413))

    eids, ed2 = index.knn(queries, k=5)
    pids, pd2 = index.knn(queries, k=5, packed=True)
    same = sum(
        set(pids[i].tolist()) == set(eids[i].tolist())
        for i in range(64)
    )
    assert same >= 62  # bucketed-scan recall on random data
    np.testing.assert_allclose(
        np.sort(pd2, 1), np.sort(ed2, 1), rtol=1e-3, atol=1e-5
    )
    # distances are exact f32 for whatever rows came back
    id_to_vec = {int(i): vecs[i] for i in range(len(vecs))}
    for qi in (0, 13, 63):
        true = float(
            np.sum((id_to_vec[int(pids[qi, 0])] - queries[qi]) ** 2)
        )
        assert abs(true - float(pd2[qi, 0])) < 1e-4

    # same epoch: the pack object is reused, not rebuilt
    pack1 = index._packed[1]
    index.knn(queries, k=5, packed=True)
    assert index._packed[1] is pack1

    # a mutation starts a new epoch: every row within the removed ball
    # is gone, so packed serving (exact f32 distances) can never return
    # a distance inside it
    radius = float(np.sqrt(ed2[0, 2]) + 1e-4)  # removes >= 3 rows
    gone = index.remove(queries[0], radius)
    assert gone >= 3
    _, d2_after = index.knn(queries[:1], k=5, packed=True)
    assert index._packed[1] is not pack1
    assert float(d2_after[0, 0]) > radius * radius - 1e-5

    # packed has no filtered path: explicit error, not silent fallback
    with pytest.raises(ValueError):
        index.knn(queries[:2], k=3, packed=True, allowed_ids=[1, 2])

def test_knn_exact_vs_oracle_under_mixed_churn():
    """Main+delta part serving (masked main scan + exact delta merge)
    must stay EXACT through interleaved adds and removals: top-k ids and
    distances equal a numpy oracle over the live rows at every step."""
    rng = np.random.default_rng(77)
    index = DynamicIndex(leaf_size=4, rebuild_fraction=10.0)  # no auto compaction
    live = {}
    ids = index.add(np.asarray(datasets.random_uniform(300, 5, seed=70)))
    for i, v in zip(ids, np.asarray(datasets.random_uniform(300, 5, seed=70))):
        live[int(i)] = v
    index.compact()
    queries = np.asarray(datasets.random_uniform(16, 5, seed=71))

    def oracle_knn(k):
        keys = np.asarray(sorted(live))
        mat = np.stack([live[int(i)] for i in keys])
        d2 = ((queries[:, None, :] - mat[None, :, :]) ** 2).sum(-1)
        order = np.argsort(d2, axis=1)[:, :k]
        return keys[order], np.take_along_axis(d2, order, 1)

    for step in range(4):
        # remove a couple of main rows by id, add a couple of fresh rows
        gone = [int(i) for i in list(live)[step * 2:step * 2 + 2]]
        assert index.remove_ids(gone) == len(gone)
        for g in gone:
            del live[g]
        fresh = rng.random((2, 5)).astype(np.float32) * 2 - 1
        for i, v in zip(index.add(fresh), fresh):
            live[int(i)] = v

        got_ids, got_d2 = index.knn(queries, k=5)
        want_ids, want_d2 = oracle_knn(5)
        np.testing.assert_allclose(got_d2, want_d2, rtol=1e-4, atol=1e-5)
        # sets per query (distance ties can reorder)
        for qi in range(queries.shape[0]):
            assert set(got_ids[qi].tolist()) == set(want_ids[qi].tolist())
        # dead ids never surface
        assert not (np.isin(got_ids, gone)).any()


def test_main_view_is_resident_matrix_and_mask_rides_removals():
    """The serve view must reuse the builder's matrix IN PLACE (no
    [main+delta] concat — the 10M OOM), with tombstones as a row mask
    instead of a host-gathered copy."""
    vecs = np.asarray(datasets.random_uniform(200, 4, seed=78))
    index = DynamicIndex(vecs, leaf_size=4, rebuild_fraction=10.0)
    mat, _, mask = index._main_view()
    assert mat is index._index.vectors and mask is None
    index.add(np.zeros((1, 4), np.float32))  # delta only: view survives
    assert index._main_view() is index._serve
    assert index._main_view()[0] is index._index.vectors
    index.remove_ids([0])
    mat2, ids2, mask2 = index._main_view()
    assert mat2 is index._index.vectors  # still no copy
    assert mask2 is not None and int(np.asarray(mask2).sum()) == 199


def test_packed_pack_survives_adds_and_sees_fresh_rows():
    """An add must NOT invalidate the pack (delta rows are merged
    exactly on top), while a removal must repack so dead rows can't be
    served."""
    vecs = np.asarray(datasets.random_uniform(2000, 8, seed=79))
    index = DynamicIndex(vecs, leaf_size=8, rebuild_fraction=10.0)
    queries = np.asarray(datasets.random_uniform(8, 8, seed=80))
    index.knn(queries, k=3, packed=True)
    pack1 = index._packed[1]

    target = np.full((1, 8), 0.123, np.float32)
    (tid,) = index.add(target)
    ids, d2 = index.knn(target, k=1, packed=True)
    assert index._packed[1] is pack1  # pack survived the add
    assert ids[0, 0] == tid and d2[0, 0] == 0.0  # fresh row visible, exact

    # delta growth stays inside the padded capacity: no new view shapes
    dmat, dids = index._delta_view()
    assert dmat.shape[0] == 64 and int((dids >= 0).sum()) == 1
    index.add(np.zeros((3, 8), np.float32))
    dmat2, _ = index._delta_view()
    assert dmat2.shape[0] == 64  # same compiled delta-merge shapes

    # removing the delta row hides it without touching the pack
    assert index.remove_ids([tid]) == 1
    assert index._packed[1] is pack1
    ids2, d22 = index.knn(target, k=1, packed=True)
    assert ids2[0, 0] != tid and d22[0, 0] > 0.0

    # a main-segment removal starts a new pack epoch
    index.remove_ids([0])
    index.knn(queries, k=3, packed=True)
    assert index._packed[1] is not pack1
    got, _ = index.knn(vecs[0:1], k=1, packed=True)
    assert got[0, 0] != 0


def test_knn_k_exceeding_live_rows_pads():
    index = DynamicIndex(np.eye(3, dtype=np.float32), leaf_size=2)
    index.remove_ids([1])
    ids, d2 = index.knn(np.zeros((1, 3), np.float32), k=4)
    assert (ids[0] >= 0).sum() == 2
    assert np.isinf(d2[0][ids[0] < 0]).all()
    assert 1 not in ids[0].tolist()


def test_packed_remove_epoch_shares_base_pack():
    """A removal must NOT rebuild the bf16 pack: the base pack is keyed
    on the compaction epoch and a tombstone epoch only swaps the norm
    row (mask_rows) — the vb/vectors buffers stay the SAME objects. A
    compact() starts a fresh base."""
    vecs = np.asarray(datasets.random_uniform(3000, 8, seed=85))
    index = DynamicIndex(vecs, leaf_size=8, rebuild_fraction=10.0)
    queries = np.asarray(datasets.random_uniform(8, 8, seed=86))

    index.knn(queries, k=3, packed=True)
    base_vb = index._packed_base[1].vb
    assert index._packed[1] is index._packed_base[1]  # unmasked epoch

    assert index.remove_ids([0, 1]) == 2
    ids, d2 = index.knn(queries, k=3, packed=True)
    assert index._packed_base[1].vb is base_vb  # no repack
    assert index._packed[1] is not index._packed_base[1]  # masked view
    assert index._packed[1].vb is base_vb  # ... sharing the blocks
    assert not np.isin(ids, [0, 1]).any()

    # removed rows stay out even as nearest neighbors
    got, gd2 = index.knn(vecs[0:1], k=1, packed=True)
    assert got[0, 0] != 0 and gd2[0, 0] > 0.0

    # exact distances on live results match brute force over live rows
    alive = np.ones(3000, bool)
    alive[[0, 1]] = False
    truth = ((vecs[alive] - queries[0]) ** 2).sum(1).min()
    np.testing.assert_allclose(d2[0, 0], truth, rtol=1e-5)

    index.compact()
    index.knn(queries, k=3, packed=True)
    assert index._packed_base[1].vb is not base_vb  # new epoch


def test_knn_packed_min_probe_batch_guard():
    """Pruning is a BATCH mode (probes calibrated at q=4096 collapse to
    0.39 recall at q=256 — docs/serving.md): min_probe_batch routes
    under-filled calls to the FULL packed scan. Verified by program
    accounting — the guarded call must reuse the full-scan program, not
    compile a pruned one."""
    import pytest

    from vector_database_tpu.ops.pallas_knn import pallas_scan_knn_packed
    from vector_database_tpu.utils import datasets

    # > one DMA block (auto block=8192) so probes=1 is a REAL pruning
    vecs = np.asarray(datasets.random_uniform(20000, 8, seed=421))
    index = DynamicIndex(vectors=vecs, leaf_size=16)
    queries = np.asarray(datasets.random_uniform(64, 8, seed=422))

    r_full, d_full = index.knn(queries, k=5, packed=True)
    assert index._packed[1].vb.shape[0] > 1  # multi-block pack
    base = pallas_scan_knn_packed._cache_size()

    # under-filled (64 < 128): guard strips probes -> the already
    # -compiled full program serves it, answers identical
    r_g, d_g = index.knn(
        queries, k=5, packed=True, probes=1, min_probe_batch=128
    )
    assert pallas_scan_knn_packed._cache_size() == base
    np.testing.assert_array_equal(r_g, r_full)
    np.testing.assert_array_equal(d_g, d_full)

    # filled (64 >= 32): the pruned program compiles and serves
    index.knn(queries, k=5, packed=True, probes=1, min_probe_batch=32)
    assert pallas_scan_knn_packed._cache_size() == base + 1

    with pytest.raises(ValueError, match="min_probe_batch"):
        index.knn(queries, k=5, packed=True, min_probe_batch=32)
