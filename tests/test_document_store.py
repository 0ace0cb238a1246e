"""DocumentStore tests — the SQL-layer workflow (create doc -> add texts ->
index -> search -> reindex -> persist), validated against brute force."""

import numpy as np

from vector_database_tpu.document_store import DocumentStore
from vector_database_tpu.utils import datasets


def brute(vectors, point, domain):
    d2 = np.sum((np.stack(vectors) - np.asarray(point)) ** 2, axis=1)
    return set(np.nonzero(d2 <= domain * domain)[0].tolist())


def make_store(n=300, d=8, docs=2, seed=50):
    store = DocumentStore(leaf_size=4)
    all_vecs = {}
    for k in range(docs):
        doc = store.create_document(f"doc{k}")
        vecs = datasets.random_uniform(n, d, seed=seed + k)
        tids = [
            store.add_text(doc, vecs[i], text=f"t{k}-{i}")
            for i in range(n)
        ]
        store.index_document(doc)
        all_vecs[doc] = (vecs, tids)
    return store, all_vecs


def test_search_single_doc_exact():
    store, data = make_store()
    doc = next(iter(data))
    vecs, tids = data[doc]
    point = vecs[5]
    hits = store.search(point, 0.5, doc_id=doc)
    want = brute(list(vecs), point, 0.5)
    got = {tids.index(t) for (_, t, _) in hits}
    assert got == want
    assert all(d == doc for (d, _, _) in hits)


def test_search_all_docs():
    store, data = make_store()
    point = np.zeros(8, np.float32)
    hits = store.search(point, 0.6)
    for doc, (vecs, tids) in data.items():
        want = brute(list(vecs), point, 0.6)
        got = {tids.index(t) for (d, t, _) in hits if d == doc}
        assert got == want


def test_candidate_superset_mode():
    store, data = make_store(docs=1)
    doc = next(iter(data))
    vecs, tids = data[doc]
    point = vecs[0]
    exact = {t for (_, t, _) in store.search(point, 0.4, doc_id=doc)}
    cand = {t for (_, t, _) in store.search(
        point, 0.4, doc_id=doc, exact=False
    )}
    assert exact <= cand  # superset contract (README.md:72)


def test_reindex_after_update():
    store = DocumentStore()
    doc = store.create_document("d")
    t1 = store.add_text(doc, np.array([0.1, 0.1], np.float32), "a")
    store.index_document(doc)
    assert store.search([0.1, 0.1], 0.01) == [(doc, t1, 0.0)]
    t2 = store.add_text(doc, np.array([0.5, 0.5], np.float32), "b")
    # dirty doc is auto-reindexed on search
    hits = store.search([0.5, 0.5], 0.01)
    assert [(h[0], h[1]) for h in hits] == [(doc, t2)]


def test_delete_document_cascades():
    store, data = make_store(n=50, docs=2)
    doc = next(iter(data))
    store.delete_document(doc)
    assert all(d != doc for (d, _, _) in store.search(np.zeros(8), 10.0))
    assert len(store.documents) == 1


def test_emptied_store_accepts_new_width():
    """Deleting the last vectors must reset the store-wide width check —
    an emptied store is not forever bound to its first vector shape."""
    store = DocumentStore(leaf_size=4)
    d1 = store.create_document("a")
    store.add_text(d1, np.ones(3, np.float32))
    store.delete_document(d1)
    d2 = store.create_document("b")
    store.add_text(d2, np.ones(5, np.float32))  # must not raise
    assert store._dims == (5,)


def test_doc_slice_cache_bounded():
    """The per-doc serving cache must stay LRU-bounded: unbounded it
    would pin a second full copy of the store matrix in device memory."""
    store = DocumentStore(leaf_size=4)
    docs = []
    for i in range(6):
        doc = store.create_document(f"d{i}")
        vecs = datasets.random_uniform(20, 4, seed=60 + i)
        for v in vecs:
            store.add_text(doc, v)
        docs.append((doc, np.asarray(vecs)))
    q = np.zeros((2, 4), np.float32)
    for doc, _ in docs:
        store.knn_batch(q, k=3, doc_id=doc)
    assert len(store._doc_slice) <= store._doc_slice_cap
    # cached docs still serve correctly after evictions
    for doc, vecs in docs:
        ids, texts, d2 = store.knn_batch(vecs[[7]], k=1, doc_id=doc)
        assert ids[0, 0] == doc and d2[0, 0] < 1e-6


def test_save_load_roundtrip(tmp_path):
    store, data = make_store(n=100, docs=2)
    path = str(tmp_path / "store")
    store.save(path)
    loaded = DocumentStore.load(path)
    assert loaded._dims == (8,)  # width check survives the round-trip
    point = np.zeros(8, np.float32)
    a = sorted((d, t) for (d, t, _) in store.search(point, 0.6))
    b = sorted((d, t) for (d, t, _) in loaded.search(point, 0.6))
    assert a == b
    doc = next(iter(data))
    text, vec = loaded.get_text(doc, data[doc][1][7])
    assert text == f"doc{'0' if doc == 1 else '1'}-7".replace("doc", "t")


def test_empty_document():
    store = DocumentStore()
    doc = store.create_document("empty")
    store.index_document(doc)
    assert store.search(np.zeros(4), 1.0, doc_id=doc) == []


def test_incremental_combined_view():
    """A mutation must not trigger an O(store)
    combined rebuild — new rows join an exact-scanned delta; results stay
    exact; the rebuild fires only past the delta threshold."""
    store, data = make_store(n=120, docs=2)
    q = np.asarray(datasets.random_uniform(3, 8, seed=90))
    store.search_batch(q, 0.5)  # builds the combined view once
    assert store.combined_builds == 1

    doc = next(iter(data))
    new_vec = np.full(8, 0.123, np.float32)
    tid = store.add_text(doc, new_vec, text="late")
    # no rebuild on mutation...
    res = store.search_batch(new_vec[None], 0.01)
    assert store.combined_builds == 1
    assert (doc, tid) in [(d, t) for d, t, _ in res[0]]

    # ...knn_batch merges the delta row exactly at rank 0
    docs, texts, d2 = store.knn_batch(new_vec[None], k=3)
    assert docs[0, 0] == doc and texts[0, 0] == tid
    assert d2[0, 0] <= 1e-6
    assert store.combined_builds == 1

    # doc filter still honored against delta rows
    other = [d for d in data if d != doc][0]
    docs, texts, _ = store.knn_batch(new_vec[None], k=3, doc_id=other)
    assert (docs[0] != doc).all()

    # oracle equality with the delta in play
    all_rows = []
    for dd, (vecs, tids) in data.items():
        all_rows.extend((dd, t, v) for t, v in zip(tids, np.asarray(vecs)))
    all_rows.append((doc, tid, new_vec))
    point = np.asarray(q[0])
    want = sorted(
        (dd, t) for dd, t, v in all_rows
        if np.sum((v - point) ** 2) <= 0.5 * 0.5
    )
    got = sorted((dd, t) for dd, t, _ in store.search_batch(point[None], 0.5)[0])
    assert got == want

    # past the threshold (25% of main) the rebuild fires exactly once
    for i in range(80):
        store.add_text(doc, np.full(8, 0.2 + i * 1e-3, np.float32))
    store.search_batch(q, 0.5)
    assert store.combined_builds == 2


def test_knn_batch_doc_entirely_in_delta():
    """A document created after the last combined build lives wholly in
    the delta: knn_batch(doc_id=...) must serve it from the delta merge
    (regression: empty main-scan selection raised IndexError)."""
    store = DocumentStore()
    a = store.create_document("a")
    for i in range(4):
        store.add_text(a, [float(i), 0.0], text_id=100 + i)
    # force the combined build
    store.search_batch([[0.0, 0.0]], 10.0)
    b = store.create_document("b")
    tb = store.add_text(b, [9.0, 9.0])
    docs, texts, d2 = store.knn_batch([[9.1, 9.0]], k=3, doc_id=b)
    assert docs[0, 0] == b and texts[0, 0] == tb
    assert abs(d2[0, 0] - 0.01) < 1e-5
    assert (docs[0, 1:] == -1).all()
    # the whole-store path still sees both documents
    docs_all, _, _ = store.knn_batch([[9.1, 9.0]], k=1)
    assert docs_all[0, 0] == b


def test_cross_document_dim_mismatch_raises():
    """A vector whose width disagrees with the STORE (not just its own
    document) must fail at add_text, not as a cryptic concatenate error
    at first combined query (regression)."""
    import pytest

    store = DocumentStore()
    a = store.create_document("a")
    store.add_text(a, [1.0, 2.0, 3.0])
    b = store.create_document("b")
    with pytest.raises(ValueError):
        store.add_text(b, [1.0, 2.0])


def test_knn_batch_packed_matches_scan_and_sees_delta():
    """knn_batch(packed=True): kernel-rate store-wide serving equals the
    exact scan on separable data, the pack is cached per combined
    rebuild, fresh delta writes stay visible, and doc_id + packed is an
    explicit error."""
    import pytest

    from vector_database_tpu.utils import datasets

    vecs = np.asarray(datasets.random_uniform(600, 10, seed=500))
    store = DocumentStore()
    docs = [store.create_document(f"d{i}") for i in range(3)]
    for i, v in enumerate(vecs):
        store.add_text(docs[i % 3], v, text_id=1000 + i)

    q = np.asarray(datasets.random_uniform(32, 10, seed=501))
    ed, et, ed2 = store.knn_batch(q, k=4)
    pd_, pt, pd2 = store.knn_batch(q, k=4, packed=True)
    same = sum(
        set(pt[i].tolist()) == set(et[i].tolist()) for i in range(32)
    )
    assert same >= 30  # bucketed-scan recall on random data
    np.testing.assert_allclose(
        np.sort(pd2, 1), np.sort(ed2, 1), rtol=1e-3, atol=1e-5
    )

    # cached per combined rebuild
    pack1 = store._packed_store[1]
    store.knn_batch(q, k=4, packed=True)
    assert store._packed_store[1] is pack1

    # a fresh write lands in the delta and must be served immediately
    # (delta merge rides on top of the packed shortlist)
    tb = store.add_text(docs[0], q[0] + 0.001)
    d_, t_, dd2 = store.knn_batch(q[:1], k=4, packed=True)
    assert t_[0, 0] == tb and d_[0, 0] == docs[0]
    assert dd2[0, 0] < 1e-4

    with pytest.raises(ValueError):
        store.knn_batch(q[:1], k=2, doc_id=docs[0], packed=True)


def test_knn_batch_min_probe_batch_guard():
    """Pruning is a BATCH mode (docs/serving.md: probes tuned at q=4096
    collapse to 0.39 recall at q=256): min_probe_batch routes
    under-filled batches to the FULL packed scan — answers identical to
    packed=True without probes."""
    import pytest

    from vector_database_tpu.utils import datasets

    vecs = np.asarray(datasets.random_uniform(600, 10, seed=502))
    store = DocumentStore()
    doc = store.create_document("d")
    for i, v in enumerate(vecs):
        store.add_text(doc, v, text_id=2000 + i)

    q = np.asarray(datasets.random_uniform(16, 10, seed=503))
    fd, ft, fd2 = store.knn_batch(q, k=4, packed=True)
    gd, gt, gd2 = store.knn_batch(
        q, k=4, packed=True, probes=1, min_probe_batch=64
    )
    np.testing.assert_array_equal(gt, ft)
    np.testing.assert_array_equal(gd2, fd2)

    with pytest.raises(ValueError, match="min_probe_batch"):
        store.knn_batch(q, k=4, packed=True, min_probe_batch=64)
