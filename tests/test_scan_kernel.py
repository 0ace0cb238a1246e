"""The GPU bucket-scan kernel (Pallas interpreter) against the plain XLA
scan, and the choice of scan route.

The kernel runs on the CPU only under ``interpret=True``; its compiled
form is checked on the card by ``chip_smoke.py`` (phase kernel_ref) and
by the ``gpu``-marked tests below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vector_database_tpu.ops import pallas_knn as pk
from vector_database_tpu.utils import datasets


def _scan_inputs(n, d, q, *, block, buckets, metric="l2", sentinels=0,
                 q_tile=16, probes=None, seed=0):
    rng = np.random.RandomState(seed)
    vecs = rng.rand(n, d).astype(np.float32) * 2 - 1
    if sentinels:
        vecs = np.concatenate(
            [vecs, np.full((sentinels, d), np.inf, np.float32)]
        )
    pack = pk.pack_database(
        vecs, block=block, buckets=buckets, metric=metric,
        rows_valid=n if sentinels else None,
    )
    queries = jnp.asarray(rng.rand(q, d).astype(np.float32) * 2 - 1)
    q_pad = -(-q // q_tile) * q_tile
    qp = jnp.pad(queries, ((0, q_pad - q), (0, pack.vb.shape[1] - d)))
    bmap = nprobe = None
    if probes is not None:
        nb = pack.vb.shape[0]
        qp, bmap, nprobe, _ = pk._select_blocks(
            pack, queries, qp, probes=nb, probes_rt=probes, q_tile=q_tile
        )
    return pack, queries, qp.astype(jnp.bfloat16), bmap, nprobe


CASES = {
    # D not a power of two (96 = 64 + 32), Q not a multiple of the tile
    "d96_ragged_q": dict(n=3000, d=96, q=70, block=512, buckets=128),
    # ragged last block plus +inf rerank sentinels (3e38 norm row)
    "ragged_block_sentinels": dict(n=1100, d=24, q=40, block=256,
                                   buckets=64, sentinels=150),
    # wide D: the _KC-chunk loop plus a 64 + 16 tail
    "wide_d_loop": dict(n=900, d=200, q=33, block=256, buckets=128),
    "metric_ip": dict(n=2000, d=32, q=20, block=512, buckets=256,
                      metric="ip"),
    "smallest_buckets": dict(n=700, d=16, q=17, block=64, buckets=16),
    "pruned_one": dict(n=4000, d=48, q=64, block=256, buckets=128,
                       probes=1),
    "pruned_mid": dict(n=4000, d=48, q=64, block=256, buckets=128,
                       probes=7),
    "pruned_all": dict(n=4000, d=48, q=64, block=256, buckets=128,
                       probes=16),
    "pruned_wide_d": dict(n=2000, d=160, q=48, block=256, buckets=64,
                          probes=3),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_kernel_matches_plain_scan(case):
    kw = dict(CASES[case])
    probes = kw.pop("probes", None)
    pack, queries, qb, bmap, nprobe = _scan_inputs(**kw, probes=probes)
    args = (pack.vn, pack.vb, qb, bmap, nprobe)
    scan_kw = dict(bits=pack.bits, m=pack.m, q_tile=16)
    ref = np.asarray(pk._scan_xla(*args, **scan_kw))
    got = np.asarray(pk._scan_triton(*args, interpret=True, **scan_kw))
    assert got.shape == ref.shape == (qb.shape[0], pack.m)
    tol = 2.0 ** -(23 - pack.bits)
    assert np.all(np.abs(got - ref) <= tol * np.abs(ref) + 1e-5)
    # the decoded block ids (low mantissa bits) agree exactly
    ids = lambda a: a.view(np.int32) & ((1 << pack.bits) - 1)  # noqa: E731
    assert np.array_equal(ids(got), ids(ref))

    # and the whole serving call agrees, rows and f32 distances
    serve_kw = dict(k=5, q_tile=16)
    if probes is not None:
        serve_kw.update(probes=probes, probes_max=pack.vb.shape[0])
        entry = lambda **i: pk.pallas_scan_knn_packed_rt(  # noqa: E731
            pack, queries, serve_kw["probes"], k=5, q_tile=16,
            probes_max=serve_kw["probes_max"], **i)
    else:
        entry = lambda **i: pk.pallas_scan_knn_packed(  # noqa: E731
            pack, queries, **serve_kw, **i)
    r_ref, d_ref = (np.asarray(a) for a in entry())
    r_got, d_got = (np.asarray(a) for a in entry(interpret=True))
    assert np.array_equal(r_ref, r_got)
    np.testing.assert_array_equal(d_ref, d_got)


def test_scan_route_by_platform():
    assert pk.scan_route("cpu") == "xla"
    assert pk.scan_route("gpu") == "triton"
    assert pk.scan_route() == "xla"  # the tests run on the CPU backend
    for other in ("rocm", "metal", "xpu"):
        with pytest.raises(ValueError, match=other):
            pk.scan_route(other)


def test_interpret_never_set_implicitly(monkeypatch):
    """No entry point turns the interpreter on by itself: on the CPU the
    default call takes the XLA route, and a forced GPU route gets
    ``interpret=False``."""
    from vector_database_tpu import PackedServer
    from vector_database_tpu.parallel import make_mesh, pack_database_sharded
    from vector_database_tpu.parallel.scan import sharded_scan_knn

    calls = []
    real = pk._scan_triton

    def spy(*a, interpret, **k):
        calls.append(interpret)
        return real(*a, interpret=True, **k)

    monkeypatch.setattr(pk, "_scan_triton", spy)
    vecs = datasets.random_uniform(600, 16, seed=3)
    queries = vecs[:20]
    pack = pk.pack_database(vecs, block=128, buckets=64)
    pk.pallas_scan_knn_packed(pack, queries, k=3, q_tile=16)
    PackedServer(pack, k=3, batch=32).query(queries)
    assert calls == []  # CPU: plain XLA scan, no kernel at all

    monkeypatch.setattr(pk, "scan_route", lambda platform=None: "triton")
    jax.clear_caches()
    pk.pallas_scan_knn_packed(pack, queries, k=3, q_tile=32)
    PackedServer(pack, k=3, batch=48, probes=2).query(queries)
    sdb = pack_database_sharded(vecs, make_mesh(2), block=128, buckets=64)
    sharded_scan_knn(sdb, queries, k=3, q_tile=32)
    jax.clear_caches()
    assert calls and not any(calls)


def test_kernel_rejects_shapes_it_cannot_tile():
    pack, _, qb, _, _ = _scan_inputs(500, 16, 16, block=64, buckets=8)
    with pytest.raises(ValueError, match="multiples of 16"):
        pk._scan_triton(pack.vn, pack.vb, qb, None, None, bits=pack.bits,
                        m=pack.m, q_tile=16, interpret=True)
    pack, queries, qb, bmap, npr = _scan_inputs(
        900, 16, 16, block=128, buckets=64, q_tile=8, probes=2)
    with pytest.raises(ValueError, match="q_tile"):
        pk._scan_triton(pack.vn, pack.vb, qb, bmap, npr, bits=pack.bits,
                        m=pack.m, q_tile=8, interpret=True)


def test_kernel_accepts_packs_over_2_31_elements():
    """A pack past 2^31 bf16 elements (10M x 768: 1,221 blocks) goes to
    the kernel whole; its compiled form is checked at 3M x 768 by
    ``chip_smoke.py``. Traced abstractly, so nothing is allocated."""
    nb, d_pad, block, q = 1221, 768, 8192, 512
    assert nb * d_pad * block > 2**31
    sds = jax.ShapeDtypeStruct
    out = jax.eval_shape(
        lambda vn, vb, qb: pk._scan_triton(
            vn, vb, qb, None, None, bits=11, m=4096, q_tile=q,
            interpret=False),
        sds((nb, 1, block), jnp.float32),
        sds((nb, d_pad, block), jnp.bfloat16),
        sds((q, d_pad), jnp.bfloat16),
    )
    assert (out.shape, out.dtype) == ((q, 4096), jnp.float32)


def test_d_chunks_and_d_align():
    assert pk._d_chunks(96) == ((0, 64), (64, 32))
    assert pk._d_chunks(16) == ((0, 16),)
    assert pk._d_chunks(208) == ((0, 128), (128, 64), (192, 16))
    assert pk._d_chunks(768) == tuple((i * 128, 128) for i in range(6))
    assert pk._pow2_divisor(4096, 64) == 64
    assert pk._pow2_divisor(48, 128) == 16
    vecs = datasets.random_uniform(100, 12, seed=4)
    assert pk.pack_database(vecs, block=64, buckets=64).vb.shape[1] == 16
    with pytest.raises(ValueError, match="d_align"):
        pk.pack_database(vecs, block=64, buckets=64, d_align=8)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_scan_on_gpu(gpu):
    """On the card: the compiled kernel against the plain XLA scan at a
    moderate width (chip_smoke.py checks the full widths)."""
    pack, _, qb, _, _ = _scan_inputs(200_000, 96, 512, block=8192,
                                     buckets=4096)
    args = (pack.vn, pack.vb, qb, None, None)
    kw = dict(bits=pack.bits, m=pack.m, q_tile=512)
    ref = np.asarray(pk._scan_xla(*args, **kw))
    got = np.asarray(pk._scan_triton(*args, interpret=False, **kw))
    tol = 2.0 ** -(23 - pack.bits)
    assert np.all(np.abs(got - ref) <= tol * np.abs(ref) + 1e-5)


@pytest.mark.gpu
def test_gpu_route_is_the_kernel(gpu):
    assert pk.scan_route() == "triton"
