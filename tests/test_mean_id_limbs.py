"""Exact mean-id tie statistics beyond 16M rows.

The reference keeps segment id sums in an Int128 (Stats.cs:26) — uncapped.
This engine keeps them in base-2^b int32 limb sums; a fixed b=7 is valid
to ~16M rows. ``id_limb_plan`` narrows b with n, so the
machinery is exact for any int32-indexable dataset. These tests prove the
narrow-limb arithmetic exact directly (big-int oracle) and prove a narrow
plan builds the IDENTICAL tree to the default plan.
"""

import numpy as np
import pytest

from vector_database_tpu.ops.sorted_build import (
    _exact_mean_id,
    id_limb_plan,
    segment_capacity,
    sorted_build,
)


def test_id_limb_plan_bounds():
    assert id_limb_plan(1000) == (7, 5)
    assert id_limb_plan(16_000_000) == (7, 5)
    bits, limbs = id_limb_plan(17_000_000)
    assert bits < 7 and bits * limbs >= 31
    bits, limbs = id_limb_plan(100_000_000)  # the flagship scale
    assert (100_000_000 << bits) < 2**31
    assert bits * limbs >= 31
    bits, limbs = id_limb_plan(2**30 - 1)
    assert bits == 1 and limbs == 31
    with pytest.raises(ValueError):
        id_limb_plan(2**30)


@pytest.mark.parametrize("bits", [1, 2, 4, 7])
def test_exact_mean_id_bigint_oracle(bits):
    """floor(sum/cnt) from limb sums == Python big-int division, for ids
    up to 2^31 (the id range of a ~1B-row build)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(bits)
    limbs = -(-31 // bits)
    mask = (1 << bits) - 1
    segs = []
    for _ in range(64):
        cnt = rng.randint(1, 50)
        ids = rng.randint(0, 2**31 - 1, size=cnt, dtype=np.int64)
        segs.append(ids)
    limb_sums = [
        jnp.asarray(
            [int(((ids >> (bits * l)) & mask).sum()) for ids in segs],
            jnp.int32,
        )
        for l in range(limbs)
    ]
    cnt = jnp.asarray([len(ids) for ids in segs], jnp.int32)
    got = np.asarray(_exact_mean_id(limb_sums, cnt, bits))
    want = np.asarray(
        [int(ids.sum()) // len(ids) for ids in segs], np.int64
    )
    assert got.tolist() == want.tolist()


def test_narrow_limbs_build_identical_tree():
    """The same duplicate-heavy build with a forced 2-bit limb plan (the
    >500M-row regime's arithmetic) produces a bit-identical tree to the
    default 7-bit plan."""
    rng = np.random.RandomState(77)
    vecs = np.repeat(
        rng.randint(-3, 4, size=(101, 6)).astype(np.float32), 4, axis=0
    )
    n = vecs.shape[0]
    ids = np.arange(n, dtype=np.int32)
    common = dict(
        s_max=segment_capacity(n, 2), m_max=2 * n, leaf_size=2,
        max_levels=n + 64, stats_subsample=1, tie_break="mean_id",
    )
    import jax.numpy as jnp

    r_def = sorted_build(jnp.asarray(vecs), jnp.asarray(ids),
                         jnp.int32(n), **common)
    r_narrow = sorted_build(jnp.asarray(vecs), jnp.asarray(ids),
                            jnp.int32(n), **common,
                            id_limb_bits=2, id_limbs=16)
    total = int(r_def[8])
    assert total == int(r_narrow[8])
    for a, b, name in zip(r_def[:8], r_narrow[:8],
                          ("dim", "mid", "low", "high", "ls", "lc",
                           "pid", "pvec")):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=name
        )


def test_mean_id_no_longer_capped():
    """The 16M guard is gone: a >16M mean_id build request passes
    argument validation (the plan narrows instead of raising)."""
    from vector_database_tpu.builder import build_index_fused

    # n=17M would be slow on CPU; assert the plan path alone
    assert id_limb_plan(17_000_000)[0] < 7
    # and the tiny end-to-end still works through the public entry
    vecs = np.repeat(np.eye(4, dtype=np.float32), 3, axis=0)
    idx = build_index_fused(vecs, leaf_size=1, tie_break="mean_id")
    assert idx.n == 12
