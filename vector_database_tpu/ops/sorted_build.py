"""Sorted-segment fused build — the speed-of-light path.

The scatter-based level step (``ops/level.py``) is correct but XLA lowers
every ``segment_sum`` scatter-add to a full [N]-key sort plus [N, D]-sized
layout-conversion copies — per level. This module removes every scatter over
[N, D] by maintaining one invariant:

    **rows are stored segment-contiguous at every level.**

With contiguous segments (``seg_start``/``seg_count`` small arrays):

- per-segment sums/sum-of-squares are *prefix-sum differences* at segment
  boundaries (D-chunked ``cumsum`` + tiny boundary gathers) — no scatter;
- retired (leaf) ranges simply stop being referenced; their rows keep their
  position, so the final layout is *already* leaf-major — the entire
  finalize step (10M-row argsort + gather) disappears; each leaf's
  ``(start, count)`` is recorded the moment it retires, matching the
  reference's bump-allocated store regions (FileRangeStore.cs:127-165);
- the per-level stable partition moves rows only *within* their parent
  range: destinations come from a running count of lows (one int cumsum),
  and the single remaining scatter is the [N] int32 permutation inversion
  (unique indices).

**Sharded (multi-chip) form**: with ``axis_name`` set the same program runs
inside ``shard_map`` over a row-sharded matrix. The invariant weakens to
*per-shard* segment contiguity: every live segment owns one contiguous run
on every shard (possibly empty), and the global segment is the union. Each
level then needs only

- ``psum`` of the [S, D-chunk] boundary-difference moments (the same
  collective shape as the reference-free distributed design in
  SURVEY.md §2.2: per-dimension partial (n, Σ, Σx²) stats),
- ``psum`` of the [S] split-column sums and low-counts, and
- one [P, S] ``all_gather`` of segment counts for cross-shard *positional
  ranks* (the tie-break needs each row's global rank inside its segment;
  a shard's rows form one contiguous rank block, so an exclusive
  cumsum over the shard axis is enough).

Rows never cross shards; the partition stays purely local. Node tables come
out replicated (every collective result is identical on all shards); leaf
runs come out per-shard. This is what builds ONE global tree over a dataset
larger than any single chip's HBM — the reference's defining capability
(README.md:91-100, FileRangeStore.cs:18-43), re-created with XLA
collectives instead of a memory-mapped temp file.

Tie-break deviation (documented): rows exactly on the split plane — and
whole degenerate/zero-variance segments (DDL.sql:100) — are split by their
*positional rank* inside the segment instead of the reference's mean-id rule
(IndexBuilder.cs:113-123). Both are deterministic ~half splits of the tied
set; positional rank is exact with zero extra passes (and a pure positional
split moves no rows at all). Tie handling affects tree shape only, never the
search contract. Pass ``tie_break="mean_id"`` for exact reference parity:
segment id-sums are computed exactly (base-2^b limb cumsums + long
division — 7-bit limbs to ~16M rows, narrowing automatically to 1-bit at
~1B, see ``id_limb_plan`` — the int32 equivalent of the reference's
Int128 ``Stats.IdN``, Stats.cs:26) and plane ties compare
``id > floor(sum_ids / count)`` (IndexBuilder.cs:113-123, DDL.sql:100-110).

Same node-table semantics as the host-loop builder's interface: one
``lax.while_loop`` under one jit, one compile per (n, d, leaf_size).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_ID_LIMB_BITS = 7  # default: n * 2^7 < 2^31 for n up to ~16.7M
_ID_LIMBS = 5      # default: covers ids < 2^35


def id_limb_plan(n_total: int) -> tuple:
    """(bits per limb, limb count) for exact id sums over ``n_total``
    rows in int32 arithmetic.

    Two int32 constraints pick the widest safe limb: every per-segment
    limb sum stays below 2^31 (``n_total * (2^bits - 1)``), and the long
    -division accumulator ``r * 2^bits + digit`` with ``r < cnt <=
    n_total`` stays below 2^31 (``n_total * 2^bits``). 7-bit limbs to
    ~16.7M rows, narrowing to 1-bit limbs at ~1.07B — any int32-id
    dataset. This is what lifts a 16M-row cap on
    ``tie_break="mean_id"`` (the reference's Int128 ``IdN``, Stats.cs:26,
    is uncapped): narrower limbs just add [N]-int cumsum passes per
    level, only in mean-id mode.
    """
    bits = _ID_LIMB_BITS
    while bits > 1 and (n_total << bits) >= 2**31:
        bits -= 1
    if (n_total << bits) >= 2**31:
        raise ValueError(
            "mean_id tie-break supports at most 2^30 - 1 rows (int32 "
            "ids); use positional ties beyond that"
        )
    limbs = -(-31 // bits)  # ids < 2^31
    return bits, limbs


def segment_capacity(n: int, leaf_size: int) -> int:
    """Static bound on live segments in any level: children of internal
    ranges only, and an internal range holds at least ``leaf_size + 1``
    points (``n`` is the GLOBAL row count for sharded builds)."""
    return max(2, 2 * (n // (leaf_size + 1)))


def _exact_mean_id(limb_sums, cnt, bits=_ID_LIMB_BITS):
    """floor(sum_ids / cnt) per segment, exactly, from base-2^bits limb
    sums.

    ``limb_sums[l]`` = Σ over the segment of ``(id >> bits*l) & mask``
    (each < 2^31 by the ``id_limb_plan`` bound). Normalizes the limbs
    into base-2^bits digits, then long-divides by ``cnt`` high-to-low
    with an int32 remainder (``r < cnt`` keeps ``r * 2^bits + digit`` in
    range, same bound) — the same result as the reference's Int128 mean
    (Stats.cs:26) with no wide integers.
    """
    base = 1 << bits
    mask = base - 1
    # normalize: propagate carries so every digit < 2^bits
    digits = []
    carry = jnp.zeros_like(limb_sums[0])
    for l in range(len(limb_sums)):
        v = limb_sums[l] + carry
        digits.append(v & mask)
        carry = v >> bits
    # leftover carry still needs digits: carry < 2^(32-bits)
    for _ in range(-(-32 // bits)):
        digits.append(carry & mask)
        carry = carry >> bits
    cnt_safe = jnp.maximum(cnt, 1)
    q = jnp.zeros_like(cnt)
    r = jnp.zeros_like(cnt)
    for dgt in reversed(digits):
        acc = r * base + dgt
        qd = acc // cnt_safe
        r = acc - qd * cnt_safe
        q = q * base + qd
    return q


def _sorted_build_impl(
    vectors: jax.Array,  # [N, D] float32 (local shard rows when sharded)
    row_ids: jax.Array,  # [N] int32 original (global) row of each position
    n_valid: jax.Array,  # int32 scalar: leading rows that are real (≤ N)
    *,
    s_max: int,
    m_max: int,
    leaf_size: int,
    max_levels: int,
    d_chunk: int = 128,
    stats_subsample: int = 1,
    axis_name: str | None = None,
    tie_break: str = "positional",
    progress_cb=None,
    split: str = "alternate",
    id_limb_bits: int = _ID_LIMB_BITS,
    id_limbs: int = _ID_LIMBS,
):
    """Run the full level-synchronous build on device, scatter-free.

    Returns ``(dim, mid, low, high, leaf_start, leaf_count, perm_rows,
    sorted_vectors, total_nodes, depth)``: node arrays sized ``[m_max]``
    (caller slices to ``total_nodes``), ``sorted_vectors`` in final
    leaf-major order and ``perm_rows[i]`` = original row stored at
    position ``i``. When ``axis_name`` is set (inside ``shard_map``),
    node arrays are replicated and ``leaf_start``/``leaf_count``/
    ``sorted_vectors``/``perm_rows`` are the shard-local pieces.
    """
    n, d = vectors.shape
    pos = jnp.arange(n, dtype=jnp.int32)
    sidx = jnp.arange(s_max, dtype=jnp.int32)
    mean_id_ties = tie_break == "mean_id"

    if axis_name is None:
        psum = lambda x: x
        vary = lambda x: x
        ex_counts = lambda cnt: jnp.zeros_like(cnt)
    else:
        psum = lambda x: jax.lax.psum(x, axis_name)

        def vary(x):
            # mark device-varying for the while-loop carry; idempotent
            # (the cast rejects already-varying values)
            if axis_name in getattr(jax.typeof(x), "vma", frozenset()):
                return x
            return jax.lax.pcast(x, axis_name, to="varying")

        def ex_counts(cnt):
            # exclusive prefix over the shard axis: this shard's rows of a
            # segment occupy global ranks [ex, ex + local_cnt)
            allc = jax.lax.all_gather(cnt, axis_name)  # [P, S]
            excl = jnp.cumsum(allc, axis=0) - allc
            return excl[jax.lax.axis_index(axis_name)]

    init_local = tuple(
        vary(x)
        for x in (
            vectors,  # pvec: segment-contiguous rows (shard-local)
            row_ids,  # pid: original global row per position
            jnp.where(pos < n_valid, 0, -1).astype(jnp.int32),  # pseg
            jnp.full((n,), -1, jnp.int32),  # pleaf: node id once retired
            jnp.zeros((s_max,), jnp.int32),  # seg_start (local)
            jnp.zeros((s_max,), jnp.int32).at[0].set(n_valid),  # seg_count
            # Node arrays carry s_max slack so the per-level emission is a
            # dynamic_update_slice WINDOW write at node_base (scatters with
            # computed indices can lower to per-level [s_max]-key
            # sorts). Lanes past a level's live segments write garbage into
            # slots a LATER level owns and overwrites first (windows only
            # extend forward; slot t's owner is the last level whose
            # window covers t), and the slack guarantees the window never
            # clamps. Callers slice [:total_nodes].
            jnp.zeros((m_max + s_max,), jnp.int32),  # node leaf_start
            jnp.zeros((m_max + s_max,), jnp.int32),  # node leaf_count
        )
    )
    init_rep = (
        jnp.full((m_max + s_max,), -1, jnp.int32),  # node dim
        jnp.zeros((m_max + s_max,), jnp.float32),  # node mid
        jnp.full((m_max + s_max,), -1, jnp.int32),  # node low
        jnp.full((m_max + s_max,), -1, jnp.int32),  # node high
        jnp.int32(0),  # node_base
        jnp.int32(1),  # live segments
        jnp.asarray(True),  # use_max
        jnp.int32(0),  # level
    )
    init = init_local + init_rep

    def cond(st):
        return (st[13] > 0) & (st[15] < max_levels)

    def body(st):
        (pvec, pid, pseg, pleaf, seg_start, seg_cnt, nls, nlc,
         nd, nm, nl, nh, node_base, s_live, use_max, level) = st

        active = pseg >= 0
        ps = jnp.where(active, pseg, 0)
        ends = seg_start + seg_cnt
        g_cnt = psum(seg_cnt)  # global per-segment count

        if progress_cb is not None:
            # streamed progress for the one-compile build: the reference's
            # throttled console log (IndexBuilder.cs:43-53) as a host
            # callback — (level, live_segments, active_rows), fired once
            # per level from inside the while_loop
            jax.debug.callback(
                progress_cb, level, s_live,
                jnp.sum(jnp.where(sidx < s_live, g_cnt, 0)),
            )

        # --- phase 1: split-dimension selection from (optionally
        # subsampled) segment moments, via prefix-sum differences.
        # Retired ranges lie wholly outside every live [start, end), so the
        # prefix difference never sees them — no masking pass needed.
        # Subsampling (every k-th row) only affects the *ranking* of
        # dimensions by variance; the split plane itself is computed
        # exactly in phase 2, and mis-rankings merely shift balance.
        k = stats_subsample
        xs = pvec[::k]
        ns = xs.shape[0]
        n_before = lambda idx: (idx + (k - 1)) // k  # samples before idx

        def boundary_diff(prefix, idx_lo, idx_hi):  # [ns, c] -> [S, c]
            def at(idx):
                c = n_before(idx)
                v = prefix[jnp.clip(c - 1, 0, ns - 1)]
                return jnp.where((c > 0)[:, None], v, 0.0)

            return at(idx_hi) - at(idx_lo)

        # Keep each cumsum at natural width, never concatenate x with x²,
        # and force the prefix transients to be *sequential* with an
        # optimization barrier so each one dies before the next allocates.
        sums_c, sumsq_c = [], []
        gate = xs
        for c0 in range(0, d, d_chunk):
            xc = gate[:, c0 : c0 + d_chunk]
            s = boundary_diff(jnp.cumsum(xc, axis=0), seg_start, ends)
            s, gate = jax.lax.optimization_barrier((s, gate))
            xc = gate[:, c0 : c0 + d_chunk]
            q = boundary_diff(
                jnp.cumsum(xc * xc, axis=0), seg_start, ends
            )
            q, gate = jax.lax.optimization_barrier((q, gate))
            sums_c.append(s)
            sumsq_c.append(q)
        sums = jnp.concatenate(sums_c, axis=1) if len(sums_c) > 1 \
            else sums_c[0]  # [S, D] local
        sumsq = jnp.concatenate(sumsq_c, axis=1) if len(sumsq_c) > 1 \
            else sumsq_c[0]
        sums = psum(sums)
        sumsq = psum(sumsq)

        cnt_f = jnp.maximum(g_cnt, 1).astype(jnp.float32)
        cnt_sub = psum(n_before(ends) - n_before(seg_start))
        cnt_sub_f = jnp.maximum(cnt_sub, 1).astype(jnp.float32)
        mean_sub = sums / cnt_sub_f[:, None]
        m2 = jnp.maximum(sumsq - cnt_sub_f[:, None] * mean_sub * mean_sub,
                         0.0)

        # Split dimension: alternating max/min variance by level parity
        # (IndexBuilder.cs:75-79, DDL.sql:151); first occurrence on ties.
        split_dim = jnp.where(
            use_max, jnp.argmax(m2, axis=1), jnp.argmin(m2, axis=1)
        ).astype(jnp.int32)
        take = lambda a: jnp.take_along_axis(a, split_dim[:, None], 1)[:, 0]
        degenerate = (take(m2) == 0.0) | (cnt_sub == 0)

        live = sidx < s_live
        last = level >= max_levels - 1
        is_int = live & (g_cnt > leaf_size) & ~last

        ex_cnt = ex_counts(seg_cnt)  # global rank offset of local rows

        # Optional reference-parity tie statistic: exact per-segment
        # mean id via base-2^bits limb cumsums (each limb's prefix stays
        # within int32 by the id_limb_plan bound — the caller narrows
        # the limbs as n grows) + exact long division — the Int128
        # ``IdN`` of Stats.cs:26, uncapped.
        if mean_id_ties:
            limb_mask = (1 << id_limb_bits) - 1
            pid_active = jnp.where(active, pid, 0)
            # Boundary limb prefixes via a stacked block table
            # (probe_meanid.py): the cost of the naive form is not the [N]
            # cumsums but the 2*limbs scalar boundary-gather passes. Instead: per-limb
            # block sums over 8-row blocks + [nb] cumsums, packed BESIDE
            # the raw id blocks into ONE [nb+1, 8+limbs] table, so each
            # boundary set costs two row-gathers total (per the measured
            # rule that a [S, k] row-gather prices like one scalar
            # gather). Row 0 is all-zero so idx == 0 needs no clamp;
            # intra-block remainders come from the raw block row masked
            # to the first ``ri`` ids.
            blk = 8
            nblk = -(-n // blk)
            pb = jnp.pad(pid_active, (0, nblk * blk - n)).reshape(
                nblk, blk
            )
            pref_cols = []
            for l in range(id_limbs):
                bs = jnp.sum(
                    ((pb >> (id_limb_bits * l)) & limb_mask).astype(
                        jnp.int32
                    ),
                    axis=1,
                )
                pref_cols.append(
                    jnp.concatenate(
                        [jnp.zeros(1, jnp.int32), jnp.cumsum(bs)]
                    )
                )
            limb_table = jnp.concatenate(
                [jnp.pad(pb, ((1, 0), (0, 0))),
                 jnp.stack(pref_cols, axis=1)],
                axis=1,
            )  # [nblk + 1, blk + limbs]

            def limb_pref(idx):
                bi, ri = idx // blk, idx % blk
                raw = jnp.take(limb_table, bi + (ri > 0), axis=0)[:, :blk]
                raw = jnp.where(
                    jnp.arange(blk, dtype=jnp.int32)[None, :]
                    < ri[:, None],
                    raw, 0,
                )
                ex = jnp.take(limb_table, bi, axis=0)[:, blk:]
                return [
                    ex[:, l]
                    + jnp.sum((raw >> (id_limb_bits * l)) & limb_mask,
                              axis=1)
                    for l in range(id_limbs)
                ]

            pre_lo = limb_pref(seg_start)
            pre_hi = limb_pref(ends)
            limb_sums = [
                psum(pre_hi[l] - pre_lo[l]) for l in range(id_limbs)
            ]
            mean_id = _exact_mean_id(limb_sums, g_cnt, id_limb_bits)

        # Per-row lookups of per-segment values are the build's hottest
        # cost (as a dozen separate [S]->[N] gathers they dominated the
        # wall time); a row-gather of a packed [S, k] table costs the same
        # as ONE scalar gather, so each phase does a single jnp.take.
        packA_cols = [split_dim, seg_start]
        if mean_id_ties:
            packA_cols.append(mean_id)  # ties compare id > mean id
        else:
            # positional ties need the segment's global count + this
            # shard's exclusive prefix to rank-halve
            packA_cols += [g_cnt, ex_cnt]
        packA = jnp.stack(packA_cols, axis=1)  # [S, 3|4]
        ga = jnp.take(packA, ps, axis=0)
        p_dim, p_start = ga[:, 0], ga[:, 1]

        # --- phase 2: per-row split value + *exact* split plane.
        # One [N] cumsum of the chosen column gives every segment's exact
        # mean on its own split dimension — the plane stored in the node is
        # exactly the plane used to partition.
        # The value is extracted with a one-hot mask-reduce, NOT a
        # take_along_axis: the streaming [N, D] mask-multiply-sum reads
        # the matrix once in order, where a gather makes N scalar column
        # reads (exact: one nonzero term per row; the two have not been
        # timed against each other on the H100).
        value = jnp.sum(
            pvec
            * (
                p_dim[:, None] == jnp.arange(d, dtype=jnp.int32)[None, :]
            ),
            axis=1,
        )
        vc = jnp.cumsum(jnp.where(active, value, 0.0))

        def vc_at(idx):
            v = vc[jnp.clip(idx - 1, 0, n - 1)]
            return jnp.where(idx > 0, v, 0.0)

        mid = psum(vc_at(ends) - vc_at(seg_start)) / cnt_f
        p_mid = mid[ps]

        local_rank = pos - p_start
        if mean_id_ties:
            tie_high = pid > ga[:, 2]
        else:
            # positional split: lows get the first ceil(cnt/2) ranks
            p_gcnt, p_ex = ga[:, 2], ga[:, 3]
            g_rank = p_ex + local_rank  # global rank inside the segment
            tie_high = 2 * g_rank >= p_gcnt + (p_gcnt & 1)
        normal_high = (value > p_mid) | ((value == p_mid) & tie_high)

        # lows-so-far (inclusive) via one int cumsum + boundary gathers
        is_low_n = active & ~normal_high
        cl = jnp.cumsum(is_low_n.astype(jnp.int32))

        def cl_at(idx):  # exclusive prefix of lows at position idx
            v = cl[jnp.clip(idx - 1, 0, n - 1)]
            return jnp.where(idx > 0, v, 0)

        lo_cnt = cl_at(ends) - cl_at(seg_start)  # local low count
        g_lo = psum(lo_cnt)
        # zero-progress guard (fp edge: every row on one side) -> forced
        # tie partition. With mean-id ties the id split always makes
        # progress (min id ≤ mean < max id for ≥2 distinct ids), matching
        # the reference; positional ties use rank-halving.
        stuck = is_int & ((g_lo == 0) | (g_lo == g_cnt))
        degen_split = degenerate | stuck
        half = (g_cnt + 1) // 2  # lows get ceil(cnt/2) under rank split

        if mean_id_ties:
            # degenerate segments partition purely by id: recount lows
            id_low = active & ~tie_high
            cli = jnp.cumsum(id_low.astype(jnp.int32))

            def cli_at(idx):
                v = cli[jnp.clip(idx - 1, 0, n - 1)]
                return jnp.where(idx > 0, v, 0)

            lo_id = cli_at(ends) - cli_at(seg_start)
            lo_cnt = jnp.where(degen_split, lo_id, lo_cnt)
        else:
            # positional split moves no rows: local lows are the local
            # prefix of the segment's global rank block
            lo_pos = jnp.clip(half - ex_cnt, 0, seg_cnt)
            lo_cnt = jnp.where(degen_split, lo_pos, lo_cnt)

        # --- child numbering and boundaries
        ii = is_int.astype(jnp.int32)
        rank = jnp.cumsum(ii) - ii
        num_internal = jnp.sum(ii)
        next_base = node_base + s_live

        tgt_lo = jnp.where(is_int, 2 * rank, s_max)
        tgt_hi = jnp.where(is_int, 2 * rank + 1, s_max)
        new_start = (
            jnp.zeros((s_max,), jnp.int32)
            .at[tgt_lo].set(seg_start, mode="drop")
            .at[tgt_hi].set(seg_start + lo_cnt, mode="drop")
        )
        new_cnt = (
            jnp.zeros((s_max,), jnp.int32)
            .at[tgt_lo].set(lo_cnt, mode="drop")
            .at[tgt_hi].set(seg_cnt - lo_cnt, mode="drop")
        )
        new_start = vary(new_start)
        new_cnt = vary(new_cnt)

        # --- node table emission (small masked scatters).
        # Tie-partitioned nodes (degenerate variance or the zero-progress
        # guard) store dim = -2: their children are NOT separated by any
        # plane, so the search must always descend both — the reference's
        # NULL-Dimension semantics (DDL.sql:193-194, Search's
        # "N.Dimension is null or ..." at DDL.sql:276-277).
        node_dim = jnp.where(degen_split, -2, split_dim)
        dus = lambda arr, vals: jax.lax.dynamic_update_slice(
            arr, vals, (node_base,)
        )
        nd = dus(nd, jnp.where(is_int, node_dim, -1))
        nm = dus(nm, jnp.where(is_int & ~degen_split, mid, 0.0))
        nl = dus(nl, jnp.where(is_int, next_base + 2 * rank, -1))
        nh = dus(nh, jnp.where(is_int, next_base + 2 * rank + 1, -1))
        # leaves record their (start, count) range: rows never move again
        nls = dus(nls, jnp.where(is_int, 0, seg_start))
        nlc = dus(nlc, jnp.where(is_int, 0, seg_cnt))

        # --- phase 3: per-row partition decisions (one packed take —
        # per the measured rule, k [S]->[N] lookups cost the same as one
        # when they ride one [S, k] table; mean-id mode adds its id-low
        # base as a 5th column instead of a second gather round)
        cols = [
            lo_cnt,
            (degen_split.astype(jnp.int32) << 1)
            | is_int.astype(jnp.int32),
            rank,
            cl_at(seg_start),
        ]
        if mean_id_ties:
            cols.append(cli_at(seg_start))
        packC = jnp.stack(cols, axis=1)  # [S, 4 or 5]
        gc = jnp.take(packC, ps, axis=0)
        p_locnt, p_flags, p_rank, p_cls = (
            gc[:, 0], gc[:, 1], gc[:, 2], gc[:, 3]
        )
        p_degen_split = (p_flags & 2) != 0
        p_is_int = (p_flags & 1) != 0

        go_high = jnp.where(p_degen_split, tie_high, normal_high)
        if mean_id_ties:
            # id splits move rows: include them in the permutation, with
            # destinations from the id-low running count
            degen_moving = p_degen_split
            lows_upto_id = cli - gc[:, 4]
        else:
            degen_moving = jnp.zeros_like(p_degen_split)

        # --- stable within-range permutation (tie-rank splits are the
        # identity by construction; id splits permute like normal ones)
        moving = active & p_is_int & (~p_degen_split | degen_moving)
        lows_upto = cl - p_cls  # inclusive lows in [s, i]
        if mean_id_ties:
            lows_upto = jnp.where(p_degen_split, lows_upto_id, lows_upto)
        dest_low = p_start + lows_upto - 1
        dest_high = p_start + p_locnt + local_rank - lows_upto
        dest = jnp.where(
            moving, jnp.where(go_high, dest_high, dest_low), pos
        )
        # invert the (unique-index) permutation: sort_key_val states the
        # sort XLA would lower the scatter to anyway, minus the scatter
        # plumbing (probe_perm.py compares the forms)
        src = jax.lax.sort_key_val(dest, pos)[1]

        new_seg = jnp.where(
            active & p_is_int, 2 * p_rank + go_high.astype(jnp.int32), -1
        )
        new_leaf = jnp.where(active & ~p_is_int, node_base + ps, pleaf)

        # permute the int row-state with one packed take as well
        rowstate = jnp.stack([pid, new_seg, new_leaf], axis=1)[src]
        return (
            pvec[src], rowstate[:, 0], rowstate[:, 1], rowstate[:, 2],
            new_start, new_cnt, nls, nlc, nd, nm, nl, nh,
            next_base, 2 * num_internal,
            # "alternate": the reference's max/min parity rule
            # (IndexBuilder.cs:75-79); "max": max-variance every level —
            # no zero-variance dim is ever chosen while any dimension
            # still discriminates, so split planes stay strict and
            # single-branch descent (search.locate) is exact
            use_max if split == "max" else ~use_max,
            level + 1,
        )

    (pvec, pid, pseg, pleaf, seg_start, seg_cnt, nls, nlc, nd, nm, nl, nh,
     node_base, s_live, _, level) = jax.lax.while_loop(cond, body, init)

    # Depth-cap exit: still-live segments retire as oversized leaves with
    # their current ranges (node defaults already describe a leaf).
    nls = jax.lax.dynamic_update_slice(nls, seg_start, (node_base,))
    nlc = jax.lax.dynamic_update_slice(nlc, seg_cnt, (node_base,))
    pleaf = jnp.where(pseg >= 0, node_base + pseg, pleaf)
    total_nodes = node_base + s_live
    return nd, nm, nl, nh, nls, nlc, pid, pvec, total_nodes, level


_STATICS = (
    "s_max", "m_max", "leaf_size", "max_levels", "d_chunk",
    "stats_subsample", "axis_name", "tie_break", "progress_cb", "split",
    "id_limb_bits", "id_limbs",
)

sorted_build = jax.jit(_sorted_build_impl, static_argnames=_STATICS)

# The input buffer is dead after the first level's permutation; donating it
# removes one [N, D] resident from peak HBM — what lets 10M x 96 fit a
# single 16G chip. Callers must not reuse the donated array.
sorted_build_donating = jax.jit(
    _sorted_build_impl, static_argnames=_STATICS, donate_argnums=(0,)
)
