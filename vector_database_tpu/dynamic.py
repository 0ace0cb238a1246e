"""Incremental (mutable) index on top of the immutable BSP tree.

The reference offers two mutation models: the incremental in-memory trie
(``MemoryVectorIndex.Add/Remove``) and document-scoped full reindexing
(``dbo.IndexDocument``'s delete + insert, DDL.sql:397-418). For bulk
serving the right design is the classic main + delta:

- the **main** segment is an immutable ``BSPIndex`` with a tombstone mask
  (removals never restructure the tree — they hide rows);
- **adds** go to a delta buffer searched by exact scan (small, so the
  scan is cheap and exact);
- when the delta or the tombstones exceed a threshold fraction,
  ``compact()`` rebuilds the tree over the live rows with the fused
  single-compile builder — the device build is fast enough (SURVEY.md §6) that
  rebuild-on-threshold replaces the reference trie's per-record surgery.

Search semantics match the rest of the framework: exact, radius-bounded,
with stable external ids assigned at insert."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from vector_database_tpu.builder import build_index_fused
from vector_database_tpu.ops.exact import exact_sq_dists
from vector_database_tpu.ops.scan_knn import scan_knn
from vector_database_tpu.search import search as bsp_search


def _exact_d2_blocked(queries, vectors) -> np.ndarray:
    """Squared distances ``[Q, N]`` numerically identical to the tree's
    rerank (direct diff-square, so overflow-fallback answers agree with
    non-overflow ones on boundary rows) with BOUNDED device memory: the
    ``[Q, block, D]`` diff transient is capped at ~256 MB, where a whole
    -matrix ``exact_sq_dists`` call materializes ``[Q, N, D]`` — ~23 GB
    for 60 overflowed queries on a 1M x 96 main segment."""
    q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
    nq, d = q.shape
    n = vectors.shape[0]
    block = max(1024, (1 << 28) // max(1, nq * d * 4))
    if n <= block:
        return np.asarray(exact_sq_dists(q, vectors))
    outs = []
    for s in range(0, n, block):
        outs.append(np.asarray(exact_sq_dists(
            q, jax.lax.slice_in_dim(vectors, s, min(s + block, n))
        )))
    return np.concatenate(outs, axis=1)


class DynamicIndex:
    """Mutable exact ε-ball / k-NN index with stable integer ids."""

    def __init__(
        self,
        vectors=None,
        *,
        leaf_size: int = 8,
        rebuild_fraction: float = 0.25,
    ):
        self._leaf_size = leaf_size
        self._rebuild_fraction = rebuild_fraction
        self._next_id = 0
        self._index = None  # main BSPIndex
        self._main_ids = np.zeros((0,), np.int64)  # external id per main row
        self._main_alive = np.zeros((0,), bool)
        self._delta_vecs: list[np.ndarray] = []
        self._delta_ids: list[int] = []
        self._dims: Optional[int] = None
        # serving caches (see _main_view/_delta_view): the main segment
        # and the delta are served as SEPARATE parts and merged per
        # batch, so an add never touches the main view or its pack and
        # no [main+delta] concat ever doubles the main matrix in device
        # memory
        self._serve = None  # (main matrix, aligned ids, alive mask|None)
        self._delta_cache = None  # (padded delta matrix|None, padded ids)
        self._packed = None  # (main-view identity, PackedDB, pack ids)
        self._packed_base = None  # (index identity, unmasked PackedDB)
        self._host_main = None  # (index identity, host copy of .vectors)
        if vectors is not None:
            self.add(vectors)
            if self._delta_vecs:  # add's threshold may have compacted
                self.compact()

    def _live_main(self):
        """Live main-segment rows as ``(vectors, external_ids)`` numpy
        arrays (empty when no main index / no survivors). The single
        place that maps leaf-major sorted positions back through
        ``orig_row`` to the input rows that ids/tombstones are keyed by —
        shared by ``_main_view``'s consumers and ``compact`` so the mapping can
        never desynchronize between serving and compaction."""
        if self._index is None or not self._main_alive.any():
            return (
                np.zeros((0, self._dims or 0), np.float32),
                np.zeros((0,), np.int64),
            )
        orig = np.asarray(self._index.orig_row)
        if self._main_alive.all():
            return self._host_main_matrix(), self._main_ids[orig]
        keep = self._main_alive[orig]
        return (
            self._host_main_matrix()[keep],
            self._main_ids[orig[keep]],
        )

    def _host_main_matrix(self) -> np.ndarray:
        """Host copy of the main matrix, pulled ONCE per compaction
        epoch (keyed on the index identity) — re-pulling it per
        tombstone mutation would move the whole matrix (~4 GB at
        10M x 96) across the host link each time."""
        if self._host_main is None or self._host_main[0] is not self._index:
            self._host_main = (self._index, np.asarray(self._index.vectors))
        return self._host_main[1]

    def _live_parts(self):
        """Live rows of main + delta as host ``(parts_v, parts_i)`` lists
        — shared by packed tombstone serving and ``compact`` so the
        assembly (including the empty-main/empty-delta cases) can never
        desynchronize between serving and compaction."""
        parts_v, parts_i = [], []
        mv, mi = self._live_main()
        if mv.shape[0]:
            parts_v.append(mv)
            parts_i.append(mi)
        if self._delta_vecs:
            parts_v.append(np.stack(self._delta_vecs))
            parts_i.append(np.asarray(self._delta_ids, np.int64))
        return parts_v, parts_i

    def _main_view(self):
        """Device view of the MAIN segment for batched serving:
        ``(matrix, aligned external ids, alive row mask | None)``.

        The matrix is always the builder's leaf-major ``index.vectors``
        reused IN PLACE — never a copy. Tombstones ride along as a
        ``[N]`` bool mask folded into the scan (``scan_knn(row_mask=)``
        scores dead rows +inf), so a removal costs one ~N-byte mask
        upload instead of a device->host->device matrix round trip
        (~4 GB each way at 10M x 96). Invalidated
        only by mutations that touch the main segment (remove/compact);
        adds go to the delta part (``_delta_view``)."""
        if self._serve is None:
            if self._index is None or not self._main_alive.any():
                self._serve = (None, np.zeros((0,), np.int64), None)
            else:
                orig = np.asarray(self._index.orig_row)
                mi = self._main_ids[orig]
                mask = (
                    None if self._main_alive.all()
                    else jnp.asarray(self._main_alive[orig])
                )
                self._serve = (self._index.vectors, mi, mask)
        return self._serve

    def _delta_view(self):
        """Device view of the DELTA rows: ``(matrix | None, ids)`` with
        the row count padded up to a power-of-two capacity (sentinel
        rows carry id -1 and are masked out after the exact distance
        pass). The padding keeps the per-batch delta-merge programs at
        a handful of compiled shapes while the delta grows row by row —
        an unpadded view would recompile on EVERY add."""
        if self._delta_cache is None:
            if not self._delta_vecs:
                self._delta_cache = (None, np.zeros((0,), np.int64))
            else:
                nd = len(self._delta_vecs)
                cap = 64
                while cap < nd:
                    cap *= 2
                mat = np.zeros((cap, self._dims), np.float32)
                mat[:nd] = np.stack(self._delta_vecs)
                ids = np.full((cap,), -1, np.int64)
                ids[:nd] = np.asarray(self._delta_ids, np.int64)
                self._delta_cache = (jnp.asarray(mat), ids)
        return self._delta_cache

    def _invalidate_main(self) -> None:
        """Drop the main serve view AND its pack: a stale pack keeps
        bf16 blocks (~2 GB at 10M x 96) device-resident, and the next
        packed call would build the new pack while the old one is still
        referenced — two packs resident at once."""
        self._serve = None
        self._packed = None

    def _invalidate_delta(self) -> None:
        self._delta_cache = None

    def _invalidate_serve(self) -> None:
        """Drop every serving cache (both parts)."""
        self._invalidate_main()
        self._invalidate_delta()

    # --- size -------------------------------------------------------------
    def __len__(self) -> int:
        return int(self._main_alive.sum()) + len(self._delta_ids)

    @property
    def dims(self) -> Optional[int]:
        return self._dims

    # --- mutation -----------------------------------------------------------
    def add(self, vectors) -> np.ndarray:
        """Insert rows; returns their assigned external ids."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim <= 1 and vectors.size == 0:
            # atleast_2d would turn [] into shape (1, 0) — a phantom
            # zero-dim row that locks _dims to 0 and bricks the index
            return np.zeros((0,), np.int64)
        vectors = np.atleast_2d(vectors)
        if self._dims is None:
            self._dims = vectors.shape[1]
        elif vectors.shape[1] != self._dims:
            raise ValueError("invalid vector size")
        ids = np.arange(
            self._next_id, self._next_id + vectors.shape[0], dtype=np.int64
        )
        self._next_id += vectors.shape[0]
        self._delta_vecs.extend(vectors)
        self._delta_ids.extend(ids.tolist())
        # adds touch only the delta part: the main view and its pack
        # stay valid (packed serving keeps its kernel-rate epoch; the
        # fresh rows are merged exactly per batch from the delta view)
        self._invalidate_delta()
        self._maybe_compact()
        return ids

    def remove(self, vector, radius: float) -> int:
        """Remove every row within ``radius`` of ``vector`` (the reference's
        ε-ball removal contract, MemoryVectorIndex.cs:358-361). Returns the
        number removed."""
        removed = 0
        if self._index is not None:
            res = bsp_search(self._index, vector, radius)
            if bool(np.asarray(res.overflow)[0]):
                # the tree walk's candidate buffer capped out: a silent
                # truncation here would leave in-radius rows alive
                # forever — fall back to one exact scan over the main
                # segment (removal is rare; exactness is the contract)
                d2 = _exact_d2_blocked(vector, self._index.vectors)[0]
                orig = np.asarray(self._index.orig_row)
                rows = orig[d2 <= np.float32(radius) ** 2]
            else:
                rows = np.asarray(res.rows[0])
                rows = rows[rows >= 0]
            hit = rows[self._main_alive[rows]]
            self._main_alive[hit] = False
            removed += hit.size
            if hit.size:
                self._invalidate_main()
        if self._delta_vecs:
            mat = np.stack(self._delta_vecs)
            d2 = np.sum((mat - np.asarray(vector, np.float32)) ** 2, axis=1)
            # f32 radius square, like the device compare on the main
            # segment — a boundary row must not flip segments' verdicts
            keep = d2 > np.float32(radius) ** 2
            if not keep.all():
                removed += int((~keep).sum())
                self._delta_vecs = [
                    v for v, k in zip(self._delta_vecs, keep) if k
                ]
                self._delta_ids = [
                    i for i, k in zip(self._delta_ids, keep) if k
                ]
                self._invalidate_delta()
        self._maybe_compact()
        return removed

    def remove_ids(self, ids) -> int:
        """Remove rows by external id."""
        ids = set(int(i) for i in np.atleast_1d(ids))
        hit = np.isin(self._main_ids, list(ids)) & self._main_alive
        self._main_alive[hit] = False
        removed = int(hit.sum())
        if removed:
            self._invalidate_main()
        keep = [i not in ids for i in self._delta_ids]
        if not all(keep):
            removed += keep.count(False)
            self._delta_vecs = [
                v for v, k in zip(self._delta_vecs, keep) if k
            ]
            self._delta_ids = [
                i for i, k in zip(self._delta_ids, keep) if k
            ]
            self._invalidate_delta()
        self._maybe_compact()
        return removed

    # --- queries -------------------------------------------------------------
    def search(self, queries, radius: float):
        """Exact ε-ball search; returns per-query ``(ids, sq_dists)``."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        nq = queries.shape[0]
        out = [([], []) for _ in range(nq)]
        if self._index is not None:
            res = bsp_search(self._index, queries, radius)
            ovf = np.asarray(res.overflow)
            # overflowed queries (candidate buffer at its growth cap)
            # would silently lose matches — re-answer those few with one
            # exact scan over the main segment, keeping the contract
            exact_d2 = None
            if ovf.any():
                sub = np.nonzero(ovf)[0]
                exact_d2 = _exact_d2_blocked(
                    queries[sub], self._index.vectors
                )
                orig = np.asarray(self._index.orig_row)
                sub_pos = {int(q): j for j, q in enumerate(sub)}
            for qi in range(nq):
                if exact_d2 is not None and qi in sub_pos:
                    d2 = exact_d2[sub_pos[qi]]
                    m = d2 <= np.float32(radius) ** 2
                    rows, d2 = orig[m], d2[m]
                else:
                    rows = np.asarray(res.rows[qi])
                    d2 = np.asarray(res.sq_dists[qi])
                    keep = rows >= 0
                    rows, d2 = rows[keep], d2[keep]
                alive = self._main_alive[rows]
                out[qi][0].extend(self._main_ids[rows[alive]].tolist())
                out[qi][1].extend(d2[alive].tolist())
        if self._delta_vecs:
            mat = np.stack(self._delta_vecs)
            d2 = np.asarray(exact_sq_dists(jnp.asarray(queries),
                                           jnp.asarray(mat)))
            for qi in range(nq):
                hit = d2[qi] <= np.float32(radius) ** 2
                out[qi][0].extend(
                    np.asarray(self._delta_ids)[hit].tolist()
                )
                out[qi][1].extend(d2[qi][hit].tolist())
        return [
            (np.asarray(i, np.int64), np.asarray(d, np.float32))
            for i, d in out
        ]

    def knn(self, queries, k: int, radius: Optional[float] = None,
            *, exact: Optional[bool] = None, allowed_ids=None,
            packed: bool = False, probes: Optional[int] = None,
            min_probe_batch: Optional[int] = None,
            q_tile: int = 256, oversample: Optional[int] = None):
        """k nearest neighbors (within ``radius`` if given);
        ``(ids [Q,k], sq_dists [Q,k])`` with -1 / +inf padding.

        Device path: ONE streaming scan over the cached live-row
        matrix (main + delta merged, tombstones excluded) — no per-query
        host loops. ``exact=True`` (default) keeps the class's exactness
        contract (f32 scores, exact per-block top-k); ``exact=False``
        runs the bf16 bucketed scan (measured recall@10: 0.992 digits
        fixture, 0.986-0.99 clustered 1M-10M x 96 — recall_qps.py; exact
        distances on whatever it returns) for maximum throughput.

        ``allowed_ids``: optional array of this index's ids — results
        are restricted to them (filtered k-NN; the mask rides the scan,
        never a post-filter). With ``exact=True`` (default) the
        restriction is exact at any selectivity; ``exact=False`` keeps
        the bucketed scan's collision loss model over the allowed rows
        — prefer the default for sparse allowlists.

        ``packed=True``: serve through the packed bucket scan
        (``pack_database`` + ``pallas_scan_knn_packed``) — the MAIN
        segment is packed once per main-segment epoch and each batch
        streams the transposed bf16 blocks (same accuracy model as
        ``exact=False``: bf16 bucket selection + exact f32 rerank of
        the shortlist). Delta rows (adds since the last compaction) are
        merged EXACTLY on top per batch, so ``add`` never invalidates
        the pack — only removals and compactions do (a removal epoch
        rebuilds only the pack's norm row on device,
        ``PackedDB.mask_rows``). ``probes=`` additionally enables the
        pruned scan (only that many database blocks stream per query
        tile — the IVF-style high-QPS operating points; see
        ``pallas_scan_knn_packed``). Incompatible with ``allowed_ids``
        (the packed kernel has no filtered path — raises ValueError)
        and with an explicit ``exact=True`` (the pack serves the
        bucketed accuracy model; raises rather than silently
        downgrade).

        **Pruning is a BATCH mode** — probes calibrated at q=4096 and
        served at small batches collapse (measured at 10M x 96 with
        probes=256: recall 0.960 at q=4096, but 0.39 at q=256, 0.49 at
        q=1024, 0.86 at q=32): few
        query tiles dilute the shared probe budget. ``min_probe_batch``
        guards that footgun: a call with fewer queries than this is
        served by the FULL packed scan instead of the pruned one
        (matching ``PackedServer(min_probe_batch=)``); calibrate probes
        at your batch size and set ``min_probe_batch`` to it."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        nq = queries.shape[0]
        if min_probe_batch is not None and probes is None:
            raise ValueError(
                "min_probe_batch only applies to pruned serving; set "
                "probes= as well"
            )
        if (
            probes is not None
            and min_probe_batch is not None
            and nq < min_probe_batch
        ):
            probes = None  # under-filled batch: serve the full scan
        if packed:
            if allowed_ids is not None:
                raise ValueError(
                    "packed=True has no filtered path; use the default "
                    "exact scan for allowed_ids= serving"
                )
            if exact:
                raise ValueError(
                    "packed=True serves the bf16 bucketed-scan accuracy "
                    "model and cannot honor exact=True; drop one of them"
                )
        view = self._main_view()
        mat, main_ids, alive_mask = view
        dmat, dids = self._delta_view()
        allowed = (
            np.asarray(allowed_ids) if allowed_ids is not None else None
        )
        if mat is not None:
            if packed:
                from vector_database_tpu.ops.pallas_knn import (
                    pack_database,
                    pallas_scan_knn_packed,
                )

                if self._packed is None or self._packed[0] is not view:
                    # keyed on the main-view tuple identity: _main_view
                    # caches until the next main mutation, so a fresh
                    # tuple means a new epoch and the old pack is
                    # stale. The bf16 BASE pack is built once per
                    # COMPACTION epoch from the resident matrix (zero
                    # copies) and survives removals: a tombstone epoch
                    # only rebuilds the norm row (mask_rows, O(N) on
                    # device — no host round trip, no bf16 repack).
                    if (
                        self._packed_base is None
                        or self._packed_base[0] is not self._index
                    ):
                        self._packed_base = (
                            self._index, pack_database(mat)
                        )
                    base = self._packed_base[1]
                    self._packed = (
                        view,
                        base if alive_mask is None
                        else base.mask_rows(alive_mask),
                        main_ids,
                    )
                pids_map = self._packed[2]
                kk = min(k, pids_map.size)
                rows, d2 = pallas_scan_knn_packed(
                    self._packed[1], jnp.asarray(queries), k=kk,
                    q_tile=q_tile, oversample=oversample, probes=probes,
                    row_mask=alive_mask,
                )
                ids_map = pids_map
            else:
                kk = min(k, main_ids.size)
                row_mask = alive_mask
                if allowed is not None:
                    amask = jnp.asarray(np.isin(main_ids, allowed))
                    row_mask = (
                        amask if row_mask is None else row_mask & amask
                    )
                rows, d2 = scan_knn(
                    mat, jnp.asarray(queries), k=kk,
                    precise=True if exact is None else exact,
                    row_mask=row_mask,
                )
                ids_map = main_ids
            rows, d2 = np.asarray(rows), np.asarray(d2)
            ids = np.where(rows >= 0, ids_map[np.clip(rows, 0, None)], -1)
            # masked (dead / disallowed) rows score +inf inside the
            # scan; if k exceeds the live count they can still be
            # emitted as filler — never surface their ids
            ids = np.where(np.isfinite(d2), ids, -1)
            if kk < k:
                ids = np.pad(ids, ((0, 0), (0, k - kk)),
                             constant_values=-1)
                d2 = np.pad(d2, ((0, 0), (0, k - kk)),
                            constant_values=np.inf)
        else:
            ids = np.full((nq, k), -1, np.int64)
            d2 = np.full((nq, k), np.inf, np.float32)
        if dmat is not None:
            # exact f32 distances to the (padded) delta rows, merged
            # into the top-k on host — delta results are exact in every
            # serving mode, so fresh writes never lose accuracy
            dd2 = _exact_d2_blocked(queries, dmat)
            dd2 = np.where(dids[None, :] >= 0, dd2, np.inf)
            if allowed is not None:
                dd2 = np.where(
                    np.isin(dids, allowed)[None, :], dd2, np.inf
                )
            if dids.size > k:
                part = np.argpartition(dd2, k - 1, axis=1)[:, :k]
                dd2 = np.take_along_axis(dd2, part, 1)
                dsel = dids[part]
            else:
                dsel = np.broadcast_to(dids[None, :], dd2.shape)
            cat_d = np.concatenate([d2, dd2.astype(np.float32)], axis=1)
            cat_i = np.concatenate([ids, dsel], axis=1)
            order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
            d2 = np.take_along_axis(cat_d, order, 1).astype(np.float32)
            ids = np.where(
                np.isfinite(d2), np.take_along_axis(cat_i, order, 1), -1
            )
        if radius is not None:
            hit = d2 <= radius * radius
            ids = np.where(hit, ids, -1)
            d2 = np.where(hit, d2, np.inf).astype(np.float32)
        return ids, d2

    # --- maintenance -----------------------------------------------------------
    def _maybe_compact(self) -> None:
        main = max(1, self._main_ids.size)
        dead = main - int(self._main_alive.sum())
        churn = (len(self._delta_ids) + dead) / main
        if churn > self._rebuild_fraction and len(self) > 0:
            self.compact()

    # --- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint: compacts, then saves the main index + id map."""
        import os

        self.compact()
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "state.npz"),
            main_ids=self._main_ids,
            next_id=np.int64(self._next_id),
            leaf_size=np.int64(self._leaf_size),
            rebuild_fraction=np.float64(self._rebuild_fraction),
            dims=np.int64(self._dims if self._dims is not None else -1),
            has_index=np.bool_(self._index is not None),
        )
        if self._index is not None:
            self._index.save(os.path.join(path, "index"))

    @classmethod
    def load(cls, path: str) -> "DynamicIndex":
        import os

        from vector_database_tpu.models.bsp import BSPIndex

        z = np.load(os.path.join(path, "state.npz"))
        out = cls(
            leaf_size=int(z["leaf_size"]),
            rebuild_fraction=float(z["rebuild_fraction"]),
        )
        out._next_id = int(z["next_id"])
        dims = int(z["dims"])
        out._dims = dims if dims >= 0 else None
        out._main_ids = z["main_ids"]
        out._main_alive = np.ones(out._main_ids.size, bool)
        if bool(z["has_index"]):
            out._index = BSPIndex.load(os.path.join(path, "index.npz"))
        return out

    def compact(self) -> None:
        """Rebuild the main tree over all live rows; clears the delta.
        A no-op when already compact (empty delta, no tombstones) — so
        ``save()`` on a clean index doesn't pay a full rebuild."""
        if (
            not self._delta_vecs
            and self._index is not None
            and self._main_alive.all()
        ):
            return
        self._invalidate_serve()
        parts_v, parts_i = self._live_parts()
        self._delta_vecs, self._delta_ids = [], []
        if not parts_v:
            self._index = None
            self._main_ids = np.zeros((0,), np.int64)
            self._main_alive = np.zeros((0,), bool)
            return
        vecs = np.concatenate(parts_v)
        ids = np.concatenate(parts_i)
        # donate: ``vecs`` is host-assembled, so the device transfer
        # buffer is exclusively this call's — without donation the
        # builder keeps it alive beside its permuted outputs (one more
        # [N, D] resident); with it the build peak matches the plain
        # build_index_fused(donate=True) path
        self._index = build_index_fused(
            vecs, leaf_size=self._leaf_size, donate=True
        )
        self._host_main = None  # stale host copy of the OLD matrix
        self._packed_base = None  # stale pack of the OLD matrix (~GBs)
        # orig_row maps sorted position -> input row; rows returned by
        # search are input rows, so ids stay input-row indexed
        self._main_ids = ids
        self._main_alive = np.ones(ids.size, bool)
