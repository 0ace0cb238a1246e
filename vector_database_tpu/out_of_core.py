"""Out-of-core indexing: datasets larger than device memory.

The reference's scaling story is exactly this — the ~10M-vector build only
became feasible through a memory-mapped temp store after the in-RAM
parallel attempt died of page faults (reference README.md:91-98,
FileRangeStore.cs). The equivalent here:

- the dataset lives on the HOST (a ``NativeVectorStore`` mmap file or any
  row source);
- it is indexed in device-sized chunks: each chunk streams to HBM, gets a
  fused single-compile build, is packed ONCE into the serving kernel's
  transposed bf16 block layout, and the finished per-chunk index (node
  table + leaf-major vectors + packed blocks) returns to host RAM or a
  disk spill;
- queries stream ONLY the per-chunk packed blocks + norm row back
  through the device (196 B/row at D=96) — ``pallas_scan_knn_candidates``
  per chunk, no per-batch repacking and no f32 matrix transfer — the
  exact f32 rerank gathers the few candidate rows per query from the
  host-side (possibly memmapped) chunk vectors, and top-k / ε-results
  merge across chunks. Merging is exact: every member of the global
  top-k is in its own chunk's top-k.

Chunks are padded to a uniform capacity (+inf sentinel rows the rerank
can never return, ``pack_database(rows_valid=...)``), so every chunk —
including a ragged final one — runs ONE compiled serve program.

This composes with the mesh paths: on several hosts each ingests its own
chunks (the ``parallel/forest.py`` layout), so the chunked index is also
the >HBM-per-chip building block.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vector_database_tpu.builder import build_index_fused
from vector_database_tpu.models.bsp import BSPIndex
from vector_database_tpu.ops.pallas_knn import (
    PackedDB,
    pack_database,
    pallas_scan_knn_candidates,
    pallas_scan_knn_packed,
)
from vector_database_tpu.search import search as bsp_search

_TABLE_KEYS = (
    "dim", "mid", "low", "high", "leaf_start", "leaf_count", "orig_row",
    "vn", "cent", "rad",
)
_SCALAR_KEYS = ("depth", "leaf_cap", "num_leaves", "cap", "n_real", "bits")


def _hbm_budget() -> int:
    """Free device memory for the pin and chunk-prefetch decisions: the
    device's reported limit minus what is in use; on a backend that
    reports no limit (the CPU), the host's available memory."""
    stats = jax.local_devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


# HBM reserved past the pinned blocks for per-call serving transients
# (query tiles + the [tiles, q_tile, m] kernel output; the pinned
# host_rerank=True path streams nothing else per call)
_PIN_HEADROOM = 256 << 20


class ChunkedIndex:
    """Host-resident index over device-sized chunks of a large dataset.

    Each chunk holds its BSP node tables (host RAM, the O(node-tables)
    bound), its leaf-major f32 vectors, and the serving kernel's packed
    bf16 blocks — packed once at build time, reused by every batch
    (repacking costs more than a 1024-query batch; CLAUDE.md serving
    rule). ``d_align=16`` keeps the packed stream at its minimum size
    (the chunk path is transfer-bound).

    ``spill_dir``: when set, each chunk's vector matrix AND packed blocks
    are written to disk-backed ``.npy`` memmaps instead of host RAM — the
    chunks page in through the OS cache when a query streams them to the
    device. This bounds host RAM at O(node tables) regardless of dataset
    size (at 100M x 96 the vector copies alone are ~38 GB; with spill the
    index holds ~1 GB of tables). The reference's mmap temp store
    (FileRangeStore.cs), reborn as the SERVING-side spill. ``save``/
    ``load`` stream the same arrays (load maps them read-only), so a
    spilled index round-trips under the same RAM bound.
    """

    def __init__(self, leaf_size: int = 16,
                 spill_dir: Optional[str] = None,
                 *,
                 block: int = 8192,
                 buckets: int = 4096,
                 d_align: int = 16,
                 metric: str = "l2"):
        self._leaf_size = leaf_size
        self._chunks: List[dict] = []  # host numpy tables + spillable rows
        self._offsets: List[int] = []
        self._n = 0
        self._d: Optional[int] = None
        self._spill = spill_dir
        self._block = block
        self._buckets = buckets
        self._d_align = d_align
        self._metric = metric
        self._capacity: Optional[int] = None
        self._pinned: Optional[list] = None
        # device copies of per-chunk pruning summaries, cached on first
        # pruned call (re-transferring ~3 MB/chunk/call would cost more
        # than the pruned kernel saves, inverting the feature on the
        # pinned path whose point is zero per-call streaming)
        self._summ_dev: dict = {}
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    # --- building ----------------------------------------------------------
    def _spill_npy(self, name: str, arr: np.ndarray) -> np.ndarray:
        path = os.path.join(self._spill, name)
        np.save(path, arr)
        del arr
        return np.load(path, mmap_mode="r")

    def add_chunk(self, vectors, capacity: Optional[int] = None) -> None:
        """Index + pack one chunk (device round-trip) and keep it on host.

        ``capacity``: pad the chunk to this many rows (+inf sentinels) so
        chunks of different sizes share one compiled serve program; it
        defaults to the first chunk's size — a ragged FINAL chunk then
        reuses the full chunks' program.
        """
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if self._metric == "cosine":
            # normalize BEFORE the tree build so the per-chunk tree, the
            # rerank rows, and the packed blocks all live in the same
            # (angular) space; pack_database's normalize is then a no-op
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = vectors / np.maximum(norms, 1e-30)
        n = vectors.shape[0]
        if self._d is None:
            self._d = vectors.shape[1]
        elif vectors.shape[1] != self._d:
            raise ValueError("invalid vector size")
        if self._capacity is None:
            self._capacity = capacity if capacity else n
        cap = max(self._capacity, n, capacity or 0)

        index = build_index_fused(
            jnp.asarray(vectors), leaf_size=self._leaf_size, donate=True
        )
        # pack ONCE, on device, from the leaf-major rows (+inf pads: the
        # rerank can never return them; rows_valid masks them out of the
        # bucket selection)
        padded = jnp.pad(
            index.vectors, ((0, cap - n), (0, 0)),
            constant_values=np.inf,
        )
        pack = pack_database(
            padded, block=self._block, buckets=self._buckets,
            d_align=self._d_align, metric=self._metric, rows_valid=n,
        )
        vec = np.asarray(pack.vectors)
        vb = np.asarray(pack.vb).view(np.uint16)  # bf16 bits, npy-safe
        vn = np.asarray(pack.vn)
        orig = np.full((cap,), -1, np.int32)
        orig[:n] = np.asarray(index.orig_row)
        if self._spill:
            i = len(self._chunks)
            vec = self._spill_npy(f"chunk{i}.npy", vec)
            vb = self._spill_npy(f"chunk{i}_vb.npy", vb)
        self._chunks.append({
            "dim": np.asarray(index.dim),
            "mid": np.asarray(index.mid),
            "low": np.asarray(index.low),
            "high": np.asarray(index.high),
            "leaf_start": np.asarray(index.leaf_start),
            "leaf_count": np.asarray(index.leaf_count),
            "vectors": vec,
            "vb": vb,
            "vn": vn,
            "orig_row": orig,
            "depth": index.depth,
            "leaf_cap": index.leaf_cap,
            "num_leaves": index.num_leaves,
            "cap": cap,
            "n_real": n,
            "bits": pack.bits,
            # pruning summaries (cell centroids + radii, ~3 MB/chunk):
            # kept host-side, transferred per call when knn(probes=)
            "cent": np.asarray(pack.cent),
            "rad": np.asarray(pack.rad),
        })
        # eager HBM release (GC lag across device-sized chunks adds up)
        for buf in (index.dim, index.mid, index.low, index.high,
                    index.leaf_start, index.leaf_count, index.vectors,
                    index.orig_row, pack.vb, pack.vn, pack.vectors,
                    pack.cent, pack.rad):
            buf.delete()
        self._offsets.append(self._n)
        self._n += n
        if self._pinned is not None:  # keep pinned serving consistent
            c = self._chunks[-1]
            need = c["vb"].nbytes + c["vn"].nbytes + _PIN_HEADROOM
            if need > _hbm_budget():
                import warnings

                self.unpin()
                warnings.warn(
                    "add_chunk: new chunk's packed blocks exceed free "
                    "HBM; index unpinned (chunk added, serving streams)"
                )
            else:
                try:
                    self._pinned.append(self._put_chunk(c, False))
                except Exception:
                    # never leave _pinned shorter than _chunks: every
                    # later knn() would IndexError on the last chunk
                    self.unpin()
                    raise

    @classmethod
    def from_store(cls, store, chunk_rows: int = 2_000_000,
                   leaf_size: int = 16,
                   spill_dir: Optional[str] = None,
                   checkpoint_dir: Optional[str] = None,
                   **kwargs) -> "ChunkedIndex":
        """Build from a ``NativeVectorStore`` (or anything with
        ``.chunks(chunk_rows)``), one device-sized chunk at a time.

        ``checkpoint_dir``: mid-build durability. Each finished chunk's
        artifacts are persisted there (the ``save()`` format) and a
        manifest is atomically advanced; if the process dies, calling
        ``from_store`` again with the same arguments resumes AFTER the
        last completed chunk instead of from chunk 0 — a restart would
        otherwise repeat every finished chunk's build (the reference's
        per-document durability contract, DDL.sql:397-418, generalized
        to build-time). The chunk payloads
        are re-memmapped from the checkpoint as they are written, so
        checkpointing subsumes ``spill_dir`` (which is ignored with a
        warning when both are given), and the finished directory is
        directly ``load()``-able — ``from_store(checkpoint_dir=p)``
        doubles as ``save(p)`` for free. A manifest whose build
        parameters disagree with the current call raises (a resumed
        build must produce the same index a fresh one would)."""
        if checkpoint_dir is not None:
            if spill_dir is not None:
                import warnings

                warnings.warn(
                    "from_store: checkpoint_dir subsumes spill_dir "
                    "(chunk payloads are memmapped from the checkpoint); "
                    "spill_dir ignored"
                )
            return cls._from_store_checkpointed(
                store, chunk_rows, leaf_size, checkpoint_dir, **kwargs
            )
        out = cls(leaf_size=leaf_size, spill_dir=spill_dir, **kwargs)
        # a store smaller than one chunk must not be padded up to
        # chunk_rows (+inf sentinel rows cost HBM and scan time forever);
        # larger stores keep the uniform capacity so a ragged final
        # chunk reuses the same compiled serving program
        cap = min(chunk_rows, len(store)) if hasattr(store, "__len__") \
            else chunk_rows
        for chunk in store.chunks(chunk_rows):
            out.add_chunk(chunk, capacity=max(cap, 1))
        return out

    @classmethod
    def _from_store_checkpointed(cls, store, chunk_rows, leaf_size,
                                 path, **kwargs):
        out = cls(leaf_size=leaf_size, **kwargs)
        cap = min(chunk_rows, len(store)) if hasattr(store, "__len__") \
            else chunk_rows
        cap = max(cap, 1)
        params = {
            "chunk_rows": chunk_rows,
            "leaf_size": leaf_size,
            "block": out._block,
            "buckets": out._buckets,
            "d_align": out._d_align,
            "metric": out._metric,
        }
        os.makedirs(path, exist_ok=True)
        manifest_path = os.path.join(path, "resume.json")
        done = 0
        # identity of the DATA, not just the build parameters: resuming
        # against a different or grown store would silently mix chunks
        # from two datasets, and a changed len(store) changes the ragged
        # -final-chunk capacity vs the manifest's (breaking the one
        # -compiled-serve-shape property) — record the store length and
        # a cheap content fingerprint (first rows of chunk 0) and raise
        # on mismatch, like the params check
        n_store = len(store) if hasattr(store, "__len__") else None
        fp: dict = {"v": None}
        man = None
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                man = json.load(f)
            if man.get("params") != params:
                raise ValueError(
                    "checkpoint_dir holds a build with different "
                    f"parameters ({man.get('params')} vs {params}); "
                    "point at a fresh directory or match the original "
                    "arguments"
                )
            if man.get("n_store", n_store) != n_store:
                raise ValueError(
                    "checkpoint_dir holds a build over a store of "
                    f"{man.get('n_store')} rows but the current store "
                    f"has {n_store}; a resumed build must see the same "
                    "data a fresh one would — point at a fresh "
                    "directory (or the original store)"
                )
            fp["v"] = man.get("fingerprint")
            done = int(man["chunks_done"])
            out._capacity = man["capacity"]
            out._d = man["d"]
            for i in range(done):
                out._chunks.append(cls._load_chunk(path, i))
                out._offsets.append(out._n)
                out._n += out._chunks[-1]["n_real"]

        def advance():
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "params": params,
                    "chunks_done": len(out._chunks),
                    "capacity": out._capacity,
                    "d": out._d,
                    "n_store": n_store,
                    "fingerprint": fp["v"],
                }, f)
            os.replace(tmp, manifest_path)  # atomic on POSIX

        for i, chunk in enumerate(store.chunks(chunk_rows)):
            if i == 0:
                # content fingerprint: the head of chunk 0 (the generator
                # yields it even on a resume, so this costs nothing extra)
                import hashlib

                head = np.ascontiguousarray(
                    np.asarray(chunk)[:64], np.float32
                )
                h = hashlib.sha1(head.tobytes()).hexdigest()
                if fp["v"] is not None and fp["v"] != h:
                    raise ValueError(
                        "checkpoint_dir holds a build over DIFFERENT "
                        "data (chunk-0 fingerprint mismatch); a resumed "
                        "build must see the same store a fresh one "
                        "would — point at a fresh directory"
                    )
                fp["v"] = h
            if i < done:
                continue  # host-side skip: no device work repeated
            out.add_chunk(chunk, capacity=cap)
            out._persist_chunk(path, len(out._chunks) - 1, adopt=True)
            advance()
        # the finished directory doubles as a save(): write the final
        # meta.json so ChunkedIndex.load(checkpoint_dir) just works
        out._write_meta(path)
        return out

    def __len__(self) -> int:
        return self._n

    @property
    def num_chunks(self) -> int:
        return len(self._chunks)

    def _device_index(self, c: dict) -> BSPIndex:
        return BSPIndex(
            dim=jnp.asarray(c["dim"]),
            mid=jnp.asarray(c["mid"]),
            low=jnp.asarray(c["low"]),
            high=jnp.asarray(c["high"]),
            leaf_start=jnp.asarray(c["leaf_start"]),
            leaf_count=jnp.asarray(c["leaf_count"]),
            vectors=jnp.asarray(c["vectors"]),
            orig_row=jnp.asarray(c["orig_row"]),
            depth=c["depth"],
            leaf_cap=c["leaf_cap"],
            num_leaves=c["num_leaves"],
        )

    def _device_pack(self, bufs: tuple, c: dict,
                     vectors=None, summaries=None) -> PackedDB:
        """Assemble the on-device PackedDB from transferred chunk buffers.
        ``vectors`` overrides the rerank source (the candidates-only path
        passes a ``[0, D]`` placeholder — the kernel never reads it);
        ``summaries`` is the device ``(cent, rad)`` pair when the call
        serves pruned (``probes=``)."""
        vec = bufs[2] if vectors is None else vectors
        cent, rad = summaries if summaries is not None else (None, None)
        return PackedDB(
            vb=bufs[0], vn=bufs[1], vectors=vec,
            n=c["cap"], block=self._block,
            m=min(self._buckets, self._block), bits=c["bits"],
            metric=self._metric, cent=cent, rad=rad,
        )

    def _put_chunk(self, c: dict, with_vectors: bool = True):
        import ml_dtypes

        # view the host uint16 bits as bf16 BEFORE the transfer (zero-copy
        # on host): the device buffer lands already typed, so serving never
        # pays a per-call bitcast (which would allocate a full vb copy in
        # HBM — fatal for pin() at the advertised capacity)
        bufs = [
            jax.device_put(c["vb"].view(ml_dtypes.bfloat16)),
            jax.device_put(c["vn"]),
        ]
        if with_vectors:
            bufs.append(jax.device_put(c["vectors"]))
        return tuple(bufs)

    # --- pinned serving ------------------------------------------------------
    def pin(self) -> None:
        """Keep every chunk's packed blocks + norm row resident in device
        memory so ``knn(host_rerank=True)`` serves at kernel rate with NO
        per-call chunk streaming — the single-device CAPACITY serving
        mode.

        With the f32 rerank matrix staying on host, the device holds only
        ~196 B/row at D=96 (vs ~580 with the on-device rerank), so one
        device serves ~3x the rows of the fully-resident path. The exact
        rerank pages candidate rows from the host-side (possibly
        memmapped) vectors per batch.

        Raises if the packed blocks (plus a serving-transient headroom)
        exceed the free-HBM estimate. Pinning is a serving-time state,
        not part of ``save``. ``knn(host_rerank=False)`` on a pinned
        index additionally streams each chunk's f32 rerank matrix per
        call (double-buffered) — budget ~2 chunks of vectors of extra
        HBM for that combination, or serve pinned with the default
        ``host_rerank=True``.
        """
        if self._pinned is not None:
            return
        need = _PIN_HEADROOM + sum(
            c["vb"].nbytes + c["vn"].nbytes for c in self._chunks
        )
        budget = _hbm_budget()
        if need > budget:
            raise ValueError(
                f"packed blocks ({need >> 20} MiB) exceed free HBM "
                f"(~{budget >> 20} MiB); serve unpinned (streamed)"
            )
        self._pinned = [self._put_chunk(c, False) for c in self._chunks]

    def unpin(self) -> None:
        """Release pinned HBM buffers (back to streamed serving), and
        any cached device summaries with them."""
        for summ in self._summ_dev.values():
            summ[0].delete()
            summ[1].delete()
        self._summ_dev = {}
        if self._pinned is None:
            return
        for bufs in self._pinned:
            for b in bufs:
                b.delete()
        self._pinned = None

    def _host_rerank(self, c: dict, short: np.ndarray, qh: np.ndarray,
                     k: int):
        """Exact f32 rerank of the kernel's candidate shortlist on the
        HOST, gathering only the O(Q * k_scan * w) candidate rows from the
        (possibly memmapped) chunk vectors — the out-of-core twin of the
        device rerank tail in ``_scan_knn_packed_impl``. ``qh`` must be in
        the chunk's metric space (unit rows for cosine)."""
        capn = c["cap"]
        ip = self._metric == "ip"
        safe = np.clip(short, 0, capn - 1)
        # memmap fancy indexing pages in only the candidate rows
        cand = c["vectors"][safe]  # [Q, C, D] f32
        with np.errstate(invalid="ignore", over="ignore"):
            if ip:
                key = -np.einsum("qcd,qd->qc", cand, qh)
            else:
                # in place: fancy indexing returned an owned array, and a
                # second [Q, C, D] temporary would cost a full extra pass
                # (probe_host_rerank.py; bit-identical). The dot form
                # |c|^2 - 2qc + |q|^2 is faster still but NOT exact
                # (~6e-5 abs err at O(1) data) — rejected: this rerank is
                # the serving path's exactness contract.
                cand -= qh[:, None, :]
                key = np.einsum("qcd,qcd->qc", cand, cand)
            # mask index pads AND +inf sentinel rows (isfinite catches
            # the ip -inf/NaN case, mirroring the device rerank)
            key = np.where((short < capn) & np.isfinite(key), key, np.inf)
        kk = min(k, key.shape[1])
        pos = np.argpartition(key, kk - 1, axis=1)[:, :kk]
        pkey = np.take_along_axis(key, pos, 1)
        order = np.argsort(pkey, axis=1, kind="stable")
        pkey = np.take_along_axis(pkey, order, 1)
        rows = np.take_along_axis(
            np.take_along_axis(short, pos, 1), order, 1
        )
        rows = np.where(np.isfinite(pkey), rows, -1)
        if k > kk:
            rows = np.pad(rows, ((0, 0), (0, k - kk)), constant_values=-1)
            pkey = np.pad(
                pkey, ((0, 0), (0, k - kk)), constant_values=np.inf
            )
        if ip:
            return rows, np.where(
                np.isfinite(pkey), -pkey, -np.inf
            ).astype(np.float32)
        return rows, pkey.astype(np.float32)

    def _chunk_serve_kw(self, i: int, c: dict, serve_kw: dict,
                        pruned: bool):
        """Per-chunk serve kwargs + cached device summaries for pruned
        serving (``probes >= nb`` degrades to the exact full scan, the
        single-chip probes contract)."""
        if not pruned:
            return serve_kw, None
        nb_c = c["vb"].shape[0]
        if serve_kw["probes"] >= nb_c:
            return (
                {x: v for x, v in serve_kw.items() if x != "probes"},
                None,
            )
        if c.get("cent") is None:
            raise ValueError(
                "probes= needs per-chunk summaries; this index "
                "was saved before they existed — rebuild it"
            )
        # tiny (~3 MB/chunk), cached on first use — NEVER re-transferred
        # per call
        summ = self._summ_dev.get(i)
        if summ is None:
            summ = (
                jax.device_put(np.ascontiguousarray(c["cent"])),
                jax.device_put(np.ascontiguousarray(c["rad"])),
            )
            self._summ_dev[i] = summ
        return serve_kw, summ

    @staticmethod
    def _merge_chunk(best_d, best_r, rows, d2, c, off, k, ip, worst):
        """Fold one chunk's (rows, d2) into the running global top-k —
        exact: every member of the global top-k is in its chunk's top-k."""
        orig_taken = c["orig_row"][np.where(rows >= 0, rows, 0)]
        valid = (rows >= 0) & (orig_taken >= 0)
        grows = np.where(valid, orig_taken + off, -1)
        cat_d = np.concatenate([best_d, np.where(valid, d2, worst)], 1)
        cat_r = np.concatenate([best_r, grows], 1)
        order = np.argsort(-cat_d if ip else cat_d, axis=1)[:, :k]
        return (
            np.take_along_axis(cat_d, order, 1),
            np.take_along_axis(cat_r, order, 1),
        )

    # --- queries -------------------------------------------------------------
    def knn(self, queries, k: int, host_rerank: bool = True,
            min_probe_batch: Optional[int] = None, **serve_kw):
        """Global k-NN: per-chunk streamed packed scan + exact host merge.

        Returns ``(rows [Q, k], sq_dists [Q, k])`` with global row ids.
        ``serve_kw`` forwards to the serve kernel (``q_tile``,
        ``oversample``).

        ``probes=`` (via ``serve_kw``) serves each chunk PRUNED: only
        that many of the chunk's packed blocks stream per query tile
        (cell-centroid selection; see ``pallas_scan_knn_packed``) — on
        the transfer-bound streamed path this cuts nothing (the whole
        chunk still transfers), but on a ``pin()``ned index it divides
        the kernel time, multiplying the capacity serving mode's QPS.
        Pruning is a BATCH mode: probes calibrated at q=4096 collapse
        at small batches (measured 10M x 96, probes=256: recall 0.960
        at q=4096 but 0.39 at q=256).
        ``min_probe_batch`` guards it — calls with fewer queries serve
        the full scan instead (matching ``PackedServer``'s knob).

        ``host_rerank`` (default): only the packed bf16 blocks + norm row
        stream to the device — 196 B/row at D=96 vs 580 B/row with the
        f32 rerank matrix, a ~3x cut of the per-batch stream in a path
        that is transfer-bound by definition (the dataset cannot live in
        HBM) — and the exact f32 rerank gathers the few candidate rows
        per query from the host-side chunk vectors (a few MB of memmap
        page-ins, not a chunk scan). ``host_rerank=False`` restores the
        all-on-device rerank.
        """
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        q = queries.shape[0]
        if min_probe_batch is not None and serve_kw.get("probes") is None:
            raise ValueError(
                "min_probe_batch only applies to pruned serving; set "
                "probes= as well"
            )
        if (
            serve_kw.get("probes") is not None
            and min_probe_batch is not None
            and q < min_probe_batch
        ):
            serve_kw = {x: v for x, v in serve_kw.items() if x != "probes"}
        # ip scores are dots (HIGHER is better, kernel returns them
        # best-first); l2/cosine are squared distances (lower is better)
        ip = self._metric == "ip"
        worst = -np.inf if ip else np.inf
        best_d = np.full((q, k), worst, np.float32)
        best_r = np.full((q, k), -1, np.int64)
        qdev = jnp.asarray(queries)
        qh = queries
        if host_rerank and self._metric == "cosine":
            # host rerank scores in the chunk's metric space (rows were
            # unit-normalized at add_chunk)
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            qh = queries / np.maximum(norms, 1e-30)
        wv = not host_rerank
        placeholder = (
            jnp.zeros((0, self._d), jnp.float32)
            if host_rerank and self._chunks else None
        )
        pruned = serve_kw.get("probes") is not None
        if (
            self._pinned is not None and host_rerank
            and os.environ.get("VDB_PIN_PIPELINE", "1") != "0"
        ):
            # CAPACITY-mode pipeline: every chunk's kernel is DISPATCHED
            # (async) and its [Q, C] shortlist put on an async
            # device->host copy BEFORE any host rerank runs, so the
            # per-chunk dispatch, the scan itself, and
            # the ~1.3 MB/chunk result transfer all overlap the
            # host-side memmap gather + exact rerank of earlier chunks.
            # Merge order is unchanged,
            # so results are bit-identical to the sequential path
            # (VDB_PIN_PIPELINE=0 restores it for A/B).
            shorts = []
            for i, c in enumerate(self._chunks):
                kw, summ = self._chunk_serve_kw(i, c, serve_kw, pruned)
                pack = self._device_pack(
                    self._pinned[i], c, vectors=placeholder,
                    summaries=summ,
                )
                s = pallas_scan_knn_candidates(pack, qdev, k=k, **kw)
                try:
                    s.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    pass  # backend without async copies: asarray blocks
                shorts.append(s)
            for i, (c, off) in enumerate(
                zip(self._chunks, self._offsets)
            ):
                short = np.asarray(shorts[i])
                shorts[i] = None  # free the device shortlist eagerly
                rows, d2 = self._host_rerank(c, short, qh, k)
                best_d, best_r = self._merge_chunk(
                    best_d, best_r, rows, d2, c, off, k, ip, worst
                )
            return best_r, best_d
        # Pinned chunks (pin()) skip the stream entirely; otherwise
        # double-buffer it when HBM headroom allows: the async host->HBM
        # put of chunk i+1 overlaps chunk i's scan. The consumed chunk is
        # freed eagerly (GC lag across multi-GB buffers adds up).
        pinned = self._pinned
        bufs = None
        prefetch = False
        pvec = None  # pinned + on-device rerank: streamed vectors buffer
        if pinned is None:
            chunk_bytes = max(
                (
                    c["vb"].nbytes + c["vn"].nbytes
                    + (c["vectors"].nbytes if wv else 0)
                    for c in self._chunks
                ),
                default=0,
            )
            prefetch = 3 * chunk_bytes < _hbm_budget()
            bufs = (
                self._put_chunk(self._chunks[0], wv)
                if self._chunks else None
            )
        elif wv and self._chunks:
            # pinned holds vb+vn only; the f32 rerank matrices stream
            # per chunk, double-buffered like the unpinned path
            vec_bytes = max(c["vectors"].nbytes for c in self._chunks)
            prefetch = 3 * vec_bytes < _hbm_budget()
            pvec = jax.device_put(self._chunks[0]["vectors"])
        for i, (c, off) in enumerate(zip(self._chunks, self._offsets)):
            nxt = None
            pnxt = None
            if pinned is None:
                if prefetch and i + 1 < len(self._chunks):
                    nxt = self._put_chunk(self._chunks[i + 1], wv)
                cur = bufs
            else:
                cur = pinned[i]
                if wv:
                    if prefetch and i + 1 < len(self._chunks):
                        pnxt = jax.device_put(
                            self._chunks[i + 1]["vectors"]
                        )
                    cur = cur + (pvec,)
            kw, summ = self._chunk_serve_kw(i, c, serve_kw, pruned)
            if host_rerank:
                pack = self._device_pack(
                    cur, c, vectors=placeholder, summaries=summ
                )
                short = np.asarray(pallas_scan_knn_candidates(
                    pack, qdev, k=k, **kw
                ))
                rows, d2 = self._host_rerank(c, short, qh, k)
            else:
                pack = self._device_pack(cur, c, summaries=summ)
                rows, d2 = pallas_scan_knn_packed(
                    pack, qdev, k=k, **kw
                )
                rows = np.asarray(rows)
                d2 = np.asarray(d2)
            if pinned is None:
                for b in cur:
                    b.delete()
                if nxt is None and i + 1 < len(self._chunks):
                    nxt = self._put_chunk(self._chunks[i + 1], wv)
                bufs = nxt
            elif wv:
                cur[2].delete()
                if pnxt is None and i + 1 < len(self._chunks):
                    pnxt = jax.device_put(self._chunks[i + 1]["vectors"])
                pvec = pnxt
            best_d, best_r = self._merge_chunk(
                best_d, best_r, rows, d2, c, off, k, ip, worst
            )
        return best_r, best_d

    def search(self, queries, radius: float):
        """Exact ε-ball over all chunks (tree walk per chunk); returns
        per-query ``(global_rows, sq_dists)``.

        With ``metric="cosine"`` the ball is ANGULAR: rows were L2-
        normalized at ``add_chunk`` and queries are normalized here, so
        ``radius`` bounds the Euclidean distance between unit vectors
        (monotone in angle) — the same space ``knn`` scores in.
        ``metric="ip"`` has no ε-ball (inner product is not a metric).
        """
        if self._metric == "ip":
            raise ValueError(
                "search() is an epsilon-ball; inner product is not a "
                "metric — use knn()"
            )
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self._metric == "cosine":
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(norms, 1e-30)
        out = [([], []) for _ in range(queries.shape[0])]
        for c, off in zip(self._chunks, self._offsets):
            index = self._device_index(c)
            res = bsp_search(index, queries, radius)
            # TWO device transfers per chunk — per-query slicing would
            # make 2·Q device-to-host copies per chunk
            all_rows = np.asarray(res.rows)
            all_d2 = np.asarray(res.sq_dists)
            for qi in range(queries.shape[0]):
                rows, d2 = all_rows[qi], all_d2[qi]
                keep = rows >= 0
                out[qi][0].extend((rows[keep] + off).tolist())
                out[qi][1].extend(d2[keep].tolist())
        return [
            (np.asarray(r, np.int64), np.asarray(d, np.float32))
            for r, d in out
        ]

    # --- persistence -----------------------------------------------------------
    def _persist_chunk(self, path: str, i: int,
                       adopt: bool = False) -> None:
        """Write chunk ``i``'s artifacts in the ``save()`` layout.
        ``adopt=True`` (the checkpointed build) additionally re-memmaps
        the big arrays from what was just written, so the build's RAM
        stays O(node tables) like a spilled one."""
        c = self._chunks[i]
        np.savez(
            os.path.join(path, f"chunk_{i}_tables.npz"),
            # cent/rad may be None on chunks reloaded from an older
            # save — re-saving keeps them absent
            **{k: np.asarray(c[k]) for k in _TABLE_KEYS
               if c.get(k) is not None},
            scalars=np.array(
                [c[k] for k in _SCALAR_KEYS], np.int64
            ),
        )
        # np.save streams from a memmap source page by page: host RAM
        # stays O(buffer), not O(chunk)
        for key, fname in (("vectors", f"chunk_{i}_vectors.npy"),
                           ("vb", f"chunk_{i}_vb.npy")):
            dst = os.path.join(path, fname)
            src = c[key]
            # already memmapped from this very file (save() onto its own
            # checkpoint/load dir): rewriting a file that backs an open
            # read-mapping of itself would corrupt it — and it's a no-op
            if getattr(src, "filename", None) is not None and \
                    os.path.exists(dst) and os.path.samefile(
                        src.filename, dst):
                continue
            np.save(dst, src)
            if adopt:
                c[key] = np.load(dst, mmap_mode="r")

    @staticmethod
    def _load_chunk(path: str, i: int) -> dict:
        z = np.load(os.path.join(path, f"chunk_{i}_tables.npz"))
        # cent/rad are absent from pre-probes saves: load them as
        # None (knn(probes=) then raises with a rebuild hint)
        chunk = {
            k: (z[k] if k in z.files else None) for k in _TABLE_KEYS
        }
        chunk.update(
            {k: int(v) for k, v in zip(_SCALAR_KEYS, z["scalars"])}
        )
        chunk["vectors"] = np.load(
            os.path.join(path, f"chunk_{i}_vectors.npy"), mmap_mode="r"
        )
        chunk["vb"] = np.load(
            os.path.join(path, f"chunk_{i}_vb.npy"), mmap_mode="r"
        )
        return chunk

    def _write_meta(self, path: str) -> None:
        meta = {
            "format": 2,
            "leaf_size": self._leaf_size,
            "offsets": self._offsets,
            "n": self._n,
            "d": self._d,
            "chunks": len(self._chunks),
            "block": self._block,
            "buckets": self._buckets,
            "d_align": self._d_align,
            "metric": self._metric,
            "capacity": self._capacity,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def save(self, path: str) -> None:
        """Durable copy of the index (the reference's ``dbo.TextIndex``
        role, DDL.sql:209-227). The big per-chunk arrays (vectors, packed
        blocks) are streamed to plain ``.npy`` files — a spilled 100M
        index saves without ever materializing a chunk in RAM — and the
        small node tables go into one npz per chunk."""
        os.makedirs(path, exist_ok=True)
        self._write_meta(path)
        for i in range(len(self._chunks)):
            self._persist_chunk(path, i)

    @classmethod
    def load(cls, path: str) -> "ChunkedIndex":
        """Reload; the big arrays are memory-mapped read-only, so a
        spilled-scale index serves under the same O(node-tables) host RAM
        bound it was built under."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != 2:
            raise ValueError(
                "unrecognized ChunkedIndex save format; rebuild with "
                "this version's save()"
            )
        out = cls(
            leaf_size=meta["leaf_size"], block=meta["block"],
            buckets=meta["buckets"], d_align=meta["d_align"],
            metric=meta["metric"],
        )
        out._offsets = list(meta["offsets"])
        out._n = meta["n"]
        out._d = meta["d"]
        out._capacity = meta["capacity"]
        for i in range(meta["chunks"]):
            out._chunks.append(cls._load_chunk(path, i))
        return out
