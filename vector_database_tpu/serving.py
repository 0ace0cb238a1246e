"""Stable-shape production serving over a packed database.

The serving programs are jit-compiled per QUERY-BATCH SHAPE: a
deployment that forwards caller batches as-is retraces and recompiles on
every new batch size. ``PackedServer`` closes that operational gap:
every incoming batch is padded/sliced to ONE fixed shape, so the whole
deployment runs a single compiled program per configuration — the
analogue of the reference's always-warm SQL plan cache (its
``dbo.Search`` table function compiles once per shape of the plan,
DDL.sql:234-242, not once per call).

Works over a single-chip ``PackedDB`` (``pack_database``) or a
mesh-sharded ``ShardedPackedDB`` (``pack_database_sharded``) — the
row-sharded multi-chip serving path — with identical semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class PackedServer:
    """Fixed-batch serving front end for the packed bucket scan.

    ``batch`` is the compiled batch size: larger caller batches are
    served in ``batch``-sized waves, smaller ones padded (pad rows cost
    kernel time but no extra compile — size ``batch`` for the common
    case). ``k``, ``q_tile``, ``oversample``, ``probes`` are static
    kernel parameters; one ``PackedServer`` = one compiled program.
    ``probes`` enables the pruned high-QPS mode: only that many
    database blocks stream per query tile (per shard, for a sharded
    pack), chosen by cell-centroid distance — see
    ``pallas_scan_knn_packed`` / ``sharded_scan_knn``. Pruning pays in
    proportion to the number of query tiles (the recall knee sits at
    probes ~ blocks/tiles for diverse traffic), so size ``batch`` at
    4096+ when serving pruned; ``calibrate_probes`` picks the knob for
    a target recall at your batch shape.

    ``min_probe_batch`` guards the pruned mode against under-filled
    waves: a wave with fewer REAL queries than this is served by the
    full scan instead (one extra compiled program, taken off the
    request path by ``warmup``). Pruning is a batch mode — measured at
    10M x 96 with ``probes=256`` calibrated for q=4096 (0.960 recall),
    small batches collapse to 0.39-0.86 recall because few query tiles
    dilute the shared probe budget —
    so a mixed-traffic deployment should set ``min_probe_batch=batch``
    to only prune full waves. Since every wave has at most ``batch``
    real queries, a larger value could never be satisfied and would
    silently disable pruning for ALL traffic — the constructor rejects
    it.

    ``probes_max`` serves the pruned waves through the RUNTIME-probes
    program (``pallas_scan_knn_packed_rt`` / the sharded twin): every
    probes value in [1, probes_max] shares one compiled program, so
    ``set_probes`` retunes a live server with zero recompiles.

    >>> pack = pack_database(vectors)
    >>> srv = PackedServer(pack, k=10, batch=1024)
    >>> srv.warmup()                 # compile once, off the request path
    >>> rows, d2 = srv.query(queries)   # any Q, no recompiles
    """

    def __init__(
        self,
        pack,
        *,
        k: int = 10,
        batch: int = 1024,
        q_tile: Optional[int] = None,
        oversample: Optional[int] = None,
        probes: Optional[int] = None,
        probes_max: Optional[int] = None,
        min_probe_batch: Optional[int] = None,
        interpret: bool = False,
    ):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if min_probe_batch is not None and probes is None:
            raise ValueError(
                "min_probe_batch only applies to pruned serving; set "
                "probes= as well"
            )
        if min_probe_batch is not None and min_probe_batch > batch:
            raise ValueError(
                f"min_probe_batch ({min_probe_batch}) exceeds batch "
                f"({batch}): no wave could ever satisfy it, so pruning "
                "would be silently disabled for all traffic; set "
                "min_probe_batch <= batch (batch itself prunes only "
                "full waves)"
            )
        if probes_max is not None and probes is None:
            raise ValueError("probes_max requires probes")
        self._pack = pack
        self._k = k
        self._batch = batch
        # each wave is padded up to q_tile: a default larger than the
        # batch would multiply the scan work per wave for nothing. A
        # multiple of 16, the GPU kernel's smallest query tile (the
        # pruned kernel's tiles divide q_tile)
        self._q_tile = (
            q_tile if q_tile is not None
            else min(512, max(16, -(-batch // 16) * 16))
        )
        self._oversample = oversample
        self._probes = probes
        self._probes_max = probes_max
        self._min_probe_batch = min_probe_batch
        self._interpret = interpret
        # dispatch on the pack flavor (single-chip vs mesh-sharded)
        from vector_database_tpu.ops.pallas_knn import PackedDB

        self._sharded = not isinstance(pack, PackedDB)

    @classmethod
    def from_vectors(cls, vectors, *, k: int = 10, batch: int = 1024,
                     **pack_kw) -> "PackedServer":
        """Pack ``vectors`` once (``pack_database(**pack_kw)``) and wrap
        the result; the steady-state serving constructor."""
        from vector_database_tpu.ops.pallas_knn import pack_database

        serve_kw = {}
        for key in ("q_tile", "oversample", "probes", "min_probe_batch",
                    "interpret"):
            if key in pack_kw:
                serve_kw[key] = pack_kw.pop(key)
        return cls(pack_database(vectors, **pack_kw), k=k, batch=batch,
                   **serve_kw)

    @property
    def batch(self) -> int:
        return self._batch

    @property
    def k(self) -> int:
        return self._k

    def set_probes(self, probes: int) -> None:
        """Retune the pruned operating point on a live server. With
        ``probes_max`` set this is free — the runtime-probes program is
        already compiled for every value in [1, probes_max]; without it
        the next pruned wave pays one fresh compile."""
        if self._probes is None:
            raise ValueError(
                "this server was built without probes=; construct a "
                "pruned server to tune one"
            )
        if self._probes_max is not None and probes > self._probes_max:
            raise ValueError(
                f"probes ({probes}) exceeds probes_max "
                f"({self._probes_max}); rebuild the server with a wider "
                "probes_max"
            )
        self._probes = probes

    def _serve(self, qdev, pruned: bool = True):
        kw = dict(
            k=self._k, q_tile=self._q_tile, oversample=self._oversample,
            interpret=self._interpret,
        )
        rt = pruned and self._probes_max is not None
        if not rt:
            kw["probes"] = self._probes if pruned else None
        if self._sharded:
            from vector_database_tpu.parallel.scan import sharded_scan_knn

            if rt:
                kw.update(probes=self._probes, probes_max=self._probes_max)
            return sharded_scan_knn(self._pack, qdev, **kw)
        from vector_database_tpu.ops.pallas_knn import (
            pallas_scan_knn_packed,
            pallas_scan_knn_packed_rt,
        )

        if rt:
            import jax.numpy as jnp

            return pallas_scan_knn_packed_rt(
                self._pack, qdev, jnp.int32(self._probes),
                probes_max=self._probes_max, **kw,
            )
        return pallas_scan_knn_packed(self._pack, qdev, **kw)

    def warmup(self) -> None:
        """Compile the serving program(s) off the request path. With
        ``min_probe_batch`` both the pruned and the full-scan fallback
        programs compile here."""
        d = self._pack.vectors.shape[2 if self._sharded else 1]
        self.query(np.zeros((self._batch, d), np.float32))
        if self._min_probe_batch is not None and self._min_probe_batch > 1:
            self.query(np.zeros((1, d), np.float32))

    def query(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN for any number of queries at ONE compiled shape:
        ``(rows [Q, k] int, scores [Q, k] f32)`` — squared distances
        (l2/cosine) or exact dots highest-first (ip)."""
        import jax.numpy as jnp

        queries = np.atleast_2d(np.asarray(queries, np.float32))
        q = queries.shape[0]
        if q == 0:
            return (
                np.zeros((0, self._k), np.int32),
                np.zeros((0, self._k), np.float32),
            )
        # dispatch every wave before materializing any: the programs
        # queue asynchronously, so device compute overlaps the host
        # transfers of the other waves
        waves = []
        for lo in range(0, q, self._batch):
            tile = queries[lo : lo + self._batch]
            real = tile.shape[0]
            if real < self._batch:
                tile = np.pad(tile, ((0, self._batch - real), (0, 0)))
            pruned = (
                self._min_probe_batch is None
                or real >= self._min_probe_batch
            )
            r, d2 = self._serve(jnp.asarray(tile), pruned=pruned)
            waves.append((r, d2, real))
        rows_out = [np.asarray(r)[:real] for r, _, real in waves]
        d_out = [np.asarray(d2)[:real] for _, d2, real in waves]
        return np.concatenate(rows_out), np.concatenate(d_out)
