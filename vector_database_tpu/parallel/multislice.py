"""Multi-host / multi-slice scaffolding: partitioned meshes and the
cross-slice index.

A "slice" here is a group of devices joined by a fast interconnect (the
cards of one host, all to all over NVLink); slices — or several hosts'
processes — are joined by a network ~2 orders of magnitude slower. The
design rule (SURVEY.md §2.2, scaling-book): *collectives that touch
per-row data stay inside a slice; only k-sized results cross slices.*
Concretely:

- within a slice: ``build_index_sharded`` psums per-level segment
  statistics and all-gathers [P, S] counts — O(S)-sized, every level —
  so its mesh must stay inside one slice;
- across slices: rows are *partitioned* (each slice owns n/slices rows
  and builds its own sharded global tree), and serving merges per-slice
  ``[Q, k]`` top-k results — the only cross-slice traffic.

The reference has no distributed story at all (single process, README.md
:89-98); this module is the scale-out axis on top of it.

Slices are an even partition of the device list (``n_slices``), which is
also how the 8-virtual-device tests exercise it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from vector_database_tpu.parallel.global_tree import (
    ShardedBSPIndex,
    _as_reader,
    _knn_global_async,
    build_index_sharded,
    make_sharded_rows,
    search_global,
)
from jax.sharding import Mesh

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Initialize multi-host JAX (one process per host, each seeing its
    local devices; ``jax.devices()`` becomes the global device list).

    Arguments default to the standard env vars (``JAX_COORDINATOR_ADDRESS``
    / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``); give all three — no
    cluster is detected automatically. Returns True if a multi-process
    runtime was initialized, False for the single-process no-op (so tests
    and single-host runs call it unconditionally).
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes is None:
        # single process: don't touch the runtime in the common local
        # case (extra kwargs still go to jax.distributed.initialize)
        if not kwargs:
            return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True
    return True


def slice_groups(
    devices: Optional[Sequence] = None, n_slices: Optional[int] = None
) -> List[List]:
    """Partition the device list evenly into ``n_slices`` groups (default
    one), in device order."""
    devices = list(jax.devices() if devices is None else devices)
    n_slices = n_slices or 1
    if len(devices) % n_slices:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_slices} slices"
        )
    per = len(devices) // n_slices
    return [devices[i * per : (i + 1) * per] for i in range(n_slices)]


def make_slice_meshes(
    n_slices: Optional[int] = None, axis: str = "data"
) -> List[Mesh]:
    """One 1-D mesh per slice."""
    return [
        Mesh(np.asarray(g), (axis,)) for g in slice_groups(n_slices=n_slices)
    ]


@dataclasses.dataclass
class MultiSliceIndex:
    """Rows partitioned across slices; one sharded global tree per slice.

    ``orig_row`` of slice s maps its local rows to global row ids via
    ``offsets[s]``. With several controller processes each holds only the
    slices its devices participate in (``slices[s] is None`` elsewhere);
    the query paths merge the per-slice [Q, k]-sized results across
    processes — the only cross-slice traffic.
    """

    slices: List[Optional[ShardedBSPIndex]]
    offsets: List[int]  # global row id of each slice's row 0
    n: int

    @property
    def num_slices(self) -> int:
        return len(self.slices)


def _participates(mesh: Mesh) -> bool:
    """Whether this process owns devices in ``mesh`` (and therefore must
    execute — and may only execute — that mesh's collectives)."""
    return jax.process_index() in {
        d.process_index for d in mesh.devices.flat
    }


def build_index_multislice(
    source,
    *,
    n: Optional[int] = None,
    n_slices: Optional[int] = None,
    axis: str = "data",
    leaf_size: int = 1,
    **build_kwargs,
) -> MultiSliceIndex:
    """Partition rows across slices and build one ``build_index_sharded``
    tree per slice — per-level collectives stay inside a slice; nothing
    row-sized ever crosses slices.

    ``source`` is a row source (full array, a store with ``.rows(start,
    count)``, or a callable ``(lo, hi) -> rows`` with ``n=``): each
    slice's build materializes ONLY its own rows, and within a slice each
    process loads only its shard (``make_sharded_rows``) — no host ever
    holds the full matrix (contrast the reference's abandoned all-in-RAM
    parallel build, README.md:91-98).

    With several hosts (``init_distributed`` + per-slice process placement)
    every process calls this with the same source description; it builds
    the slices its devices belong to and skips the rest — the returned
    index holds ``None`` for non-local slices, and the query paths merge
    results across processes.
    """
    reader, n = _as_reader(source, n)
    meshes = make_slice_meshes(n_slices, axis=axis)
    s = len(meshes)
    if n < s:
        raise ValueError(f"need at least {s} rows for {s} slices")
    bounds = np.linspace(0, n, s + 1).astype(np.int64)
    slices, offsets = [], []
    for mesh, lo, hi in zip(meshes, bounds[:-1], bounds[1:]):
        offsets.append(int(lo))
        if not _participates(mesh):
            slices.append(None)
            continue
        rows = make_sharded_rows(
            lambda a, b, lo=int(lo): reader(lo + a, lo + b), mesh,
            axis=axis, n=int(hi - lo),
        )
        slices.append(
            build_index_sharded(
                rows, mesh, axis=axis, leaf_size=leaf_size,
                **build_kwargs,
            )
        )
    return MultiSliceIndex(slices=slices, offsets=offsets, n=n)


def _cross_process_concat(rows, d2):
    """All-gather the host-side ``[Q, C]`` merge inputs across processes
    (the cross-host hop) and drop duplicate row ids per query — a slice whose
    devices span several processes reports identical replicated results
    on each of them."""
    if jax.process_count() == 1:
        return rows, d2
    from jax.experimental import multihost_utils

    g_rows = multihost_utils.process_allgather(rows)  # [P, Q, C]
    g_d2 = multihost_utils.process_allgather(d2)
    p, q, c = g_rows.shape
    rows = np.moveaxis(g_rows, 0, 1).reshape(q, p * c)
    d2 = np.moveaxis(g_d2, 0, 1).reshape(q, p * c)
    # dedupe replicated entries per query: keep the first occurrence of
    # each row id, vectorized (a Python double loop here costs millions
    # of dict ops per serving batch — host-bound)
    width = rows.shape[1]
    col = np.arange(width)[None, :].repeat(q, 0)
    # stable sort by row id preserves first-occurrence order within ties
    order = np.argsort(rows, axis=1, kind="stable")
    sr = np.take_along_axis(rows, order, 1)
    sc = np.take_along_axis(col, order, 1)
    sd = np.take_along_axis(d2, order, 1)
    first = np.ones_like(sr, bool)
    first[:, 1:] = sr[:, 1:] != sr[:, :-1]
    keep = first & (sr >= 0)
    # compact back into original candidate order: invalidate dups, then
    # stable-sort by (invalid, original column)
    inv_d = np.where(keep, sd, np.inf)
    inv_r = np.where(keep, sr, -1)
    back = np.argsort(
        np.where(keep, sc, width + sc), axis=1, kind="stable"
    )
    out_rows = np.take_along_axis(inv_r, back, 1)
    out_d2 = np.take_along_axis(inv_d, back, 1)
    return out_rows, out_d2


def knn_multislice(
    index: MultiSliceIndex,
    queries,
    k: int,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """k nearest within ``radius`` across all slices: per-slice sharded
    search + in-slice top-k merge, then an exact [Q, k]-sized cross-slice
    merge — host-side on one controller, a ``process_allgather`` (the
    only cross-host traffic) with several. Returns ``(rows [Q, k], sq_dists)`` with
    global row ids; identical on every process."""
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    q = queries.shape[0]
    # dispatch EVERY slice's search+merge before materializing any: the
    # per-slice host syncs otherwise serialize S sequential device
    # round-trips per serving batch
    pending = []
    for sl, off in zip(index.slices, index.offsets):
        if sl is None:
            continue
        r, d, ov = _knn_global_async(
            sl, queries, k, radius, max_leaves=max_leaves
        )
        pending.append((r, d, ov, off))
    parts_r, parts_d = [], []
    overflowed = 0
    for r, d, ov, off in pending:
        parts_r.append(np.where(np.asarray(r) >= 0, np.asarray(r) + off, -1))
        parts_d.append(np.asarray(d))
        overflowed += int(np.any(np.asarray(ov), axis=None))
    if overflowed:
        import warnings

        warnings.warn(
            f"knn_multislice: the per-shard leaf buffer overflowed in "
            f"{overflowed} slice(s); results may miss neighbors — raise "
            "max_leaves or use the sharded scan for non-selective "
            "queries.",
            RuntimeWarning,
            stacklevel=2,
        )
    if parts_r:
        rows = np.concatenate(parts_r, axis=1)
        d2 = np.concatenate(parts_d, axis=1)
    else:  # a process with no local slice still joins the allgather
        rows = np.full((q, 0), -1, np.int64)
        d2 = np.full((q, 0), np.inf, np.float32)
    # uniform width across processes for the allgather
    want = k * index.num_slices
    if rows.shape[1] < want:
        pad = want - rows.shape[1]
        rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        d2 = np.pad(d2, ((0, 0), (0, pad)), constant_values=np.inf)
    rows, d2 = _cross_process_concat(rows.astype(np.int64), d2)
    pick = np.argsort(d2, axis=1)[:, :k]
    out_rows = np.take_along_axis(rows, pick, axis=1)
    out_d2 = np.take_along_axis(d2, pick, axis=1)
    out_rows = np.where(np.isfinite(out_d2), out_rows, -1)
    return out_rows, out_d2


def search_multislice(
    index: MultiSliceIndex,
    queries,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """Exact ε-ball across slices: per-slice ``search_global`` results
    concatenated with global row ids (cross-process: allgathered and
    deduped, identical on every process). Returns ``(rows [Q, C],
    sq_dists [Q, C], count [Q], overflow [Q])``."""
    queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
    q = queries.shape[0]
    all_rows, all_d2, ovs = [], [], []
    for sl, off in zip(index.slices, index.offsets):
        if sl is None:
            continue
        rows, d2, cnt, ov = search_global(
            sl, queries, radius, max_leaves=max_leaves
        )
        rows = np.asarray(rows)
        all_rows.append(np.where(rows >= 0, rows + off, -1))
        all_d2.append(np.asarray(d2))
        ovs.append(np.asarray(ov))
    if all_rows:
        rows = np.concatenate(all_rows, axis=1)
        d2 = np.concatenate(all_d2, axis=1)
        ov = np.any(ovs, axis=0)
    else:
        rows = np.full((q, 0), -1, np.int64)
        d2 = np.full((q, 0), np.inf, np.float32)
        ov = np.zeros((q,), bool)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        # agree on a uniform candidate width before the gather
        want = int(
            np.max(multihost_utils.process_allgather(
                np.asarray(rows.shape[1], np.int64)
            ))
        )
        if rows.shape[1] < want:
            pad = want - rows.shape[1]
            rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
            d2 = np.pad(d2, ((0, 0), (0, pad)), constant_values=np.inf)
        rows, d2 = _cross_process_concat(rows.astype(np.int64), d2)
        ov = np.any(multihost_utils.process_allgather(ov), axis=0)
    count = np.sum(rows >= 0, axis=1)
    return rows, d2, count, ov
