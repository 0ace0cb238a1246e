"""Multi-device parallelism over a ``jax.sharding.Mesh``.

The reference is strictly single-process (SURVEY.md §2.2, §5: no NCCL/MPI,
no threads — the earlier parallel builder was abandoned, README.md:91-98).
This package is the scaling story it never had:

- **build**: rows sharded over the ``data`` mesh axis; per-level segment
  statistics merged with ``psum``/``pmin``/``pmax`` inside ``shard_map``.
  Two forms: the host-loop build (``ops/level.py`` via
  ``build_index(mesh=...)``, readable, one dispatch per level) and the
  production fused build (``global_tree.build_index_sharded``: the whole
  level loop in ONE compiled program, scatter-free, each device holding
  only its row shard — the >memory-per-device single-tree path).
- **query**: query-batch data parallelism (``search_sharded``),
  per-shard-forest search with an all-gather top-k merge (``forest.py``)
  for database sharding, and sharded-tree search/knn
  (``global_tree.search_global`` / ``knn_global``).
- **serve**: the sharded bucket scan (``scan.pack_database_sharded`` +
  ``scan.sharded_scan_knn``) — each device streams its 1/P of the packed
  database per batch, [Q, k] results merge with one all-gather; the QPS
  multiplier past one device's scan rate for high-dimensional data (where
  the measured crossover says trees prune nothing).
- **multi-host / multi-slice**: ``multislice.init_distributed`` (the
  ``jax.distributed`` entry point), per-slice meshes, and the
  cross-slice index (rows partitioned across slices; only [Q, k]-sized
  merges cross them).
"""

from vector_database_tpu.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    shard_rows,
)
from vector_database_tpu.parallel.query import search_sharded, knn_sharded
from vector_database_tpu.parallel.global_tree import (
    ShardedBSPIndex,
    ShardedRows,
    build_index_sharded,
    knn_global,
    make_sharded_rows,
    search_global,
    to_bsp,
)
from vector_database_tpu.parallel.scan import (
    ShardedPackedDB,
    calibrate_probes_sharded,
    pack_database_sharded,
    sharded_scan_knn,
)
from vector_database_tpu.parallel.multislice import (
    MultiSliceIndex,
    build_index_multislice,
    init_distributed,
    knn_multislice,
    make_slice_meshes,
    search_multislice,
    slice_groups,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_rows",
    "search_sharded",
    "knn_sharded",
    "ShardedBSPIndex",
    "ShardedRows",
    "build_index_sharded",
    "make_sharded_rows",
    "search_global",
    "knn_global",
    "to_bsp",
    "ShardedPackedDB",
    "calibrate_probes_sharded",
    "pack_database_sharded",
    "sharded_scan_knn",
    "MultiSliceIndex",
    "build_index_multislice",
    "init_distributed",
    "knn_multislice",
    "make_slice_meshes",
    "search_multislice",
    "slice_groups",
]
