"""vector_database_tpu — a vector index engine for accelerators (JAX).

A ground-up JAX/XLA/Pallas re-design of the capabilities of
nesterovsky-bros/vector-database (variance-split binary space partitioning
vector index; see /root/reference):

- ``build_index`` — level-synchronous BSP tree builder. One pass per tree
  level over the device-resident ``[N, D]`` vector matrix: segmented
  per-dimension mean/variance reduction, alternating max/min-stdev split
  dimension selection, and a stable segmented partition. This is the
  set-oriented formulation of the reference's ``dbo.BuildIndex``
  (DDL.sql:44-202) rather than the sequential tree walker
  (VectorIndex/IndexBuilder.cs:23-213), because whole-level reductions are
  what an accelerator runs well.
- ``search`` — batched frontier traversal: thousands of queries walk the
  tree in lockstep (masked dual-branch descent, the batched generalization
  of the recursive CTE in DDL.sql:234-295), followed by an exact-distance
  rerank. The index returns a candidate *superset*; exactness is enforced
  by the rerank — the same contract as the reference
  (MemoryVectorIndex.cs:237-241).
- ``MemoryVectorIndex`` — the incremental Add/Find/Remove bit-trie index
  (MemoryVectorIndex/MemoryVectorIndex.cs), with a batched device-side
  query path.
- ``DocumentStore`` — the document-scoped persistence layer
  (dbo.Document/dbo.Text/dbo.TextIndex + IndexDocument + Search,
  DDL.sql:204-419).
- ``parallel`` — multi-device build and query over a ``jax.sharding.Mesh``:
  data-axis sharded stats with ``psum`` merge (one global tree built in
  parallel), sharded queries with all-gather top-k merge.
"""

from vector_database_tpu.models.bsp import BSPIndex
from vector_database_tpu.builder import build_index, build_index_fused
from vector_database_tpu.search import (
    SearchResult,
    calibrate_radius,
    knn,
    locate,
    search,
)
from vector_database_tpu.models.memindex import MemoryVectorIndex
from vector_database_tpu.models.boolmatrix import BoolMatrixIndex
from vector_database_tpu.ops.exact import (
    exact_ball,
    exact_knn,
    exact_mips,
    normalize_rows,
)
from vector_database_tpu.ops.scan_knn import scan_knn
from vector_database_tpu.ops.pallas_knn import (
    calibrate_probes,
    pack_database,
    pallas_scan_knn,
    pallas_scan_knn_packed,
)
from vector_database_tpu.dynamic import DynamicIndex
from vector_database_tpu.serving import PackedServer
from vector_database_tpu.document_store import DocumentStore
from vector_database_tpu.out_of_core import ChunkedIndex

__version__ = "0.1.0"

__all__ = [
    "BSPIndex",
    "BoolMatrixIndex",
    "ChunkedIndex",
    "DocumentStore",
    "DynamicIndex",
    "MemoryVectorIndex",
    "PackedServer",
    "SearchResult",
    "build_index",
    "build_index_fused",
    "calibrate_probes",
    "calibrate_radius",
    "exact_ball",
    "exact_knn",
    "exact_mips",
    "knn",
    "normalize_rows",
    "locate",
    "pack_database",
    "pallas_scan_knn",
    "pallas_scan_knn_packed",
    "scan_knn",
    "search",
]
