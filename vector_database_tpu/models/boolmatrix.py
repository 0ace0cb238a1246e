"""Boolean property-matrix index — the KB/Akinator mode.

The reference project began as a binary search index identifying an object
from a set of objects by a set of boolean properties (reference
README.md:4-15: "a matrix of [objects x properties] with true or false in
cells"), later generalized to float vectors ("float can be represented as a
set of bits", README.md:18). This module is that original mode, on the device:

- properties are encoded ±1 and indexed with the same variance-split BSP
  tree (a boolean dimension's variance is p(1-p), so max-variance selection
  picks the most discriminating ~50/50 property — exactly the KB game's
  best-question heuristic);
- bits are also kept packed (uint32 words) for compact storage/export;
- Hamming distance maps exactly onto squared L2 over ±1 encodings
  (``L2² = 4·hamming``), so the float search machinery — pruned traversal +
  exact rerank, and the matmul brute-force scan — is reused bit-exactly
  (every quantity involved is a small integer, exact in float32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vector_database_tpu.builder import build_index_fused
from vector_database_tpu.ops.exact import pairwise_sq_dists
from vector_database_tpu.search import locate as bsp_locate
from vector_database_tpu.search import search as bsp_search


def pack_bits(matrix: np.ndarray) -> np.ndarray:
    """Pack a bool [N, P] matrix into uint32 words [N, ceil(P/32)]."""
    matrix = np.asarray(matrix, dtype=bool)
    n, p = matrix.shape
    words = (p + 31) // 32
    padded = np.zeros((n, words * 32), dtype=bool)
    padded[:, :p] = matrix
    bits = padded.reshape(n, words, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits << shifts).sum(axis=2, dtype=np.uint32)


def unpack_bits(packed: np.ndarray, p: int) -> np.ndarray:
    """Inverse of ``pack_bits``."""
    n, words = packed.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(n, words * 32)[:, :p].astype(bool)


class BoolMatrixIndex:
    """Index of objects by boolean property vectors.

    Args:
      matrix: ``[N, P]`` bool — objects x properties (README.md:13).
      leaf_size: BSP leaf bucket size.
    """

    def __init__(self, matrix, leaf_size: int = 8):
        matrix = np.asarray(matrix, dtype=bool)
        self.n, self.p = matrix.shape
        self.packed = pack_bits(matrix)
        signed = matrix.astype(np.float32) * 2.0 - 1.0
        # max-variance split at every level (not the reference's max/min
        # parity): for identification, each level asks the most
        # discriminating question, no zero-variance plane is ever chosen,
        # and single-branch descent (identify_batch) stays exact
        self._index = build_index_fused(
            signed, leaf_size=leaf_size, split="max"
        )

    @staticmethod
    def _signed(props) -> jnp.ndarray:
        props = np.atleast_2d(np.asarray(props, dtype=bool))
        return jnp.asarray(props.astype(np.float32) * 2.0 - 1.0)

    def find_hamming(self, props, max_dist: int):
        """All objects within Hamming distance ``max_dist`` of each query.

        Returns ``(rows, dists)`` lists per query (exact, via the pruned
        tree walk + rerank; L2 radius = 2·sqrt(h)).
        """
        q = self._signed(props)
        radius = 2.0 * float(np.sqrt(max_dist)) if max_dist > 0 else 0.0
        res = bsp_search(self._index, q, radius)
        out = []
        for qi in range(q.shape[0]):
            rows = np.asarray(res.rows[qi])
            d2 = np.asarray(res.sq_dists[qi])
            keep = rows >= 0
            out.append(
                (rows[keep], (d2[keep] / 4.0).round().astype(np.int32))
            )
        return out

    def identify(self, props) -> Optional[int]:
        """Exact-match identification: the object whose property vector
        equals ``props``, or None — the Akinator endgame (README.md:8)."""
        row = int(np.asarray(self.identify_batch(props))[0])
        return row if row >= 0 else None

    def identify_batch(self, props) -> jnp.ndarray:
        """Batched exact-match identification: ``[Q]`` object rows (-1
        where absent) by single-branch descent — one root→leaf path per
        query (``search.locate``; exact for ±1 encodings, where no query
        coordinate can lie on a split plane). The serving form of the
        endgame: ~depth lockstep steps per batch instead of a DFS."""
        return bsp_locate(self._index, self._signed(props))

    def knn_hamming(self, props, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact k-nearest by Hamming distance via one matmul scan
        (``[Q, N]`` ±1 dot products)."""
        q = self._signed(props)
        d2 = pairwise_sq_dists(q, self._index.vectors)
        kk = min(k, d2.shape[1])  # k > n pads like every other knn
        neg, pos = jax.lax.top_k(-d2, kk)
        rows = jnp.take_along_axis(
            jnp.broadcast_to(
                self._index.orig_row[None, :], d2.shape
            ),
            pos, axis=1,
        )
        rows = np.asarray(rows)
        ham = np.asarray((-neg / 4.0)).round().astype(np.int32)
        if kk < k:
            rows = np.pad(rows, ((0, 0), (0, k - kk)), constant_values=-1)
            ham = np.pad(
                ham, ((0, 0), (0, k - kk)),
                constant_values=np.iinfo(np.int32).max,
            )
        return rows, ham

    def best_question(self, candidate_rows=None) -> int:
        """The most discriminating property (closest to a 50/50 split) among
        the given candidate objects — the KB game's next question."""
        packed = self.packed if candidate_rows is None \
            else self.packed[np.asarray(candidate_rows, dtype=np.int64)]
        if packed.shape[0] == 0:
            # argmin over an all-NaN mean would silently return property
            # 0 — an empty candidate set has no discriminating question
            raise ValueError("best_question: empty candidate set")
        bits = unpack_bits(packed, self.p)
        frac = bits.mean(axis=0)
        return int(np.argmin(np.abs(frac - 0.5)))
