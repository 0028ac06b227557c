"""Immutable host-side CSR graph container.

The moral equivalent of the reference's two graph classes —
``LearningGraph`` (include/gnn/lgraph.h) and ``GraphT`` (include/graph.h) —
collapsed into one numpy-backed container. All mutating operations of the
reference (add_selfloop, orientation, symmetrize, masked subgraph, ...)
become pure functions in :mod:`graphaibench_tpu.graph.transforms` that
return new ``CSRGraph`` instances.

Design notes:
  * ``row_ptr`` is int64 on host to match the on-disk format
    (graph.vertex.bin is 8-byte offsets, reference reader.cpp:414-457),
    but device-side code shards graphs so that per-shard offsets fit in
    int32 (device index arrays are int32 throughout).
  * ``col_idx`` is int32 (the reference's vidType is 4-byte,
    include/graph.h).
  * adjacency lists are kept sorted ascending (the reference sorts /
    assumes sorted lists for set intersection and selfloop insertion).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """A directed graph in CSR form. An undirected graph is stored
    symmetrized (each undirected edge appears in both adjacency lists),
    matching the reference's convention.
    """

    row_ptr: np.ndarray  # int64, shape (num_vertices + 1,)
    col_idx: np.ndarray  # int32, shape (num_edges,)
    # Optional payloads mirroring the reference's vlabels/elabels/weights.
    vlabels: Optional[np.ndarray] = None  # uint8/int32, shape (nv,)
    elabels: Optional[np.ndarray] = None  # per-edge labels/weights
    # For bipartite graphs (reference BipartiteGraph, graph.cc:194-197):
    # number of "left" vertices; None for ordinary graphs.
    n_left: Optional[int] = None
    n_right: Optional[int] = None

    def __post_init__(self):
        rp = np.ascontiguousarray(self.row_ptr, dtype=np.int64)
        ci = np.ascontiguousarray(self.col_idx, dtype=np.int32)
        object.__setattr__(self, "row_ptr", rp)
        object.__setattr__(self, "col_idx", ci)
        if rp.ndim != 1 or ci.ndim != 1:
            raise ValueError("row_ptr/col_idx must be 1-D")
        if rp[0] != 0 or rp[-1] != len(ci):
            raise ValueError(
                f"bad CSR: row_ptr[0]={rp[0]} row_ptr[-1]={rp[-1]} ne={len(ci)}"
            )

    # -- basic accessors (GraphT::size/sizeEdges/get_degree/N) ------------
    @property
    def num_vertices(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.col_idx)

    @property
    def nv(self) -> int:
        return self.num_vertices

    @property
    def ne(self) -> int:
        return self.num_edges

    def degrees(self) -> np.ndarray:
        """Out-degree of every vertex (int32)."""
        return np.diff(self.row_ptr).astype(np.int32)

    def max_degree(self) -> int:
        if self.nv == 0:
            return 0
        return int(np.diff(self.row_ptr).max())

    def neighbors(self, v: int) -> np.ndarray:
        """Adjacency list of v (a view)."""
        return self.col_idx[self.row_ptr[v] : self.row_ptr[v + 1]]

    def is_bipartite(self) -> bool:
        return self.n_left is not None

    # -- derived representations -----------------------------------------
    def coo(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) int32 arrays — the reference's init_edgelist
        (graph.cc:751-795) without symmetry breaking."""
        src = np.repeat(
            np.arange(self.nv, dtype=np.int32), self.degrees()
        )
        return src, self.col_idx.copy()

    def edge_sources(self) -> np.ndarray:
        """Per-edge source vertex (int32), aligned with col_idx."""
        return np.repeat(np.arange(self.nv, dtype=np.int32), self.degrees())

    def has_sorted_neighbors(self) -> bool:
        d = np.diff(self.col_idx)
        # positions where a new row starts may decrease; mask them out
        row_starts = np.zeros(len(self.col_idx), dtype=bool)
        rp = self.row_ptr[1:-1]
        row_starts[rp[rp < len(self.col_idx)]] = True
        return bool(np.all((d >= 0) | row_starts[1:]))

    def __repr__(self) -> str:  # pragma: no cover
        b = f", bipartite {self.n_left}x{self.n_right}" if self.is_bipartite() else ""
        return f"CSRGraph(|V|={self.nv}, |E|={self.ne}{b})"


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_vertices: int,
    *,
    sort_neighbors: bool = True,
    elabels: Optional[np.ndarray] = None,
) -> CSRGraph:
    """Build a CSRGraph from a COO edge list (no dedup)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if elabels is None and len(src) >= 1 << 18:
        from graphaibench_tpu import native
        if native.available():
            rp, ci = native.build_csr(src, dst, num_vertices,
                                      sort_neighbors=sort_neighbors)
            return CSRGraph(row_ptr=rp, col_idx=ci)
    if sort_neighbors:
        order = np.lexsort((dst, src))
    else:
        order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    if elabels is not None:
        elabels = np.asarray(elabels)[order]
    counts = np.bincount(src, minlength=num_vertices)
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSRGraph(row_ptr=row_ptr, col_idx=dst.astype(np.int32), elabels=elabels)
