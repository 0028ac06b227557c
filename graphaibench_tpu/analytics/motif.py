"""Pattern descriptors + motif counting (reference M8).

The reference ships a ``Pattern`` support class (src/common/pattern.cc:4–27
names 3/4-vertex patterns from (n, m, max_degree): wedge, triangle, 3-star,
4-path, tailed_triangle, square, diamond, 4-clique; :143–166 derives a
set-operation plan per pattern) but no benchmark on top of it. Here the
descriptor is reimplemented *and* given a real solver: exact 3-motif and
4-motif counts.

Dense formulation: every 4-vertex motif count is a closed-form
expression in dense-adjacency matmuls — the whole counter is matmuls
(A², CᵀC Gram over per-edge common-neighborhood indicators) instead of
the reference's per-vertex set-intersection plans. Counts are of
*non-induced* subgraphs (each vertex subset counted once per embedding up
to automorphism), with an induced conversion provided; both are verified
against a brute-force enumeration oracle in tests.

Graphs up to a few tens of thousands of vertices fit the dense path (n²
floats in device memory); triangle/wedge counts additionally work at any scale via
the sparse ``tc.triangle_count`` machinery.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph, from_edges

# canonical edge lists of the named patterns (vertices 0..n-1)
_PATTERN_EDGES = {
    "wedge": [(0, 1), (0, 2)],
    "triangle": [(0, 1), (0, 2), (1, 2)],
    "3-star": [(0, 1), (0, 2), (0, 3)],
    "4-path": [(0, 1), (1, 2), (2, 3)],
    "tailed_triangle": [(0, 1), (0, 2), (1, 2), (2, 3)],
    "square": [(0, 1), (1, 2), (2, 3), (0, 3)],
    "diamond": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3)],
    "4-clique": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
}


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A small connected pattern graph, named with the reference's
    taxonomy (pattern.cc:4–27: classify by vertex count n, edge count m
    and max degree)."""

    edges: tuple  # tuple[tuple[int, int], ...] undirected, deduped
    num_vertex_classes: int = 0

    @classmethod
    def from_name(cls, name: str) -> "Pattern":
        if name not in _PATTERN_EDGES:
            raise ValueError(f"unknown pattern {name!r}; known: "
                             f"{sorted(_PATTERN_EDGES)}")
        return cls(edges=tuple(_PATTERN_EDGES[name]))

    @classmethod
    def from_edges(cls, edges) -> "Pattern":
        es = {(min(u, v), max(u, v)) for u, v in edges if u != v}
        return cls(edges=tuple(sorted(es)))

    @property
    def n(self) -> int:
        return 1 + max(max(e) for e in self.edges)

    @property
    def m(self) -> int:
        return len(self.edges)

    @property
    def max_degree(self) -> int:
        deg = np.zeros(self.n, dtype=np.int64)
        for u, v in self.edges:
            deg[u] += 1
            deg[v] += 1
        return int(deg.max())

    @property
    def name(self) -> str:
        """Reference naming rule (pattern.cc:4–27)."""
        n, m, md = self.n, self.m, self.max_degree
        base = "unknown"
        if n == 3:
            base = "wedge" if m == 2 else "triangle"
        elif n == 4:
            if m == 3:
                base = "3-star" if md == 3 else "4-path"
            elif m == 4:
                base = "tailed_triangle" if md == 3 else "square"
            elif m == 5:
                base = "diamond"
            elif m == 6:
                base = "4-clique"
        if self.num_vertex_classes > 0:
            return f"{self.num_vertex_classes}labeled-{base}"
        return base

    def is_clique(self) -> bool:
        return self.m == self.n * (self.n - 1) // 2

    def to_graph(self) -> CSRGraph:
        src = np.array([e[0] for e in self.edges] + [e[1] for e in self.edges])
        dst = np.array([e[1] for e in self.edges] + [e[0] for e in self.edges])
        return from_edges(src, dst, self.n)


def _dense_adjacency(g: CSRGraph) -> np.ndarray:
    from graphaibench_tpu.graph.transforms import dense_adjacency

    return dense_adjacency(g)


def motif_counts(g: CSRGraph, k: int, *, edge_chunk: int = 4096) -> dict:
    """Exact non-induced counts of all connected k-vertex motifs.

    k=3: wedge, triangle. k=4 adds 3-star, 4-path, tailed_triangle,
    square (C4), diamond, 4-clique. All heavy terms are dense matmuls:

      A2 = A @ A                      (common-neighbor counts)
      tri_e = A2 ∘ A                  (triangles through each edge)
      24·K4 = Σ A ∘ (CᵀC),  C rows = a_u ∘ a_v per directed edge

    which keeps the counter in matmuls end to end (the reference instead
    derives per-pattern set-intersection plans, pattern.cc:143–166, and
    runs them on AVX/warp set ops).
    """
    if k not in (3, 4):
        raise ValueError("only 3- and 4-vertex motifs are supported")
    n = g.nv
    a_np = _dense_adjacency(g)
    deg = a_np.sum(1).astype(np.float64)
    m = float(deg.sum() / 2)

    A = jnp.asarray(a_np)
    A2 = A @ A
    tri_e = A2 * A                                   # (n, n)
    t_total = float(jnp.sum(tri_e)) / 6.0            # triangles
    # closed-form degree terms on host (f64 for exact big counts);
    # non-induced wedge = any two edges sharing a vertex
    wedges = float((deg * (deg - 1) / 2).sum())
    out = {"wedge": wedges, "triangle": t_total}
    if k == 3:
        return {kk: int(round(v)) for kk, v in out.items()}

    tri_v = np.asarray(jnp.sum(tri_e, axis=1), dtype=np.float64) / 2.0
    # 3-star: choose 3 neighbors of a center
    star3 = (deg * (deg - 1) * (deg - 2) / 6).sum()
    # 4-path: Σ_edges (d_u-1)(d_v-1) − 3·triangles
    src, dst = np.nonzero(np.triu(a_np))
    p4 = ((deg[src] - 1) * (deg[dst] - 1)).sum() - 3 * t_total
    # tailed triangle: a triangle vertex with a pendant edge
    tailed = (tri_v * (deg - 2)).sum()
    # square (C4): closed 4-walks minus degenerate ones
    closed4 = float(jnp.sum(A2 * A2))                # tr(A⁴)
    c4 = (closed4 - 2 * m - 2 * float((deg * (deg - 1)).sum())) / 8.0
    # diamond: two triangles sharing the chord edge (u,v)
    te = np.asarray(tri_e, dtype=np.float64)[src, dst]
    diamond = (te * (te - 1) / 2).sum()
    # 4-clique: Σ_{(u,v)∈E} edges within N(u)∩N(v) = 6·K4, via the Gram
    # matrix of per-edge common-neighborhood indicators c_e = a_u ∘ a_v:
    # Σ_{directed e} c_e c_eᵀ = CᵀC and 24·K4 = Σ A ∘ CᵀC.
    dsrc = np.concatenate([src, dst]).astype(np.int32)
    ddst = np.concatenate([dst, src]).astype(np.int32)
    ne_dir = len(dsrc)
    D = jnp.zeros((n, n), dtype=jnp.float32)
    for s in range(0, ne_dir, edge_chunk):
        e = min(s + edge_chunk, ne_dir)
        Cc = A[dsrc[s:e]] * A[ddst[s:e]]             # (chunk, n)
        D = D + Cc.T @ Cc
    k4 = float(jnp.sum(A * D)) / 24.0
    out.update({"3-star": star3, "4-path": p4, "tailed_triangle": tailed,
                "square": c4, "diamond": diamond, "4-clique": k4})
    return {kk: int(round(v)) for kk, v in out.items()}


# linear map from non-induced to induced counts (rows: pattern, columns:
# superpattern contributions — how many non-induced copies of `row` each
# induced `col` contains, for 4-vertex patterns)
_INDUCED_ORDER = ["3-star", "4-path", "square", "tailed_triangle",
                  "diamond", "4-clique"]
_SUPER = np.array([
    # 3-star 4-path square tailed diamond 4-clique
    [1, 0, 0, 1, 2, 4],    # 3-star copies inside each
    [0, 1, 4, 2, 6, 12],   # 4-path copies
    [0, 0, 1, 0, 1, 3],    # square copies
    [0, 0, 0, 1, 4, 12],   # tailed-triangle copies
    [0, 0, 0, 0, 1, 6],    # diamond copies
    [0, 0, 0, 0, 0, 1],    # 4-clique
], dtype=np.int64)


def induced_motif_counts(g: CSRGraph) -> dict:
    """Induced 4-motif counts, by inverting the containment matrix over
    the non-induced counts (plus wedge/triangle which coincide for k=3
    only through the triangle)."""
    ni = motif_counts(g, 4)
    b = np.array([ni[p] for p in _INDUCED_ORDER], dtype=np.int64)
    x = np.linalg.solve(_SUPER.astype(np.float64), b.astype(np.float64))
    out = {p: int(round(v)) for p, v in zip(_INDUCED_ORDER, x)}
    out["triangle"] = ni["triangle"]
    out["wedge"] = ni["wedge"] - 3 * ni["triangle"]  # open wedges
    return out


def count_pattern(g: CSRGraph, pattern, *, induced: bool = False) -> int:
    """Count occurrences of a named pattern (or Pattern object)."""
    p = Pattern.from_name(pattern) if isinstance(pattern, str) else pattern
    name = p.name
    if name not in _PATTERN_EDGES:
        raise ValueError(f"unsupported pattern {name!r}")
    k = p.n
    if induced and k == 4:
        counts = induced_motif_counts(g)
    else:
        counts = motif_counts(g, k)
        if induced and k == 3:
            # induced wedge = open wedge (triangles are already induced)
            counts = dict(counts)
            counts["wedge"] = counts["wedge"] - 3 * counts["triangle"]
    return counts[name]


def brute_force_motif_counts(g: CSRGraph, k: int) -> dict:
    """Serial enumeration oracle (tests only): classify every connected
    k-subset by its induced subgraph, then convert to non-induced."""
    import itertools

    a = _dense_adjacency(g).astype(bool)
    n = g.nv
    induced = {name: 0 for name in _PATTERN_EDGES if len(set(
        v for e in _PATTERN_EDGES[name] for v in e)) == k}
    names_by_sig = {}
    for name, edges in _PATTERN_EDGES.items():
        nn = 1 + max(max(e) for e in edges)
        if nn != k:
            continue
        for perm in itertools.permutations(range(k)):
            sig = frozenset((min(perm[u], perm[v]), max(perm[u], perm[v]))
                            for u, v in edges)
            names_by_sig[sig] = name
    for sub in itertools.combinations(range(n), k):
        es = frozenset((i, j) for i, j in itertools.combinations(range(k), 2)
                       if a[sub[i], sub[j]])
        name = names_by_sig.get(es)
        if name is not None:
            induced[name] += 1
    # convert induced -> non-induced
    if k == 3:
        return {"triangle": induced["triangle"],
                "wedge": induced["wedge"] + 3 * induced["triangle"]}
    vec = np.array([induced[p] for p in _INDUCED_ORDER], dtype=np.int64)
    ni = _SUPER @ vec
    out = {p: int(c) for p, c in zip(_INDUCED_ORDER, ni)}
    # triangles/wedges from the 3-motif oracle
    out.update(brute_force_motif_counts(g, 3))
    # also expose induced counts for direct checks
    out["_induced"] = induced
    return out
