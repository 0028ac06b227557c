"""Frequent subgraph mining (FSM) on vertex-labeled graphs, k <= 3.

The reference ships FSM *support structures* (NLF tables, label reverse
index, labeled Pattern descriptors — graph.cc:1025-1120, pattern.cc:39-47,
MAX_PATTERN_SIZE common.h:55) but no FSM solver; this provides a real one
for patterns up to 3 vertices (labeled edges, wedges, triangles) with the
standard **MNI (minimum node image) support**: the support of a pattern
is the minimum over its vertices of the number of distinct graph vertices
that appear in that role across all embeddings — the anti-monotone
measure used by GraMi/Pangolin-style miners.

Dense formulation: every role-qualification predicate is a dense
matrix expression —
  * edge roles come straight from the NLF table,
  * wedge-end roles from one masked SpMM over the NLF indicator,
  * triangle roles from diag(A D_b A D_c A), two matmuls per label
    pair —
so the whole miner is a handful of batched matmuls instead of the
per-embedding exploration + hash maps of CPU miners.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.graph.labels import (_labels_of,
                                           neighborhood_label_frequency)


@dataclasses.dataclass(frozen=True)
class FrequentPattern:
    kind: str           # "edge" | "wedge" | "triangle"
    labels: tuple       # canonical label tuple (see each miner)
    support: int        # MNI support


def _dense_masks(g: CSRGraph, lab: np.ndarray, L: int):
    import jax.numpy as jnp

    from graphaibench_tpu.graph.transforms import dense_adjacency

    A = jnp.asarray(dense_adjacency(g))
    masks = jnp.asarray((lab[None, :] == np.arange(L)[:, None])
                        .astype(np.float32))           # (L, nv)
    return A, masks


def mine_edges(g: CSRGraph, labels=None, *, min_support: int = 1):
    """Frequent labeled edges (la, lb), la <= lb. Role counts come from
    the NLF table: vertex u hosts role la iff lab(u)=la and u has a
    lb-neighbor."""
    lab = _labels_of(g, labels)
    L = int(lab.max()) + 1
    nlf = neighborhood_label_frequency(g, lab)
    out = []
    for la in range(L):
        for lb in range(la, L):
            n_a = int(((lab == la) & (nlf[:, lb] > 0)).sum())
            n_b = int(((lab == lb) & (nlf[:, la] > 0)).sum())
            sup = min(n_a, n_b)
            if sup >= min_support:
                out.append(FrequentPattern("edge", (la, lb), sup))
    return out


def mine_wedges(g: CSRGraph, labels=None, *, min_support: int = 1):
    """Frequent labeled wedges (la - lb - lc), center lb, la <= lc.

    Center role: lab=lb with an la-neighbor and an lc-neighbor (two
    distinct ones when la == lc). End role (la side): lab=la with a
    lb-neighbor w whose lc-degree excluding u itself is >= 1."""
    import jax.numpy as jnp

    lab = _labels_of(g, labels)
    L = int(lab.max()) + 1
    nlf = neighborhood_label_frequency(g, lab)
    A, masks = _dense_masks(g, lab, L)
    nlf_j = jnp.asarray(nlf.astype(np.float32))
    out = []
    for lb in range(L):
        center_lb = lab == lb
        for la in range(L):
            for lc in range(la, L):
                if la == lc:
                    centers = center_lb & (nlf[:, la] >= 2)
                else:
                    centers = center_lb & (nlf[:, la] >= 1) & (nlf[:, lc] >= 1)
                n_center = int(centers.sum())
                if n_center < min_support:
                    continue

                def ends(l_end, l_other):
                    # u qualifies iff some lb-labeled neighbor w has an
                    # l_other neighbor besides u itself: w needs
                    # NLF[w][l_other] >= 2 when lab(u) == l_other (u is
                    # one of them), else >= 1
                    has1 = A @ (masks[lb] * (nlf_j[:, l_other] >= 1))
                    has2 = A @ (masks[lb] * (nlf_j[:, l_other] >= 2))
                    need2 = jnp.asarray(lab == l_other)
                    qual = jnp.where(need2, has2, has1) > 0
                    return int((np.asarray(qual) & (lab == l_end)).sum())

                n_a = ends(la, lc)
                n_c = ends(lc, la)
                sup = min(n_center, n_a, n_c)
                if sup >= min_support:
                    out.append(FrequentPattern("wedge", (la, lb, lc), sup))
    return out


def mine_triangles(g: CSRGraph, labels=None, *, min_support: int = 1):
    """Frequent labeled triangles {la, lb, lc} (sorted tuple). Role
    count for the la-vertex: lab=la vertices closing at least one
    (lb, lc) adjacent pair — diag(A D_lb A D_lc A) > 0."""
    import jax.numpy as jnp

    lab = _labels_of(g, labels)
    L = int(lab.max()) + 1
    A, masks = _dense_masks(g, lab, L)
    # part[b] = A * m_b rows-masked: D_b A
    out = []
    seen = set()
    for la in range(L):
        for lb in range(la, L):
            for lc in range(lb, L):
                key = (la, lb, lc)
                if key in seen:
                    continue
                seen.add(key)

                def role(l_self, l_o1, l_o2):
                    # d_u = diag((A D_o1)(A D_o2) A)_u = # adjacent
                    # (o1, o2)-labeled pairs both adjacent to u
                    P = (A * masks[l_o1][None, :]) @ (A * masks[l_o2][None, :])
                    d = jnp.einsum("ux,xu->u", P, A)
                    return int(((np.asarray(d) > 0) & (lab == l_self)).sum())

                n_a = role(la, lb, lc)
                n_b = role(lb, la, lc)
                n_c = role(lc, la, lb)
                sup = min(n_a, n_b, n_c)
                if sup >= min_support:
                    out.append(FrequentPattern("triangle", key, sup))
    return out


def fsm(g: CSRGraph, labels=None, *, min_support: int = 1,
        max_size: int = 3):
    """Mine all frequent labeled patterns up to ``max_size`` vertices."""
    out = list(mine_edges(g, labels, min_support=min_support))
    if max_size >= 3:
        out += mine_wedges(g, labels, min_support=min_support)
        out += mine_triangles(g, labels, min_support=min_support)
    return out
