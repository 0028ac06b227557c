"""Labeled-graph support: NLF, label reverse index, labeled motifs.

The reference's mining graph carries vertex labels with three FSM-support
structures (include/graph.h + src/common/graph.cc:1025–1120): the
neighborhood label frequency (NLF) table, per-label vertex frequency, and
the label reverse index (vertices grouped by label). Pattern descriptors
can be labeled (src/common/pattern.cc:39–47). This module provides the
same capabilities as dense device operations:

  * NLF is computed as one SpMM — adjacency times a one-hot label matrix
    replaces the reference's per-vertex hash maps.
  * labeled wedge/triangle counts reduce to matmuls over label-projected
    adjacency slices.
"""

from __future__ import annotations

import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph


def _labels_of(g: CSRGraph, labels=None) -> np.ndarray:
    lab = labels if labels is not None else g.vlabels
    if lab is None:
        raise ValueError("graph has no vertex labels")
    return np.asarray(lab, dtype=np.int32)


def num_labels(g: CSRGraph, labels=None) -> int:
    return int(_labels_of(g, labels).max()) + 1


def label_frequency(g: CSRGraph, labels=None) -> np.ndarray:
    """(L,) count of vertices per label (GraphT::labels_frequency)."""
    lab = _labels_of(g, labels)
    return np.bincount(lab, minlength=int(lab.max()) + 1).astype(np.int64)


def label_index(g: CSRGraph, labels=None) -> dict[int, np.ndarray]:
    """label -> sorted vertex ids (the reverse index, graph.cc:1080-1100)."""
    lab = _labels_of(g, labels)
    order = np.argsort(lab, kind="stable")
    sorted_lab = lab[order]
    bounds = np.searchsorted(sorted_lab, np.arange(int(lab.max()) + 2))
    return {l: order[bounds[l]:bounds[l + 1]]
            for l in range(int(lab.max()) + 1)
            if bounds[l + 1] > bounds[l]}


def neighborhood_label_frequency(g: CSRGraph, labels=None,
                                 device: bool = True) -> np.ndarray:
    """(nv, L) NLF table: entry (v, l) = #neighbors of v with label l.

    On device this is one SpMM against a one-hot label matrix;
    the reference builds per-vertex hash maps (GraphT::computeLabelsFrequency).
    """
    lab = _labels_of(g, labels)
    L = int(lab.max()) + 1
    if device and g.ne > 0:
        import jax.numpy as jnp

        onehot = jnp.zeros((g.nv, L), jnp.float32).at[
            jnp.arange(g.nv), jnp.asarray(lab)].set(1.0)
        src = jnp.asarray(g.edge_sources())
        dst = jnp.asarray(g.col_idx)
        nlf = jnp.zeros((g.nv, L), jnp.float32).at[src].add(onehot[dst])
        return np.asarray(nlf).astype(np.int32)
    nlf = np.zeros((g.nv, L), dtype=np.int32)
    np.add.at(nlf, g.edge_sources(), np.eye(L, dtype=np.int32)[lab[g.col_idx]])
    return nlf


def nlf_match(nlf_g: np.ndarray, nlf_p: np.ndarray) -> np.ndarray:
    """FSM/subgraph-matching pruning filter: graph vertex v can host
    pattern vertex u only if NLF_g[v] >= NLF_p[u] elementwise.
    Returns a (nv, np) boolean candidate matrix."""
    L = max(nlf_g.shape[1], nlf_p.shape[1])
    a = np.zeros((nlf_g.shape[0], L), np.int32)
    a[:, : nlf_g.shape[1]] = nlf_g
    b = np.zeros((nlf_p.shape[0], L), np.int32)
    b[:, : nlf_p.shape[1]] = nlf_p
    return (a[:, None, :] >= b[None, :, :]).all(-1)


def labeled_triangle_counts(g: CSRGraph, labels=None) -> dict:
    """Exact triangle counts per unordered label triple {la, lb, lc}.

    Dense formulation: project the adjacency onto per-label column
    slices and contract — sum over (la<=lb<=lc) of
    tr(A[la,lb] @ A[lb,lc] @ A[lc,la]) with multiplicity handling.
    """
    import jax.numpy as jnp

    from graphaibench_tpu.graph.transforms import dense_adjacency

    lab = _labels_of(g, labels)
    L = int(lab.max()) + 1
    A = jnp.asarray(dense_adjacency(g))
    masks = [jnp.asarray((lab == l).astype(np.float32)) for l in range(L)]

    def proj(p, q):  # A restricted to label-p rows / label-q columns
        return A * masks[p][:, None] * masks[q][None, :]

    out = {}
    for la in range(L):
        for lb in range(la, L):
            ab = proj(la, lb)
            for lc in range(lb, L):
                # ordered closed walks u(la) -> v(lb) -> w(lc) -> u:
                # tr(A_ab A_bc A_ca) = sum(A_ab * (A_bc @ A_ca)^T)
                tri = float(jnp.sum(ab * (proj(lb, lc) @ proj(lc, la)).T))
                # one unordered triangle is counted once per vertex
                # ordering consistent with the label multiset
                div = {3: 1.0, 2: 2.0, 1: 6.0}[len({la, lb, lc})]
                cnt = int(round(tri / div))
                if cnt:
                    out[(la, lb, lc)] = cnt
    return out
