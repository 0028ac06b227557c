"""Minimum spanning forest: Boruvka rounds with dense scatter-min.

The reference ships a GPU Boruvka with ComponentSpace + global barriers
(src/filtering/main.cu:10-40). The dense shape here: each round, every
component picks its lightest outgoing edge with one segment-min over the
edge list (ties broken by edge id for determinism), the chosen edges
join the forest, and components merge by min-label propagation. O(log V)
rounds, each a dense edge-parallel pass."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.ops.device_graph import to_device_graph


def boruvka_mst(g: CSRGraph, weights: np.ndarray):
    """Returns (edge_ids, total_weight): indices into g's CSR edge order
    forming a minimum spanning forest. ``g`` must be symmetric; each
    undirected edge may be reported via either direction."""
    dg = to_device_graph(g, with_transpose=False, with_ell=False)
    nv, ne = g.nv, g.ne
    src, dst = dg.edge_src, dg.col_idx
    w = jnp.asarray(np.asarray(weights, dtype=np.float64))
    # Symmetric tie-free keys: rank UNDIRECTED edges by (weight, lo, hi)
    # so both directions of an edge share one key and equal weights still
    # order strictly — Boruvka's no-cycle argument then holds exactly.
    s_np, d_np = g.coo()
    lo = np.minimum(s_np, d_np).astype(np.int64)
    hi = np.maximum(s_np, d_np).astype(np.int64)
    pair_ids, inverse = np.unique(np.stack([lo, hi], 1), axis=0,
                                  return_inverse=True)
    w_np = np.asarray(weights, dtype=np.float64)
    pair_w = np.full(len(pair_ids), np.inf)
    np.minimum.at(pair_w, inverse, w_np)
    pair_rank = np.zeros(len(pair_ids), dtype=np.int32)
    pair_rank[np.argsort(pair_w, kind="stable")] = np.arange(len(pair_ids), dtype=np.int32)
    key = jnp.asarray(pair_rank[inverse])

    INF = jnp.int32(np.iinfo(np.int32).max)

    def cond(state):
        _comp, _in_mst, changed, it = state
        return changed & (it < nv)

    def body(state):
        comp, in_mst, _, it = state
        cu, cv = comp[src], comp[dst]
        cross = cu != cv
        k = jnp.where(cross, key, INF)
        # lightest outgoing edge per component
        best = jnp.full(nv, INF, dtype=jnp.int32).at[cu].min(k)
        chosen_k = best[cu]
        picked = cross & (k == chosen_k) & (best[cu] != INF)
        eid = jnp.arange(ne, dtype=jnp.int32)
        in_mst = in_mst | jnp.zeros(ne, bool).at[jnp.where(picked, eid, 0)].max(picked)
        # merge: hook each component to the smaller label across picked edges
        new_comp = comp
        lab = jnp.full(nv, nv, dtype=jnp.int32).at[cu].min(
            jnp.where(picked, jnp.minimum(cu, cv), nv)
        )
        new_comp = jnp.where(lab < nv, jnp.minimum(comp, lab[comp]), comp)
        # also hook the other endpoint's component
        lab2 = jnp.full(nv, nv, dtype=jnp.int32).at[cv].min(
            jnp.where(picked, jnp.minimum(cu, cv), nv)
        )
        new_comp = jnp.where(lab2[new_comp] < nv,
                             jnp.minimum(new_comp, lab2[new_comp]), new_comp)
        for _ in range(2):  # pointer jumping compression
            new_comp = new_comp[new_comp]
        changed = jnp.any(new_comp != comp)
        return new_comp, in_mst, changed, it + 1

    comp0 = jnp.arange(nv, dtype=jnp.int32)
    comp, in_mst, _, _ = jax.lax.while_loop(
        cond, body, (comp0, jnp.zeros(ne, bool), jnp.bool_(True), jnp.int32(0))
    )
    ids = np.nonzero(np.asarray(in_mst))[0]
    # deduplicate reverse twins: keep each undirected edge once
    s, d = np.asarray(src)[ids], np.asarray(dst)[ids]
    lo, hi = np.minimum(s, d), np.maximum(s, d)
    _, uniq = np.unique(np.stack([lo, hi], 1), axis=0, return_index=True)
    ids = ids[np.sort(uniq)]
    total = float(np.asarray(weights)[ids].sum())
    return ids, total


def kruskal_oracle(g: CSRGraph, weights: np.ndarray) -> float:
    """Serial Kruskal total weight (union-find) — the verifier."""
    src, dst = g.coo()
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    pairs = np.stack([lo.astype(np.int64), hi.astype(np.int64)], 1)
    _, uniq = np.unique(pairs, axis=0, return_index=True)
    order = uniq[np.argsort(weights[uniq], kind="stable")]
    parent = np.arange(g.nv)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    total = 0.0
    for e in order:
        a, b = find(src[e]), find(dst[e])
        if a != b:
            parent[a] = b
            total += float(weights[e])
    return total
