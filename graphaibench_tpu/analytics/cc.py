"""Connected components: min-label propagation to fixpoint, plus the
Afforest sampling shortcut.

The reference ships Shiloach-Vishkin (omp_base.cc:5-50) and Afforest
(omp_afforest.cc) — both pointer-jumping schemes tuned for CPU/GPU
random access. The dense device formulation is label propagation with a
scatter-min per sweep plus pointer-jumping compression (comp = comp[comp])
which converges in O(log n) sweeps on most graphs.

:func:`connected_components_afforest` is the dense redesign of the
reference's sampling shortcut (omp_afforest.cc:28-72): link every vertex
through its first ``neighbor_rounds`` neighbors only (a dense (nv, r)
gather, no full-edge sweep), find the most-frequent resulting label =
the giant intermediate component, then finish on the REMAINDER. Where
the reference skips giant-component vertices inside its union-find loop,
the dense formulation CONTRACTS the giant set to one super-vertex and
runs the ordinary fixpoint on the contracted graph — freezing the giant
label instead would silently block label flow THROUGH the giant set
(two fringe chains joined only via the giant could keep distinct labels
when the giant's own id is larger than theirs)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.ops.device_graph import DeviceGraph
from graphaibench_tpu.ops.segment import neighbor_reduce


import functools


@functools.partial(jax.jit, static_argnames=("max_iter",))
def connected_components(g: DeviceGraph, *, max_iter: int | None = None) -> jnp.ndarray:
    """Component labels; label = min vertex id in the component.
    Assumes a symmetric (undirected) graph like the reference solvers."""
    nv = g.nv
    src, dst = g.edge_src, g.col_idx
    max_iter = nv if max_iter is None else max_iter

    def cond(state):
        _c, changed, it = state
        return changed & (it < max_iter)

    pull = g.has_ell_layout

    def body(state):
        comp, _, it = state
        # hook: take the min label over each vertex's neighborhood
        # (pull-mode dense bucket reduce when ELL is available, in place
        # of the (ne,)-scatter-min)
        if pull:
            cand = neighbor_reduce(g, comp, "min")
        else:
            cand = jnp.full(nv, nv, dtype=jnp.int32).at[dst].min(comp[src])
        new = jnp.minimum(comp, cand)
        # compress: pointer jumping
        new = new[new]
        new = new[new]
        return new, jnp.any(new != comp), it + 1

    comp0 = jnp.arange(nv, dtype=jnp.int32)
    comp, _, _ = jax.lax.while_loop(cond, body, (comp0, jnp.bool_(True), jnp.int32(0)))
    return comp


@functools.partial(jax.jit, static_argnames=("rounds",))
def _link_first_neighbors(nbr_r: jnp.ndarray, deg: jnp.ndarray,
                          rounds: int) -> jnp.ndarray:
    """Afforest phase 1 (omp_afforest.cc:28-40): one link per vertex per
    round through its r-th neighbor, compressed to a full pointer-jump
    fixpoint after each round (Compress, omp_afforest.cc:95-103). The
    min-hook keeps the invariant comp[u] = id of a vertex CONNECTED to u
    and comp[u] <= u, so after compression the most-frequent label c
    names a connected set whose minimum id is c itself."""
    nv = deg.shape[0]
    comp = jnp.arange(nv, dtype=jnp.int32)

    def compress(c):
        return jax.lax.while_loop(
            lambda c: jnp.any(c[c] != c), lambda c: c[c], c)

    for r in range(rounds):
        cand = jnp.where(deg > r, comp[nbr_r[:, r]], comp)
        comp = compress(jnp.minimum(comp, cand))
    return comp


def connected_components_afforest(
    g_host,
    *,
    neighbor_rounds: int = 2,
    giant_frac: float = 0.2,
) -> np.ndarray:
    """Connected components with the Afforest sampling shortcut
    (omp_afforest.cc:28-72), redesigned dense. Requires a
    structurally symmetric graph (the reference's undirected branch,
    omp_afforest.cc:47-56).

    1. Device: link through the first ``neighbor_rounds`` neighbors only
       — an (nv, r) gather per round instead of an all-edge sweep.
    2. Host: exact bincount finds the giant intermediate label c (the
       reference samples 1024 entries; nv int32 rows fetch in one go).
    3. Contract {comp==c} to a super-vertex, solve the contracted graph
       with the ordinary dense fixpoint, expand. Local ids are assigned
       in ascending original-id order so the contracted min-index labels
       ARE the global min-id labels.

    Falls back to the plain fixpoint when no giant component emerges
    (giant < giant_frac * nv), where contraction would buy nothing.
    """
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.csr import from_edges
    from graphaibench_tpu.ops.device_graph import to_device_graph

    nv, ne = g_host.nv, g_host.ne
    rp = np.asarray(g_host.row_ptr)
    ci = np.asarray(g_host.col_idx)
    deg = np.diff(rp)

    if nv == 0:
        return np.empty(0, np.int32)
    if ne == 0:
        # edgeless: identity labels (ci is empty, so the neighbor-table
        # gather below would index out of bounds)
        return np.arange(nv, dtype=np.int32)

    # phase 1: first-k neighbor table, (nv, rounds), self-padded
    k = neighbor_rounds
    pos = rp[:-1, None] + np.arange(k)[None, :]
    valid = pos < rp[1:, None]
    nbr = np.where(valid, ci[np.minimum(pos, max(ne - 1, 0))],
                   np.arange(nv)[:, None]).astype(np.int32)
    comp1 = np.asarray(_link_first_neighbors(
        jnp.asarray(nbr), jnp.asarray(deg.astype(np.int32)), k))

    c = int(np.bincount(comp1, minlength=nv).argmax())
    is_c = comp1 == c
    if int(is_c.sum()) < giant_frac * nv:
        dg = to_device_graph(g_host, with_transpose=False, with_ell=True)
        return np.asarray(connected_components(dg))

    # phase 2: contract the giant set, fixpoint on the remainder graph
    r_mask = ~is_c
    verts = np.nonzero(r_mask | (np.arange(nv) == c))[0]   # ascending ids
    local = np.empty(nv, np.int64)
    local[verts] = np.arange(len(verts))
    local[is_c] = local[c]
    edge_src = np.repeat(np.arange(nv), deg)
    keep = r_mask[edge_src]       # giant-internal edges are irrelevant;
    u_l = local[edge_src[keep]]   # giant<->R edges appear in R rows
    v_l = local[ci[keep]]         # (symmetric input)
    out = np.empty(nv, np.int32)
    if len(u_l):
        g2 = T.sort_and_clean(from_edges(
            np.r_[u_l, v_l], np.r_[v_l, u_l], len(verts)))
        dg2 = to_device_graph(g2, with_transpose=False, with_ell=True)
        comp_l = np.asarray(connected_components(dg2))
    else:
        comp_l = np.arange(len(verts), dtype=np.int32)
    rep = verts[comp_l].astype(np.int32)   # global min-id per component
    out[verts] = rep
    out[is_c] = rep[local[c]]
    return out
