"""Betweenness centrality: Brandes with dense level-synchronous phases.

The reference's BCSolver (src/centrality/omp_base.cc:8-110) runs a
parallel BFS recording depth + path counts, then a backward dependency
accumulation over depth buckets with bitmap successors. This version
keeps the same two phases but each is a full edge-parallel scatter pass
inside lax.while_loop — depths replace buckets, masks replace bitmaps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from graphaibench_tpu.ops.device_graph import DeviceGraph
from graphaibench_tpu.ops.segment import neighbor_reduce


@jax.jit
def bc_single_source(g: DeviceGraph, source: int) -> jnp.ndarray:
    """Dependency contributions of one source (Brandes)."""
    nv = g.nv
    src, dst = g.edge_src, g.col_idx
    pull = g.has_ell_layout

    # ---- forward: depths + shortest-path counts -------------------------
    # pull mode: reach[v] = sum of sigma over frontier neighbors, a dense
    # bucket reduce (symmetric graph) instead of an (ne,)-scatter-add
    def f_cond(state):
        _d, _sig, frontier, _lvl = state
        return jnp.any(frontier)

    def f_body(state):
        dist, sigma, frontier, lvl = state
        if pull:
            reach = neighbor_reduce(
                g, jnp.where(frontier, sigma, 0.0), "sum")
        else:
            contrib = jnp.where(frontier[src], sigma[src], 0.0)
            reach = jax.ops.segment_sum(contrib, dst, num_segments=nv)
        new = (reach > 0) & (dist < 0)
        sigma = jnp.where(new, reach, sigma)
        dist = jnp.where(new, lvl + 1, dist)
        return dist, sigma, new, lvl + 1

    dist0 = jnp.full(nv, -1, jnp.int32).at[source].set(0)
    sigma0 = jnp.zeros(nv).at[source].set(1.0)
    front0 = jnp.zeros(nv, bool).at[source].set(True)
    dist, sigma, _, max_lvl = jax.lax.while_loop(
        f_cond, f_body, (dist0, sigma0, front0, jnp.int32(0))
    )

    # ---- backward: delta accumulation level by level --------------------
    def b_cond(state):
        _delta, lvl = state
        return lvl > 0

    def b_body(state):
        delta, lvl = state
        if pull:
            # add[u] = sigma[u] * sum_{v in N(u), dist[v]==lvl}
            #          (1+delta[v])/sigma[v]  — neighbor-side condition
            # folds into the pulled value, row-side applies after
            val = jnp.where((dist == lvl) & (sigma > 0),
                            (1.0 + delta) / jnp.where(sigma > 0, sigma, 1.0),
                            0.0)
            acc = neighbor_reduce(g, val, "sum")
            add = jnp.where(dist == lvl - 1, sigma * acc, 0.0)
            return delta + add, lvl - 1
        # edges u -> v with dist[v] == dist[u] + 1 and dist[u] == lvl - 1
        on_level = (dist[src] == lvl - 1) & (dist[dst] == lvl)
        w = jnp.where(
            on_level & (sigma[dst] > 0),
            sigma[src] / jnp.where(sigma[dst] > 0, sigma[dst], 1.0)
            * (1.0 + delta[dst]),
            0.0,
        )
        add = jax.ops.segment_sum(w, src, num_segments=nv)
        return delta + add, lvl - 1

    # the forward loop overshoots by one empty level (its last iteration
    # discovers nothing), so start at max_lvl - 1: the deepest level
    # that actually has vertices — saves one full no-op sweep
    delta, _ = jax.lax.while_loop(b_cond, b_body,
                                  (jnp.zeros(nv), jnp.maximum(max_lvl - 1, 0)))
    return delta.at[source].set(0.0)


def betweenness_centrality(g: DeviceGraph, sources) -> jnp.ndarray:
    """Accumulated BC over the given source set."""
    bc = jnp.zeros(g.nv)
    for s in sources:
        bc = bc + bc_single_source(g, int(s))
    return bc
