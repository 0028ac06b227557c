"""BFS and SSSP as dense edge-parallel fixpoint iterations.

Dense replacement for the reference's worklist solvers
(src/traversal: SlidingQueue + CAS push BFS omp_base.cc:8-57,
direction-optimizing omp_direction.cc, Bellman-Ford/delta-stepping
SSSP): here a sparse frontier buys nothing — every step is a full
edge-parallel scatter — so the worklist machinery collapses into dense
frontier vectors updated with scatter-min/max inside lax.while_loop.
The direction-optimizing push/pull switch is likewise moot (push and
pull are the same dense pass), which is the dense answer to that
optimization (``bfs_frontier`` adds the sparse side for high-diameter
graphs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.ops.device_graph import DeviceGraph
from graphaibench_tpu.ops.segment import (
    neighbor_reduce,
    pack_neighbor_edge_vals,
)


def _has_buckets(g: DeviceGraph) -> bool:
    return g.has_ell_layout


@jax.jit
def bfs(g: DeviceGraph, source: int) -> jnp.ndarray:
    """Level-synchronous BFS. Returns int32 depths, -1 if unreachable.

    Jitted at the def site: the eager path RETRACES AND RECOMPILES the
    while_loop body on every call (tens of seconds for the 20-bucket
    seg-ELL body at rmat19).

    With ELL buckets the sweep runs in PULL mode (min-plus neighbor
    reduce over dense degree buckets — the dense translation of the
    reference's direction-optimizing pull pass, omp_direction.cc:31);
    the (ne,)-scatter push formulation is the bucket-less fallback.
    Pull assumes a symmetric graph (the reference BFS inputs are)."""
    nv = g.nv

    if _has_buckets(g):
        big = jnp.int32(1 << 30)

        def cond_p(state):
            _d, changed, _it = state
            return changed

        def body_p(state):
            dist, _, it = state
            du = jnp.where(dist < 0, big, dist)
            # +1 AFTER the reach test: the min-identity (INT_MAX) on
            # edgeless/unreached rows would wrap negative
            cand = neighbor_reduce(g, du, "min")
            new = jnp.where((dist < 0) & (cand < big), cand + 1, dist)
            return new, jnp.any(new != dist), it + 1

        dist0 = jnp.full(nv, -1, dtype=jnp.int32).at[source].set(0)
        dist, _, _ = jax.lax.while_loop(
            cond_p, body_p, (dist0, jnp.bool_(True), jnp.int32(0)))
        return dist

    src, dst = g.edge_src, g.col_idx

    def cond(state):
        _dist, frontier, _level = state
        return jnp.any(frontier)

    def body(state):
        dist, frontier, level = state
        # push step: any edge from a frontier vertex reaches dst
        reached = (
            jnp.zeros(nv, dtype=jnp.int32)
            .at[dst]
            .max(frontier[src].astype(jnp.int32))
        )
        new = (reached > 0) & (dist < 0)
        dist = jnp.where(new, level + 1, dist)
        return dist, new, level + 1

    dist0 = jnp.full(nv, -1, dtype=jnp.int32).at[source].set(0)
    frontier0 = jnp.zeros(nv, dtype=bool).at[source].set(True)
    dist, _, _ = jax.lax.while_loop(cond, body, (dist0, frontier0, jnp.int32(0)))
    return dist


@functools.partial(jax.jit, static_argnames=("max_iter",))
def sssp_bellman_ford(
    g: DeviceGraph, weights: jnp.ndarray, source: int, *, max_iter: int | None = None
) -> jnp.ndarray:
    """Bellman-Ford to fixpoint (the reference's gpu_bellmanford shape).
    Returns float32 distances, inf unreachable."""
    nv = g.nv
    src, dst = g.edge_src, g.col_idx
    inf = jnp.float32(jnp.inf)
    max_iter = nv if max_iter is None else max_iter

    def cond(state):
        _dist, changed, it = state
        return changed & (it < max_iter)

    # Pull-mode relaxes dist[r] via row-r ELL slots, whose edge ids are
    # the OUTGOING edges (r->j); the correct relaxation weight is the
    # reverse edge's, w(j->r). On a structurally symmetric graph
    # trans_perm[k] is exactly the edge id of edge k's reversal, so
    # gathering weights through it feeds each slot the incoming weight
    # (identical to `weights` when weights are symmetric). Without the
    # transpose permutation pull would silently mis-relax asymmetric
    # weights, so fall back to the always-correct push scatter.
    pull = _has_buckets(g) and g.trans_perm is not None
    # pre-packed into the slot layout: one gather per CALL, not per sweep
    w_pull = (pack_neighbor_edge_vals(g, weights[g.trans_perm], "min")
              if pull else None)

    def body(state):
        dist, _, it = state
        if pull:
            cand = neighbor_reduce(g, dist, "min", edge_vals=w_pull)
        else:
            cand = jnp.full(nv, inf).at[dst].min(dist[src] + weights)
        new = jnp.minimum(dist, cand)
        return new, jnp.any(new < dist), it + 1

    dist0 = jnp.full(nv, inf).at[source].set(0.0)
    dist, _, _ = jax.lax.while_loop(cond, body, (dist0, jnp.bool_(True), jnp.int32(0)))
    return dist


def sssp_delta_stepping(
    g: DeviceGraph, weights: jnp.ndarray, source: int, *,
    delta: float | None = None, max_outer: int | None = None,
) -> jnp.ndarray:
    if delta is None:
        # host-side default (a traced mean would block jit caching)
        delta = float(jnp.mean(weights)) + 1e-9 if weights.size else 1.0
    return _sssp_delta_jit(g, weights, source, float(delta),
                           g.nv if max_outer is None else max_outer)


@functools.partial(jax.jit, static_argnames=("max_outer",))
def _sssp_delta_jit(
    g: DeviceGraph, weights: jnp.ndarray, source: int,
    delta: float, max_outer: int,
) -> jnp.ndarray:
    """Delta-stepping SSSP (the reference's omp_dstep.cc / gpu_dstep.cu)
    as a dense bucketed fixpoint.

    Buckets are processed in distance order; within a bucket only edges
    whose source is currently settled into the bucket relax (light edges
    iterate to an inner fixpoint, then heavy edges relax once). Here
    the buckets do not save wall-clock over Bellman-Ford on low-diameter
    graphs (every relaxation sweep is full-width anyway) but they bound
    the number of sweeps by max_weight/delta + diameter instead of nv on
    high-diameter weighted graphs, and keep parity with the reference's
    algorithm roster. Returns float32 distances, inf unreachable."""
    nv = g.nv
    src, dst = g.edge_src, g.col_idx
    inf = jnp.float32(jnp.inf)
    delta = jnp.float32(delta)
    light = weights <= delta
    # pull slots carry OUTGOING edge ids; relaxation needs the reverse
    # edge's weight/mask — gather both through trans_perm (see
    # sssp_bellman_ford), else fall back to push
    pull = _has_buckets(g) and g.trans_perm is not None
    if pull:
        w_pull = weights[g.trans_perm]
        light_pull = light[g.trans_perm]
        # two static masked variants, pre-packed into the slot layout
        # once per call (the per-sweep edge-id gather is loop-invariant)
        w_light = pack_neighbor_edge_vals(
            g, jnp.where(light_pull, w_pull, inf), "min")
        w_heavy = pack_neighbor_edge_vals(
            g, jnp.where(~light_pull, w_pull, inf), "min")
    else:
        w_light = w_heavy = None

    def relax(dist, active, mask, packed_w):
        """One relaxation of edges with src active (+ static edge mask)."""
        if pull:
            cand = neighbor_reduce(
                g, jnp.where(active, dist, inf), "min", edge_vals=packed_w)
        else:
            contrib = jnp.where(active[src] & mask, dist[src] + weights, inf)
            cand = jnp.full(nv, inf).at[dst].min(contrib)
        return jnp.minimum(dist, cand)

    def outer_cond(state):
        dist, k, it = state
        return (k < jnp.inf) & (it < max_outer)

    def outer_body(state):
        dist, k, it = state

        # inner fixpoint over light edges of this bucket (the active
        # mask is recomputed each relaxation — vertices can fall INTO
        # the current bucket mid-phase)
        def inner_cond(s):
            d, changed = s
            return changed

        def inner_body(s):
            d, _ = s
            act = (d >= k * delta) & (d < (k + 1) * delta)
            nd = relax(d, act, light, w_light)
            return nd, jnp.any(nd < d)

        dist, _ = jax.lax.while_loop(inner_cond, inner_body, (dist, jnp.bool_(True)))
        # heavy edges once
        act = (dist >= k * delta) & (dist < (k + 1) * delta)
        dist = relax(dist, act, ~light, w_heavy)
        # advance to the next non-empty bucket
        remaining = jnp.where(dist >= (k + 1) * delta, dist, jnp.inf)
        nk = jnp.where(jnp.isfinite(remaining).any(),
                       jnp.floor(jnp.min(remaining) / delta), jnp.inf)
        return dist, nk, it + 1

    dist0 = jnp.full(nv, inf).at[source].set(0.0)
    dist, _, _ = jax.lax.while_loop(
        outer_cond, outer_body, (dist0, jnp.float32(0.0), jnp.int32(0)))
    return dist


@functools.partial(jax.jit, static_argnames=("edge_budget",))
def bfs_frontier(g: DeviceGraph, source: int, *,
                 edge_budget: int | None = None) -> jnp.ndarray:
    """Frontier-density-adaptive BFS — the dense/sparse translation of the
    reference's direction-optimizing switch (omp_direction.cc:31).

    Each level, the frontier's total out-degree picks the sweep kernel
    inside one jitted while_loop (lax.cond):

    * sparse: compact the frontier (jnp.nonzero with a static size),
      expand its CSR adjacency slices into a fixed pow2 edge buffer —
      slot->row mapping via scatter-delta + cumsum (integer-exact),
      not per-slot binary search (200x slower on the chip this was
      tuned on) — and scatter level+1 at the destinations. Work per sweep is
      O(nv + edge_budget) instead of O(E_padded).
    * dense: the full pull-mode neighbor_reduce sweep (or the (ne,)
      scatter when no ELL buckets exist).

    On a high-diameter graph the dense fixpoint does diameter x O(E)
    work on near-empty frontiers; here those sweeps cost edge_budget.
    Default budget: ne/16 rounded up to pow2 (>= 2^14). Correct on
    directed and undirected graphs (the sparse kernel pushes over
    out-edges; the dense pull kernel is only used with ELL buckets,
    which the caller builds for symmetric inputs only)."""
    nv, ne = g.nv, g.ne
    if edge_budget is None:
        edge_budget = max(1 << 14, 1 << int(np.ceil(np.log2(max(ne, 16) / 16))))
    edge_budget = min(edge_budget, max(ne, 1))
    big = jnp.int32(1 << 30)
    deg_pad = jnp.concatenate([g.deg.astype(jnp.int32),
                               jnp.zeros(1, jnp.int32)])   # ids==nv pad
    row_ptr = g.row_ptr.astype(jnp.int32)
    has_ell = _has_buckets(g)
    src, dst = g.edge_src, g.col_idx

    n_ids = min(nv, edge_budget)   # deg>0 frontier rows <= frontier edges

    def sparse_sweep(dist, frontier, level):
        ids = jnp.nonzero(frontier & (g.deg > 0), size=n_ids,
                          fill_value=nv)[0].astype(jnp.int32)
        degs = deg_pad[ids]
        offs = jnp.cumsum(degs)                      # (n_ids,) ends
        total = offs[-1]
        # slot -> compacted-row: +1 delta at each row's END offset
        delta = jnp.zeros(edge_budget, jnp.int32).at[offs].add(
            1, mode="drop")
        row = jnp.cumsum(delta)                      # (edge_budget,)
        degs_r = degs[row]
        start = offs[row] - degs_r
        pos = jnp.arange(edge_budget, dtype=jnp.int32) - start
        srcv = ids[row]
        valid = (jnp.arange(edge_budget, dtype=jnp.int32)
                 < jnp.minimum(total, edge_budget)) & (pos < degs_r)
        edge = row_ptr[jnp.where(valid, srcv, 0)] + jnp.where(valid, pos, 0)
        dstv = jnp.where(valid, dst[edge], nv)       # nv = dropped
        reached = jnp.zeros(nv + 1, jnp.bool_).at[dstv].set(
            True, mode="drop")[:nv]
        new = reached & (dist < 0)
        return jnp.where(new, level + 1, dist), new

    def dense_sweep(dist, _frontier, level):
        if has_ell:
            du = jnp.where(dist < 0, big, dist)
            cand = neighbor_reduce(g, du, "min")
            new = (dist < 0) & (cand < big)
        else:
            reached = (jnp.zeros(nv, jnp.int32).at[dst]
                       .max((dist[src] >= 0).astype(jnp.int32)))
            new = (reached > 0) & (dist < 0)
        return jnp.where(new, level + 1, dist), new

    def cond(state):
        _dist, frontier, _level = state
        return jnp.any(frontier)

    def body(state):
        dist, frontier, level = state
        front_edges = jnp.sum(jnp.where(frontier, g.deg.astype(jnp.int32), 0))
        dist, new = jax.lax.cond(
            front_edges <= edge_budget,
            lambda d, f, l: sparse_sweep(d, f, l),
            lambda d, f, l: dense_sweep(d, f, l),
            dist, frontier, level)
        return dist, new, level + 1

    dist0 = jnp.full(nv, -1, jnp.int32).at[source].set(0)
    frontier0 = jnp.zeros(nv, bool).at[source].set(True)
    dist, _, _ = jax.lax.while_loop(cond, body, (dist0, frontier0,
                                                 jnp.int32(0)))
    return dist


def bfs_host(g_host, source: int) -> np.ndarray:
    """Convenience: device BFS from a host CSRGraph. Pull-mode (ELL) only
    when the graph is structurally symmetric — on a directed graph row
    buckets hold out-neighbors, so pulling over them computes the wrong
    reachability; those inputs take the push/scatter path."""
    from graphaibench_tpu.graph.transforms import is_symmetric
    from graphaibench_tpu.ops.device_graph import to_device_graph

    pull_ok = is_symmetric(g_host)
    dg = to_device_graph(g_host, with_transpose=False, with_ell=pull_ok)
    return np.asarray(bfs(dg, source))
