"""Distributed analytics over a device mesh.

The multi-device analytics path of the reference (multigpu_base.cu:13-105:
Scheduler round-robin edge split + one worker per GPU + host-side sum,
and dist_cpu.cpp: MPI rank-strided vertices + MPI_Allreduce) re-expressed
as shard_map + psum: the DAG's padded neighbor table is replicated, the
edge list is sharded over the mesh axis, each shard counts its edges'
intersections locally, one psum produces the global count."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphaibench_tpu.graph import transforms as T
from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.parallel.halo import AXIS


def distributed_triangle_count(mesh: Mesh, g: CSRGraph, *, axis: str = AXIS) -> int:
    """Exact triangle count with edges sharded across the mesh."""
    dag = T.orientation(g)
    n_dev = mesh.devices.size
    sentinel = dag.nv + 1

    # padded neighbor table (replicated)
    W = max(dag.max_degree(), 1)
    deg = dag.degrees()
    starts = dag.row_ptr[:, None]
    offs = np.arange(W, dtype=np.int64)[None, :]
    in_row = offs < deg[:, None]
    pos = np.where(in_row, starts[: dag.nv] + offs, 0)
    nbr_np = np.where(in_row, dag.col_idx[pos], sentinel).astype(np.int32)

    # round-robin edge shard (Scheduler::round_robin semantics with
    # chunk = ceil(ne / P), i.e. contiguous balanced chunks)
    src_np, dst_np = dag.coo()
    per = -(-dag.ne // n_dev)
    tot = per * n_dev
    src_p = np.zeros(tot, dtype=np.int32)
    dst_p = np.zeros(tot, dtype=np.int32)
    valid = np.zeros(tot, dtype=bool)
    src_p[: dag.ne], dst_p[: dag.ne], valid[: dag.ne] = src_np, dst_np, True

    nbr = jnp.asarray(nbr_np)

    def local(src_c, dst_c, valid_c):
        a = nbr[src_c]
        b = nbr[dst_c]
        idx = jax.vmap(jnp.searchsorted)(b, a)
        idx = jnp.minimum(idx, b.shape[1] - 1)
        found = (jnp.take_along_axis(b, idx, axis=1) == a) & (a < sentinel)
        found &= valid_c[:, None]
        cnt = jnp.sum(found, dtype=jnp.int32)
        return jax.lax.psum(cnt, axis)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    ))
    sh = NamedSharding(mesh, P(axis))
    out = fn(jax.device_put(src_p, sh), jax.device_put(dst_p, sh),
             jax.device_put(valid, sh))
    return int(out)


def distributed_triangle_count_2d(mesh: Mesh, g: CSRGraph, *,
                                  axis: str = AXIS) -> int:
    """Exact triangle count on a 2-D (cluster x cluster) edge-block
    partition: device (i, j) of an s x s grid holds ONLY block (i, j)'s
    edges (graph.partition.partition_2d, the reference's partition2D
    semantics, graph_partition.cc:276-360) plus the two neighbor-table
    row SLICES those edges touch — per-device table memory O(nv/s)
    rows, vs the 1-D solver's replicated O(nv) table. This is the
    scaling shape for graphs whose padded neighbor table exceeds one
    device's memory.

    Uses the first s*s mesh devices with s = isqrt(n_dev)."""
    from graphaibench_tpu.graph.partition import partition_2d

    dag = T.orientation(g)
    n_dev = mesh.devices.size
    s = int(np.sqrt(n_dev))
    while s > 1 and s * s > n_dev:
        s -= 1
    sub = Mesh(mesh.devices.reshape(-1)[: s * s], (axis,))
    sentinel = dag.nv + 1

    # padded neighbor table rows (host; sliced per cluster below)
    W = max(dag.max_degree(), 1)
    deg = dag.degrees()
    starts = dag.row_ptr[:, None]
    offs = np.arange(W, dtype=np.int64)[None, :]
    in_row = offs < deg[:, None]
    pos = np.where(in_row, starts[: dag.nv] + offs, 0)
    nbr_np = np.where(in_row, dag.col_idx[pos], sentinel).astype(np.int32)

    # equal contiguous vertex clusters; rows padded so slices stack
    rows_per = -(-dag.nv // s)
    clusters = (np.arange(dag.nv, dtype=np.int64) // rows_per).astype(
        np.int64)
    blocks = partition_2d(dag, clusters, s)
    emax = max((len(b[0]) for b in blocks.values()), default=1)
    nbr_pad = np.full(((s * rows_per) + 1, W), sentinel, np.int32)
    nbr_pad[: dag.nv] = nbr_np  # +1 pad row for localized sentinel src

    src_p = np.zeros((s * s, emax), np.int32)
    dst_p = np.zeros((s * s, emax), np.int32)
    valid = np.zeros((s * s, emax), bool)
    tab_i = np.zeros((s * s, rows_per + 1, W), np.int32)
    tab_j = np.zeros((s * s, rows_per + 1, W), np.int32)
    for i in range(s):
        for j in range(s):
            d = i * s + j
            bs, bd = blocks.get((i, j), (np.zeros(0, np.int64),) * 2)
            n_e = len(bs)
            src_p[d, :n_e] = bs - i * rows_per         # local row ids
            dst_p[d, :n_e] = bd - j * rows_per
            valid[d, :n_e] = True
            tab_i[d] = nbr_pad[i * rows_per: (i + 1) * rows_per + 1]
            tab_j[d] = nbr_pad[j * rows_per: (j + 1) * rows_per + 1]

    def local(src_c, dst_c, valid_c, ti, tj):
        a = ti[0][src_c[0]]
        b = tj[0][dst_c[0]]
        idx = jax.vmap(jnp.searchsorted)(b, a)
        idx = jnp.minimum(idx, b.shape[1] - 1)
        found = (jnp.take_along_axis(b, idx, axis=1) == a) & (a < sentinel)
        found &= valid_c[0][:, None]
        cnt = jnp.sum(found, dtype=jnp.int32)
        return jax.lax.psum(cnt, axis)

    fn = jax.jit(jax.shard_map(
        local, mesh=sub,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    ))
    sh = NamedSharding(sub, P(axis))
    out = fn(jax.device_put(src_p, sh), jax.device_put(dst_p, sh),
             jax.device_put(valid, sh), jax.device_put(tab_i, sh),
             jax.device_put(tab_j, sh))
    return int(out)


def distributed_pagerank(mesh: Mesh, g: CSRGraph, rg: CSRGraph | None = None,
                         *, damp: float = 0.85, epsilon: float = 1e-4,
                         max_iter: int = 100, axis: str = AXIS):
    """PageRank with the rank vector and graph vertex-sharded over the
    mesh: one halo-exchange sharded SpMM per pull iteration (the
    multi-host analog of pr.pagerank — same constants as the reference,
    common.h:73-76). Returns (scores (nv,), iterations).

    The contribution edge weight 1/outdeg[u] is static, so it ships as
    the ShardedGraph's packed edge weights and rides the ELL overlap
    kernels; only the (nv_pad, 1) rank column moves per sweep. The
    whole fixpoint runs in ONE dispatch (lax.while_loop inside
    shard_map), with no blocking fetch per iteration."""
    from graphaibench_tpu.parallel.halo import halo_exchange
    from graphaibench_tpu.parallel.partition import build_sharded_graph
    from graphaibench_tpu.parallel.shard_ell import (
        build_shard_ell,
        pack_shard_values,
        shard_specs,
        slot_spmm_packed,
        strip_shard,
    )

    if rg is None:
        rg = T.reverse(g)
    nv = g.nv
    P_ = mesh.devices.size
    out_deg = np.maximum(g.degrees(), 1).astype(np.float32)
    # reverse edge (v -> u) carries original u -> v: weight 1/outdeg[u]
    w = (1.0 / out_deg[rg.col_idx]).astype(np.float32)
    sg = build_sharded_graph(rg, w, mesh.devices.size)
    nv_pad = sg.nv_pad
    se_own = build_shard_ell(sg, part="own", with_trans=False)
    se_halo = build_shard_ell(sg, part="halo", with_trans=False)
    layouts = {"se_own": se_own,
               "wp_own": pack_shard_values(se_own, sg.edge_w),
               "se_halo": se_halo,
               "wp_halo": pack_shard_values(se_halo, sg.edge_w)}
    base = (1.0 - damp) / nv

    def local(ly, send_idx, halo_map):
        ly = strip_shard(ly)
        p = jax.lax.axis_index(axis)
        own_valid = (p * nv_pad
                     + jnp.arange(nv_pad, dtype=jnp.int32)) < nv
        x0 = jnp.where(own_valid, jnp.float32(1.0 / nv), 0.0)[:, None]

        def cond(s):
            _x, err, it = s
            return (err >= epsilon) & (it < max_iter)

        def body(s):
            x, _, it = s
            halo = halo_exchange(x, send_idx[0], halo_map[0], axis=axis)
            inc = slot_spmm_packed(nv_pad, ly["se_own"], ly["wp_own"], x)
            if ly["se_halo"].fwd:
                inc = inc + slot_spmm_packed(nv_pad, ly["se_halo"],
                                             ly["wp_halo"], halo)
            new = jnp.where(own_valid[:, None], base + damp * inc, 0.0)
            err = jax.lax.psum(jnp.abs(new - x).sum(), axis)
            return new, err, it + 1

        x, _, it = jax.lax.while_loop(
            cond, body, (x0, jnp.float32(jnp.inf), jnp.int32(0)))
        return x, jax.lax.psum(it, axis) // P_

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(shard_specs(layouts, axis), P(axis, None, None),
                  P(axis, None)),
        out_specs=(P(axis, None), P()),
        check_vma=False,
    ))
    scores, it = fn(jax.tree.map(jnp.asarray, layouts),
                    jnp.asarray(sg.send_idx), jnp.asarray(sg.halo_map))
    return np.asarray(scores[:nv, 0]), int(it)


def _dist_pull_fixpoint(mesh, g: CSRGraph, init_fn, relax, *,
                        axis: str = AXIS, max_iters: int | None = None,
                        weights: np.ndarray | None = None):
    """Shared machinery for the distributed frontier solvers: iterate
    x_own <- relax(x_own, m) with m[r] = min over incoming edges (r<-c)
    of x_ext[c] (unweighted) or x_ext[c] + w(c->r) (``weights`` given:
    the tropical min-plus relaxation behind SSSP), until a psum'd change
    flag clears. The halo depths move with one all_to_all per sweep (the
    per-layer GNN exchange reused for analytics) and the pull reduction
    runs on the per-shard ELL buckets —
    the multi-host re-expression of the pull-mode solvers
    (analytics/traversal.py, omp_direction.cc:31)."""
    from graphaibench_tpu.parallel.halo import halo_exchange
    from graphaibench_tpu.parallel.partition import build_sharded_graph
    from graphaibench_tpu.parallel.shard_ell import (
        build_shard_ell,
        ell_gather_reduce,
        ell_gather_reduce_plus,
        pack_shard_values,
        shard_specs,
        strip_shard,
    )

    rg = T.reverse(g)
    P_ = mesh.devices.size
    if weights is not None:
        # reverse edge k carries the ORIGINAL edge's weight: the
        # transpose permutation maps rg's CSR order back to g's edge ids
        w_rev = np.asarray(weights, np.float32)[
            T.transpose_edge_permutation(g)]
    else:
        w_rev = np.ones(rg.ne, np.float32)
    sg = build_sharded_graph(rg, w_rev, P_)
    se = build_shard_ell(sg, with_trans=False)
    wp = pack_shard_values(se, sg.edge_w) if weights is not None else None
    nv_pad = sg.nv_pad
    limit = max_iters if max_iters is not None else g.nv + 1

    def local(se_s, wp_s, send_idx, halo_map):
        se_l = strip_shard(se_s)
        wp_l = None if wp_s is None else strip_shard(wp_s)
        p = jax.lax.axis_index(axis)
        gid = p * nv_pad + jnp.arange(nv_pad, dtype=jnp.int32)
        x0 = init_fn(gid)

        def cond(s):
            _x, changed, it = s
            return changed & (it < limit)

        def body(s):
            x, _, it = s
            halo = halo_exchange(x[:, None], send_idx[0], halo_map[0],
                                 axis=axis)
            x_ext = jnp.concatenate([x, halo[:, 0]])
            if wp_l is None:
                m = ell_gather_reduce(se_l.fwd, x_ext, nv_pad, "min",
                                      se_l.sentinel,
                                      bounds=se_l.fwd_bounds,
                                      groups=se_l.fwd_groups)
            else:
                m = ell_gather_reduce_plus(se_l.fwd, wp_l.fwd, x_ext,
                                           nv_pad, "min", se_l.sentinel,
                                           bounds=se_l.fwd_bounds,
                                      groups=se_l.fwd_groups)
            new = relax(x, m)
            changed = jax.lax.psum(
                jnp.any(new != x).astype(jnp.int32), axis) > 0
            return new, changed, it + 1

        x, _, it = jax.lax.while_loop(
            cond, body, (x0, jnp.bool_(True), jnp.int32(0)))
        return x, jax.lax.psum(it, axis) // P_

    se_spec = shard_specs(se, axis)
    wp_spec = None if wp is None else shard_specs(wp, axis)
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(se_spec, wp_spec, P(axis, None, None), P(axis, None)),
        out_specs=(P(axis), P()),
        check_vma=False,
    ))
    se_dev = jax.tree.map(jnp.asarray, se)
    wp_dev = None if wp is None else jax.tree.map(jnp.asarray, wp)
    x, iters = fn(se_dev, wp_dev, jnp.asarray(sg.send_idx),
                  jnp.asarray(sg.halo_map))
    return np.asarray(x)[: g.nv], int(iters)


_DIST_INF = np.int32(2**30)


def distributed_bfs(mesh: Mesh, g: CSRGraph, source: int, *,
                    axis: str = AXIS):
    """BFS depths with the graph vertex-sharded over the mesh: unit
    Bellman-Ford fixpoint (depth[v] <- min(depth[v], min_nbr+1)), one
    halo all_to_all per sweep. Returns (depths (nv,) int32 with
    unreachable == 2**30, sweeps)."""

    def init(gid):
        return jnp.where(gid == source, jnp.int32(0), _DIST_INF)

    def relax(x, m):
        return jnp.minimum(x, jnp.minimum(m, _DIST_INF - 1) + 1)

    return _dist_pull_fixpoint(mesh, g, init, relax, axis=axis)


def distributed_sssp(mesh: Mesh, g: CSRGraph, weights: np.ndarray,
                     source: int, *, axis: str = AXIS,
                     max_iters: int | None = None):
    """Single-source shortest paths with the graph vertex-sharded over
    the mesh: Bellman-Ford as a tropical min-plus fixpoint
    (dist[v] <- min(dist[v], min over in-edges (u->v) of
    dist[u] + w(u,v))) on pre-packed per-slot weights, one halo
    all_to_all per sweep — the multi-host twin of
    analytics/traversal.py sssp_bellman_ford (gpu_bellmanford.cu
    semantics). Returns (dist (nv,) float32 with unreachable == +inf,
    sweeps)."""

    def init(gid):
        return jnp.where(gid == source, jnp.float32(0.0),
                         jnp.float32(jnp.inf))

    def relax(x, m):
        return jnp.minimum(x, m)

    return _dist_pull_fixpoint(mesh, g, init, relax, axis=axis,
                               max_iters=max_iters, weights=weights)


def distributed_cc(mesh: Mesh, g: CSRGraph, *, axis: str = AXIS):
    """Connected components by min-label propagation (Shiloach-Vishkin's
    hook step iterated; labels = global vertex ids). Returns
    (labels (nv,), sweeps)."""

    def init(gid):
        return gid

    def relax(x, m):
        return jnp.minimum(x, m)

    return _dist_pull_fixpoint(mesh, g, init, relax, axis=axis)


def _build_dist_pull(mesh, g: CSRGraph, axis: str):
    """Common sharded-pull scaffolding: per-shard ELL over the reverse
    graph plus a halo sum-pull closure factory used by the k-core and
    BC solvers (psum'd control flags ride the while_loop carries — a
    collective inside a loop *cond* is not allowed under shard_map)."""
    from graphaibench_tpu.parallel.halo import halo_exchange
    from graphaibench_tpu.parallel.partition import build_sharded_graph
    from graphaibench_tpu.parallel.shard_ell import (
        build_shard_ell,
        ell_gather_reduce,
    )

    rg = T.reverse(g)
    sg = build_sharded_graph(rg, np.ones(rg.ne, np.float32),
                             mesh.devices.size)
    se = build_shard_ell(sg, with_trans=False)

    def make_sum_pull(se_l, send_idx, halo_map):
        def sum_pull(col):
            halo = halo_exchange(col[:, None], send_idx[0], halo_map[0],
                                 axis=axis)
            ext = jnp.concatenate([col, halo[:, 0]])
            return ell_gather_reduce(se_l.fwd, ext, sg.nv_pad, "sum",
                                     se_l.sentinel,
                                     bounds=se_l.fwd_bounds,
                                      groups=se_l.fwd_groups)
        return sum_pull

    return sg, se, make_sum_pull


def distributed_kcore(mesh: Mesh, g: CSRGraph, *, axis: str = AXIS):
    """Coreness of every vertex with the graph sharded over the mesh:
    the bulk-peeling nested fixpoint (analytics/kcore.py,
    src/coreness/omp_base.cc:11-60) with live degrees recomputed by one
    halo sum-pull per peel sweep. Expects a symmetric graph. Returns
    (coreness (nv,) int32, peel levels)."""
    from graphaibench_tpu.parallel.shard_ell import shard_specs, strip_shard

    sg, se, make_sum_pull = _build_dist_pull(mesh, g, axis)
    nv, nv_pad = g.nv, sg.nv_pad
    P_ = mesh.devices.size

    def local(se_s, send_idx, halo_map):
        se_l = strip_shard(se_s)
        sum_pull = make_sum_pull(se_l, send_idx, halo_map)
        p = jax.lax.axis_index(axis)
        own_valid = (p * nv_pad
                     + jnp.arange(nv_pad, dtype=jnp.int32)) < nv

        def live_deg(alive):
            return jnp.where(alive, sum_pull(alive.astype(jnp.int32)), 0)

        alive0 = own_valid
        deg0 = live_deg(alive0)
        more0 = jax.lax.psum(jnp.any(alive0).astype(jnp.int32), axis) > 0

        def outer_body(s):
            core, alive, deg, k, _ = s

            def inner_body(t):
                core, alive, deg, _ = t
                peel = alive & (deg <= k)
                core = jnp.where(peel, k, core)
                alive = alive & ~peel
                deg = live_deg(alive)
                changed = jax.lax.psum(
                    jnp.any(peel).astype(jnp.int32), axis) > 0
                return core, alive, deg, changed

            core, alive, deg, _ = jax.lax.while_loop(
                lambda t: t[3], inner_body,
                (core, alive, deg, jnp.bool_(True)))
            more = jax.lax.psum(jnp.any(alive).astype(jnp.int32), axis) > 0
            return core, alive, deg, k + 1, more

        core, _, _, k, _ = jax.lax.while_loop(
            lambda s: s[4], outer_body,
            (jnp.zeros(nv_pad, jnp.int32), alive0, deg0, jnp.int32(0),
             more0))
        return core, jax.lax.psum(k, axis) // P_

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(shard_specs(se, axis), P(axis, None, None),
                  P(axis, None)),
        out_specs=(P(axis), P()),
        check_vma=False,
    ))
    core, k = fn(jax.tree.map(jnp.asarray, se), jnp.asarray(sg.send_idx),
                 jnp.asarray(sg.halo_map))
    return np.asarray(core)[:nv], int(k)


def distributed_bc(mesh: Mesh, g: CSRGraph, sources, *, axis: str = AXIS):
    """Betweenness centrality (Brandes) with the graph sharded over the
    mesh: level-synchronous forward sigma propagation and backward
    dependency accumulation, each sweep one halo sum-pull — the
    multi-host twin of analytics/bc.py (src/centrality/omp_base.cc:8-110
    semantics, symmetric graphs). Returns accumulated BC (nv,) float32
    over the given sources."""
    from graphaibench_tpu.parallel.shard_ell import shard_specs, strip_shard

    sg, se, make_sum_pull = _build_dist_pull(mesh, g, axis)
    nv, nv_pad = g.nv, sg.nv_pad

    def local(se_s, send_idx, halo_map, source):
        se_l = strip_shard(se_s)
        sum_pull = make_sum_pull(se_l, send_idx, halo_map)
        p = jax.lax.axis_index(axis)
        gid = p * nv_pad + jnp.arange(nv_pad, dtype=jnp.int32)

        # forward: depths + shortest-path counts
        def f_body(s):
            dist, sigma, front, lvl, _ = s
            reach = sum_pull(jnp.where(front, sigma, 0.0))
            new = (reach > 0) & (dist < 0)
            sigma = jnp.where(new, reach, sigma)
            dist = jnp.where(new, lvl + 1, dist)
            go = jax.lax.psum(jnp.any(new).astype(jnp.int32), axis) > 0
            return dist, sigma, new, lvl + 1, go

        dist0 = jnp.where(gid == source, 0, -1).astype(jnp.int32)
        sigma0 = jnp.where(gid == source, 1.0, 0.0)
        dist, sigma, _, max_lvl, _ = jax.lax.while_loop(
            lambda s: s[4], f_body,
            (dist0, sigma0, gid == source, jnp.int32(0), jnp.bool_(True)))

        # backward: delta accumulation level by level (max_lvl is equal
        # on every shard — the forward loop's trip count is collective;
        # the forward loop overshoots by one empty level, so start at
        # max_lvl - 1: the deepest level that actually has vertices)
        def b_body(s):
            delta, lvl = s
            val = jnp.where((dist == lvl) & (sigma > 0),
                            (1.0 + delta)
                            / jnp.where(sigma > 0, sigma, 1.0), 0.0)
            acc = sum_pull(val)
            add = jnp.where(dist == lvl - 1, sigma * acc, 0.0)
            return delta + add, lvl - 1

        delta, _ = jax.lax.while_loop(
            lambda s: s[1] > 0, b_body,
            (jnp.zeros(nv_pad), jnp.maximum(max_lvl - 1, 0)))
        return jnp.where(gid == source, 0.0, delta)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(shard_specs(se, axis), P(axis, None, None),
                  P(axis, None), P()),
        out_specs=P(axis),
        check_vma=False,
    ))
    se_dev = jax.tree.map(jnp.asarray, se)
    si, hm = jnp.asarray(sg.send_idx), jnp.asarray(sg.halo_map)
    bc = np.zeros(nv, np.float32)
    for s in sources:
        bc += np.asarray(fn(se_dev, si, hm, jnp.int32(s)))[:nv]
    return bc
