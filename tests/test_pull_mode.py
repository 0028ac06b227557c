"""Pull-mode (ELL neighbor_reduce) frontier kernels vs serial oracles —
the same checks test_analytics runs on the scatter fallback, but with
degree-bucketed layouts present (plain AND column-segmented), which is
the path large graphs actually take."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from graphaibench_tpu.analytics import verifiers
from graphaibench_tpu.analytics.bc import bc_single_source
from graphaibench_tpu.analytics.cc import connected_components
from graphaibench_tpu.analytics.kcore import k_core
from graphaibench_tpu.analytics.pr import pagerank
from graphaibench_tpu.analytics.traversal import (
    bfs,
    sssp_bellman_ford,
    sssp_delta_stepping,
)
from graphaibench_tpu.graph import transforms as T
from graphaibench_tpu.graph.generators import rmat, uniform_random
from graphaibench_tpu.ops.device_graph import build_seg_ell, to_device_graph
from graphaibench_tpu.ops.segment import neighbor_reduce


@pytest.fixture(scope="module", params=["ell", "seg"])
def graphs(request):
    g = T.sort_and_clean(T.symmetrize(rmat(8, 6, seed=11)))
    # transpose perm rides along: pull-mode SSSP needs it to gather each
    # slot's reverse-edge weight (without it SSSP falls back to push)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    if request.param == "seg":
        dg = dataclasses.replace(dg, ell=(),
                                 seg_ell=build_seg_ell(g, seg_rows=64))
    return g, dg


def test_neighbor_reduce_matches_scatter(graphs):
    g, dg = graphs
    rng = np.random.default_rng(0)
    vals = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    src, dst = g.coo()
    for kind, red in (("sum", np.add), ("min", np.minimum),
                      ("max", np.maximum)):
        got = np.asarray(neighbor_reduce(dg, vals, kind))
        ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[kind]
        want = np.full(g.nv, ident, np.float32)
        np_vals = np.asarray(vals)
        for s, d in zip(src, dst):
            want[s] = red(want[s], np_vals[d])
        # segmented accumulation reorders the f32 sums
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bfs_pull(graphs):
    g, dg = graphs
    dist = np.asarray(bfs(dg, 0))
    np.testing.assert_array_equal(dist, verifiers.bfs_serial(g, 0))


def test_sssp_pull(graphs):
    g, dg = graphs
    rng = np.random.default_rng(1)
    # symmetric weights: same value for (u,v) and (v,u)
    src, dst = g.coo()
    key = np.minimum(src, dst) * g.nv + np.maximum(src, dst)
    w = (rng.random(g.nv * g.nv)[key] + 0.1).astype(np.float32)
    ref = verifiers.dijkstra_serial(g, w, 0)
    got_bf = np.asarray(sssp_bellman_ford(dg, jnp.asarray(w), 0))
    np.testing.assert_allclose(got_bf, ref, rtol=1e-5)
    got_ds = np.asarray(sssp_delta_stepping(dg, jnp.asarray(w), 0))
    np.testing.assert_allclose(got_ds, ref, rtol=1e-5)


def test_sssp_pull_asymmetric_weights(graphs):
    """Symmetric STRUCTURE, asymmetric WEIGHTS: w(u->v) != w(v->u).
    Pull-mode relaxation must use the reverse edge's weight (gathered
    through trans_perm) — using the slot's own outgoing weight silently
    computed wrong distances."""
    g, dg = graphs
    rng = np.random.default_rng(7)
    w = (rng.random(g.ne) + 0.1).astype(np.float32)   # per-edge, direction-dependent
    ref = verifiers.dijkstra_serial(g, w, 0)
    got_bf = np.asarray(sssp_bellman_ford(dg, jnp.asarray(w), 0))
    np.testing.assert_allclose(got_bf, ref, rtol=1e-5)
    got_ds = np.asarray(sssp_delta_stepping(dg, jnp.asarray(w), 0))
    np.testing.assert_allclose(got_ds, ref, rtol=1e-5)


def test_pr_pull(graphs):
    g, dg = graphs
    scores, _ = pagerank(dg)
    ref = verifiers.pagerank_serial(g, g)
    np.testing.assert_allclose(np.asarray(scores), ref, atol=1e-4)


def test_cc_pull(graphs):
    g, dg = graphs
    comp = np.asarray(connected_components(dg))
    np.testing.assert_array_equal(comp, verifiers.cc_serial(g))


def test_bc_pull(graphs):
    g, dg = graphs
    scores = np.asarray(bc_single_source(dg, 0))
    np.testing.assert_allclose(scores, verifiers.bc_serial(g, [0]),
                               rtol=1e-4, atol=1e-6)


def test_kcore_pull(graphs):
    g, dg = graphs
    core = np.asarray(k_core(dg))
    np.testing.assert_array_equal(core, verifiers.kcore_serial(g))


def test_frontier_oracles_at_scale():
    """One mid-scale (rmat12, ~4k v / ~50k e) oracle pass over the
    integrated auto layout — the scale-regression guard (a pull-kernel
    bug visible only on skewed
    many-bucket layouts would pass the rmat8 tests)."""
    g = T.sort_and_clean(T.symmetrize(rmat(12, 12, seed=3)))
    dg = to_device_graph(g, with_transpose=False, with_ell=True)
    dist = np.asarray(bfs(dg, 0))
    np.testing.assert_array_equal(dist, verifiers.bfs_serial(g, 0))
    comp = np.asarray(connected_components(dg))
    np.testing.assert_array_equal(comp, verifiers.cc_serial(g))
    scores, _ = pagerank(dg)
    np.testing.assert_allclose(np.asarray(scores),
                               verifiers.pagerank_serial(g, g), atol=1e-4)
    core = np.asarray(k_core(dg))
    np.testing.assert_array_equal(core, verifiers.kcore_serial(g))


def test_bfs_frontier_hybrid():
    """Frontier-adaptive BFS (direction-optimizing analog): equality with
    the serial oracle across dense+sparse switches, on symmetric (ELL
    pull fallback), directed (scatter fallback), and a high-diameter
    path graph where almost every sweep takes the compacted kernel."""
    from graphaibench_tpu.analytics.traversal import bfs_frontier
    from graphaibench_tpu.analytics import verifiers
    from graphaibench_tpu.graph.csr import from_edges
    from graphaibench_tpu.graph.generators import rmat

    # symmetric power-law, tiny budget to force dense->sparse switching
    g = T.sort_and_clean(T.symmetrize(rmat(9, 8, seed=5)))
    dg = to_device_graph(g, with_transpose=False, with_ell=True)
    for budget in (1 << 6, 1 << 10, None):
        got = np.asarray(bfs_frontier(dg, 3, edge_budget=budget))
        np.testing.assert_array_equal(got, verifiers.bfs_serial(g, 3), budget)

    # directed (no ELL): sparse kernel pushes out-edges
    gd = T.sort_and_clean(rmat(8, 4, seed=7))
    dgd = to_device_graph(gd, with_transpose=False, with_ell=False)
    got = np.asarray(bfs_frontier(dgd, 0, edge_budget=1 << 8))
    np.testing.assert_array_equal(got, verifiers.bfs_serial(gd, 0))

    # high-diameter path + a few chords: every frontier is tiny
    n = 3000
    src = np.arange(n - 1)
    gp = T.sort_and_clean(T.symmetrize(from_edges(
        np.r_[src, [0, 100]], np.r_[src + 1, [n // 2, 2900]], n)))
    dgp = to_device_graph(gp, with_transpose=False, with_ell=True)
    got = np.asarray(bfs_frontier(dgp, 0))
    np.testing.assert_array_equal(got, verifiers.bfs_serial(gp, 0))
