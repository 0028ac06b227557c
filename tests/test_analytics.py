"""Analytics solvers vs serial oracles + reference goldens
(citeseer triangle count = 1166, src/triangle/README.md:50)."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import fixture_path

from graphaibench_tpu.analytics import (
    bc_single_source,
    bfs,
    cf_train,
    color,
    connected_components,
    k_core,
    khop_sample,
    knn_search,
    pagerank,
    random_walk,
    sssp_bellman_ford,
    triangle_count,
    verifiers,
)
from graphaibench_tpu.graph import load_graph, transforms as T
from graphaibench_tpu.graph.generators import rmat, uniform_random
from graphaibench_tpu.ops.device_graph import to_device_graph


@pytest.fixture(scope="module")
def small():
    return uniform_random(150, 500, seed=9)


@pytest.fixture(scope="module")
def small_dev(small):
    return to_device_graph(small, with_transpose=False, with_ell=False)


def test_tc_citeseer_golden(citeseer):
    assert triangle_count(citeseer) == 1166


def test_tc_small_oracle(small):
    dag = T.orientation(small)
    assert triangle_count(small) == verifiers.triangle_count_serial(dag)


def test_tc_skewed():
    g = rmat(8, 8, seed=4)
    dag = T.orientation(g)
    assert triangle_count(g) == verifiers.triangle_count_serial(dag)


def test_bfs(small, small_dev):
    dist = np.asarray(bfs(small_dev, 0))
    np.testing.assert_array_equal(dist, verifiers.bfs_serial(small, 0))


def test_bfs_citeseer(citeseer):
    dg = to_device_graph(citeseer, with_transpose=False, with_ell=False)
    dist = np.asarray(bfs(dg, 3))
    np.testing.assert_array_equal(dist, verifiers.bfs_serial(citeseer, 3))


def test_sssp(small, small_dev, rng):
    w = rng.uniform(0.1, 2.0, small.ne).astype(np.float32)
    dist = np.asarray(sssp_bellman_ford(small_dev, jnp.asarray(w), 0))
    ref = verifiers.dijkstra_serial(small, w, 0)
    np.testing.assert_allclose(dist, ref, rtol=1e-5)


def test_pagerank(small, small_dev):
    scores, iters = pagerank(small_dev)
    ref = verifiers.pagerank_serial(small, small)
    np.testing.assert_allclose(np.asarray(scores), ref, atol=1e-4)
    assert int(iters) <= 100


def test_cc(small_dev, small):
    comp = np.asarray(connected_components(small_dev))
    np.testing.assert_array_equal(comp, verifiers.cc_serial(small))


def test_cc_disconnected():
    from graphaibench_tpu.graph.csr import from_edges
    g = T.symmetrize(from_edges([0, 2, 4], [1, 3, 5], 7))
    dg = to_device_graph(g, with_transpose=False, with_ell=False)
    comp = np.asarray(connected_components(dg))
    np.testing.assert_array_equal(comp, [0, 0, 2, 2, 4, 4, 6])


def test_bc(small, small_dev):
    scores = np.asarray(bc_single_source(small_dev, 0))
    ref = verifiers.bc_serial(small, [0])
    np.testing.assert_allclose(scores, ref, rtol=1e-4, atol=1e-6)


def test_kcore(small, small_dev):
    core = np.asarray(k_core(small_dev))
    np.testing.assert_array_equal(core, verifiers.kcore_serial(small))


def test_kcore_hindex(small):
    # the h-index fixpoint path (no-split layout, the at-scale default)
    from graphaibench_tpu.analytics.kcore import k_core_hindex

    core = np.asarray(k_core_hindex(small))
    np.testing.assert_array_equal(core, verifiers.kcore_serial(small))


def test_kcore_hindex_rmat():
    # power-law graph with hub rows wider than the SpMM split width:
    # exercises the wide no-split buckets + the per-row sort
    from graphaibench_tpu.analytics.kcore import k_core_hindex
    from graphaibench_tpu.graph.generators import rmat

    g = rmat(11, 8, seed=3)
    core = np.asarray(k_core_hindex(g))
    np.testing.assert_array_equal(core, verifiers.kcore_serial(g))


def test_coloring(small, small_dev):
    colors = np.asarray(color(small_dev))
    assert verifiers.coloring_valid(small, colors)
    # a greedy coloring should not be wasteful
    assert len(np.unique(colors)) <= small.max_degree() + 1


def test_cf():
    g = load_graph(fixture_path("test_cf"), with_elabels=True)
    ratings = np.asarray(g.elabels, dtype=np.float32)
    lat, hist = cf_train(g, ratings, step=0.01, max_iters=8, epsilon=0.0)
    assert hist[-1] < hist[0]  # RMSE decreases (SGDVerifier criterion)
    assert np.isfinite(lat).all()


def test_khop(small):
    seeds = np.arange(10)
    hops = khop_sample(small, seeds, (5, 3), seed=1)
    assert len(hops) == 2
    s0, d0 = hops[0]
    assert len(s0) == 10 * 5
    src_all, dst_all = small.coo()
    pairs = set(zip(src_all.tolist(), dst_all.tolist()))
    deg = small.degrees()
    for a, b in zip(s0.tolist(), d0.tolist()):
        assert (a, b) in pairs or (deg[a] == 0 and a == b)


def test_random_walk(small):
    walks = random_walk(small, np.arange(6), 4, seed=2)
    assert walks.shape == (6, 5)
    src_all, dst_all = small.coo()
    pairs = set(zip(src_all.tolist(), dst_all.tolist()))
    deg = small.degrees()
    for w in walks:
        for a, b in zip(w[:-1], w[1:]):
            assert (a, b) in pairs or (deg[a] == 0 and a == b)


def test_knn(rng):
    x = rng.standard_normal((200, 16)).astype(np.float32)
    q = x[:5] + 0.001
    idx, scores = knn_search(x, q, k=3)
    np.testing.assert_array_equal(idx[:, 0], np.arange(5))


def test_run_benchmark_dispatcher(capsys):
    from graphaibench_tpu.analytics import run_benchmark
    rc = run_benchmark("tc", fixture_path("tester"), [])
    out = capsys.readouterr().out
    assert "Correct" in out and rc == 0
    rc = run_benchmark("bfs", fixture_path("tester"), ["0"])
    out = capsys.readouterr().out
    assert "Correct" in out and rc == 0


def test_sssp_delta_stepping_matches_dijkstra(citeseer):
    import jax.numpy as jnp

    from graphaibench_tpu.analytics.traversal import (sssp_bellman_ford,
                                                      sssp_delta_stepping)
    from graphaibench_tpu.analytics.verifiers import dijkstra_serial
    from graphaibench_tpu.ops.device_graph import to_device_graph

    g = citeseer
    rng = np.random.default_rng(0)
    w = (rng.random(g.ne) * 9 + 1).astype(np.float32)
    # symmetric weights so the oracle's undirected view matches
    dg = to_device_graph(g, with_transpose=False, with_ell=False)
    for delta in (None, 2.0, 20.0):
        dist = np.asarray(sssp_delta_stepping(dg, jnp.asarray(w), 0,
                                              delta=delta))
        ref = dijkstra_serial(g, w, 0)
        assert np.allclose(dist, ref, rtol=1e-5, equal_nan=True), delta
    bf = np.asarray(sssp_bellman_ford(dg, jnp.asarray(w), 0))
    assert np.allclose(bf, dijkstra_serial(g, w, 0), rtol=1e-5,
                       equal_nan=True)


# ---- Afforest sampling shortcut (omp_afforest.cc analog) -----------------

def test_cc_afforest_rmat():
    from graphaibench_tpu.analytics import connected_components_afforest

    g = T.sort_and_clean(T.symmetrize(rmat(10, 6, seed=3)))
    np.testing.assert_array_equal(connected_components_afforest(g),
                                  verifiers.cc_serial(g))


def test_cc_afforest_edgeless():
    """nv>0, ne==0: trivially symmetric, so the CLI routes it into the
    afforest branch — must return identity labels, not IndexError on
    the empty col_idx."""
    from graphaibench_tpu.analytics import connected_components_afforest
    from graphaibench_tpu.graph.csr import from_edges

    g = from_edges([], [], 7)
    np.testing.assert_array_equal(connected_components_afforest(g),
                                  np.arange(7, dtype=np.int32))


def test_cc_afforest_through_giant():
    """Two low-id fringe chains joined ONLY via the giant component whose
    ids are all larger: a skip-the-giant scheme that freezes the giant
    label would never propagate 1 across to the other chain — the
    contraction must."""
    from graphaibench_tpu.analytics import connected_components_afforest
    from graphaibench_tpu.graph.csr import from_edges

    # giant clique on ids 10..59, chain A = 1-2-(10), chain B = 3-4-(11)
    n = 60
    cs, cd = [], []
    for u in range(10, 60):
        for v in range(u + 1, min(u + 5, 60)):   # 4-regular-ish band
            cs.append(u), cd.append(v)
    cs += [1, 2, 3, 4]
    cd += [2, 10, 4, 11]
    # isolated vertices 0 and 5..9 stay their own components
    g = T.sort_and_clean(T.symmetrize(from_edges(cs, cd, n)))
    got = connected_components_afforest(g)
    ref = verifiers.cc_serial(g)
    np.testing.assert_array_equal(got, ref)
    assert ref[59] == 1   # the giant really takes the fringe label


def test_cc_afforest_fallback_many_components(small):
    """Uniform small graph with no giant component exercises the
    giant_frac fallback; disconnected union exercises multi-component
    contraction."""
    from graphaibench_tpu.analytics import connected_components_afforest
    from graphaibench_tpu.graph.csr import from_edges

    gs = T.sort_and_clean(T.symmetrize(small))
    np.testing.assert_array_equal(connected_components_afforest(gs),
                                  verifiers.cc_serial(gs))
    # many tiny components (pairs): most-frequent label covers < 20%
    g2 = T.symmetrize(from_edges(np.arange(0, 40, 2), np.arange(1, 40, 2), 41))
    np.testing.assert_array_equal(connected_components_afforest(g2),
                                  verifiers.cc_serial(g2))


def test_cc_afforest_cli_route(capsys):
    """Symmetric CLI cc input routes through the Afforest path and the
    verifier prints Correct."""
    from graphaibench_tpu.analytics import run_benchmark

    assert run_benchmark("cc", fixture_path("citeseer"), []) == 0
    assert "Correct" in capsys.readouterr().out
