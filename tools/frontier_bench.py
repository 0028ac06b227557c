"""Frontier-analytics warm timings at scale.

Times BFS / SSSP / CC / PageRank / k-core / BC-single-source on an rmat
graph with the graph device-resident (pull-mode ELL row-reduce solvers).

Warm protocol: first call compiles + runs; the next 3 calls are timed
with the result fetched (median). Solvers are jitted at the def site so
repeat calls hit the compile cache.

Every solver section runs under a try/except + wall-clock budget, and
the cumulative JSON record prints after EVERY section, so a timeout or
OOM still leaves everything measured so far on stdout.

  python tools/frontier_bench.py [--scale 19] [--which bfs,cc,...]
                                 [--budget-s 900]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS: dict = {}
_T0 = time.perf_counter()
_BUDGET = float(os.environ.get("FRONTIER_BUDGET_S", "900"))


def timed(fn, n=3):
    out = fn()
    _ = np.asarray(out).ravel()[:1]     # compile + force
    ts = []
    for _k in range(n):
        t0 = time.perf_counter()
        out = fn()
        _ = np.asarray(out).ravel()[:1]
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], out


def run_section(name: str, fn):
    """Budget-guarded solver section; prints the cumulative record
    either way (the caller parses the LAST JSON line)."""
    el = time.perf_counter() - _T0
    if el > _BUDGET:
        RESULTS.setdefault("skipped_over_budget", []).append(name)
        print(f"[frontier] {name} SKIPPED ({el:.0f}s > {_BUDGET:.0f}s)",
              file=sys.stderr, flush=True)
    else:
        try:
            fn()
            print(f"[frontier] {name} ok ({time.perf_counter() - _T0:.0f}s)",
                  file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 - keep the partial record
            RESULTS[name + "_error"] = f"{type(e).__name__}: {e}"[:200]
            print(f"[frontier] {name} FAILED: {type(e).__name__}: {e}"[:300],
                  file=sys.stderr, flush=True)
    print(json.dumps(RESULTS), flush=True)


def main():
    global _BUDGET
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--ef", type=int, default=30)
    ap.add_argument("--which", default="bfs,sssp,cc,pr,kcore,bc")
    ap.add_argument("--budget-s", type=float, default=None)
    args = ap.parse_args()
    if args.budget_s is not None:
        _BUDGET = args.budget_s
    which = set(args.which.split(","))

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import to_device_graph

    g = rmat(args.scale, args.ef, seed=0)   # undirected=True: symmetric
    from graphaibench_tpu.graph.transforms import is_symmetric

    is_sym = is_symmetric(g)
    dg = to_device_graph(g, with_transpose=False)
    RESULTS["graph"] = f"rmat{args.scale} nv={g.nv} ne={g.ne}"
    RESULTS["layout"] = "seg_ell" if dg.seg_ell is not None else "plain_ell"

    def do_bfs():
        from graphaibench_tpu.analytics.traversal import bfs, bfs_frontier
        dt, depth = timed(lambda: bfs(dg, 0))
        RESULTS["bfs_s"] = round(dt, 4)
        RESULTS["bfs_reached"] = int(np.sum(np.asarray(depth) >= 0))
        # frontier-adaptive hybrid (direction-optimizing analog): the
        # dense-vs-compacted decision data
        dt_h, depth_h = timed(lambda: bfs_frontier(dg, 0))
        RESULTS["bfs_hybrid_s"] = round(dt_h, 4)
        assert np.array_equal(np.asarray(depth_h), np.asarray(depth))

    def do_bfs_plain():
        # layout ablation: frontier state is <=8 B/row, so the gather
        # table sits in the fast window at ANY nv — column segmenting
        # can only fragment the sweep stages here. Measure, then pin
        # the analytics layout choice on data.
        from graphaibench_tpu.analytics.traversal import bfs
        dg_plain = to_device_graph(g, with_transpose=False, seg_ell=False)
        dt_p, _ = timed(lambda: bfs(dg_plain, 0))
        RESULTS["bfs_plainell_s"] = round(dt_p, 4)

    def do_sssp():
        import jax.numpy as jnp

        from graphaibench_tpu.analytics.traversal import (
            sssp_bellman_ford, sssp_delta_stepping)
        # symmetric weights (pull-mode contract): w(e) = w(rev e)
        su, du_ = g.coo()
        lo = np.minimum(su, du_).astype(np.uint64)
        hi = np.maximum(su, du_).astype(np.uint64)
        wsym = ((lo * np.uint64(2654435761) + hi) % 64 + 1).astype(np.float32)
        dgt = to_device_graph(g, with_transpose=True)
        w_d = jnp.asarray(wsym)
        dt, dist = timed(lambda: sssp_bellman_ford(dgt, w_d, 0))
        RESULTS["sssp_bf_s"] = round(dt, 4)
        dt_d, dist_d = timed(lambda: sssp_delta_stepping(dgt, w_d, 0))
        RESULTS["sssp_delta_s"] = round(dt_d, 4)
        assert np.allclose(np.asarray(dist), np.asarray(dist_d))

    def do_cc():
        from graphaibench_tpu.analytics.cc import (
            connected_components, connected_components_afforest)
        dt, labels = timed(lambda: connected_components(dg))
        RESULTS["cc_s"] = round(dt, 4)
        RESULTS["cc_n"] = int(len(np.unique(np.asarray(labels))))
        if is_sym:
            dt_a, labels_a = timed(lambda: connected_components_afforest(g))
            RESULTS["cc_afforest_s"] = round(dt_a, 4)
            assert np.array_equal(np.asarray(labels_a), np.asarray(labels))

    def do_pr():
        from graphaibench_tpu.analytics.pr import pagerank
        dt, _pr = timed(lambda: pagerank(dg)[0])
        RESULTS["pr_s"] = round(dt, 4)

    def do_kcore():
        from graphaibench_tpu.analytics.kcore import (
            _hindex_layout,
            k_core_hindex,
        )
        t0 = time.perf_counter()
        buckets = _hindex_layout(g)        # host build, once
        RESULTS["kcore_layout_s"] = round(time.perf_counter() - t0, 4)
        dt, core = timed(lambda: k_core_hindex(g, buckets=buckets))
        RESULTS["kcore_s"] = round(dt, 4)
        RESULTS["kcore_max"] = int(np.asarray(core).max())

    def do_bc():
        from graphaibench_tpu.analytics.bc import bc_single_source
        dt, _bc = timed(lambda: bc_single_source(dg, 0))
        RESULTS["bc_s"] = round(dt, 4)

    if "bfs" in which:
        run_section("bfs", do_bfs)
        if dg.seg_ell is not None:
            run_section("bfs_plainell", do_bfs_plain)
    if "sssp" in which:
        run_section("sssp", do_sssp)
    if "cc" in which:
        run_section("cc", do_cc)
    if "pr" in which:
        run_section("pr", do_pr)
    if "kcore" in which:
        run_section("kcore", do_kcore)
    if "bc" in which:
        run_section("bc", do_bc)

    print(json.dumps(RESULTS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
