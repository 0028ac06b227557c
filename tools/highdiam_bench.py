"""High-diameter frontier ablation.

On a dense low-diameter graph (rmat) every sweep is full-width, so the
hybrid BFS and delta-stepping only add overhead there. Their claimed
value is the HIGH-diameter regime — this measures exactly that on a
side x side grid (diameter 2(side-1)) with
random [1,2) weights:

  bfs          — dense fixpoint (diameter full sweeps)
  bfs_frontier — in-jit adaptive sparse/dense switch
  bf / delta   — Bellman-Ford vs delta-stepping

Each section budget-guarded; cumulative JSON after every section.

  python tools/highdiam_bench.py [--side 512] [--which all]
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


def timed(fn, n=3):
    out = fn()
    _ = np.asarray(out).ravel()[:1]
    ts = []
    for _k in range(n):
        t0 = time.perf_counter()
        out = fn()
        _ = np.asarray(out).ravel()[:1]
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], out


def section(name, fn):
    try:
        fn()
        print(f"[hd] {name} ok", file=sys.stderr, flush=True)
    except Exception as e:  # noqa: BLE001
        RESULTS[name + "_error"] = f"{type(e).__name__}: {e}"[:200]
        print(f"[hd] {name} FAILED: {e}"[:300], file=sys.stderr, flush=True)
    print(json.dumps(RESULTS), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--which", default="bfs,sssp")
    args = ap.parse_args()

    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import grid2d
    from graphaibench_tpu.ops.device_graph import to_device_graph

    g = grid2d(args.side)
    dg = to_device_graph(g, with_transpose=True)
    RESULTS["graph"] = (f"grid {args.side}x{args.side} nv={g.nv} ne={g.ne} "
                        f"diam={2 * (args.side - 1)}")

    def do_bfs():
        from graphaibench_tpu.analytics.traversal import bfs, bfs_frontier

        dt, dist = timed(lambda: bfs(dg, 0))
        RESULTS["bfs_plain_s"] = round(dt, 4)
        dt_h, dist_h = timed(lambda: bfs_frontier(dg, 0))
        RESULTS["bfs_frontier_s"] = round(dt_h, 4)
        assert np.array_equal(np.asarray(dist), np.asarray(dist_h))
        RESULTS["bfs_max_depth"] = int(np.asarray(dist).max())

    def do_sssp():
        from graphaibench_tpu.analytics.traversal import (
            sssp_bellman_ford,
            sssp_delta_stepping,
        )

        rng = np.random.default_rng(0)
        w = jnp.asarray((1.0 + rng.random(g.ne)).astype(np.float32))
        # symmetric weights so the pull path's reverse-edge gather sees
        # identical values (the bench convention of frontier_bench)
        from graphaibench_tpu.graph.transforms import (
            transpose_edge_permutation,
        )

        tp = transpose_edge_permutation(g)
        w = jnp.minimum(w, w[tp])
        dt, dist = timed(lambda: sssp_bellman_ford(dg, w, 0))
        RESULTS["sssp_bf_s"] = round(dt, 4)
        dt_d, dist_d = timed(lambda: sssp_delta_stepping(dg, w, 0))
        RESULTS["sssp_delta_s"] = round(dt_d, 4)
        ok = np.allclose(np.asarray(dist), np.asarray(dist_d), rtol=1e-5)
        RESULTS["sssp_agree"] = bool(ok)

    if "bfs" in args.which:
        section("bfs", do_bfs)
    if "sssp" in args.which:
        section("sssp", do_sssp)
    print(json.dumps(RESULTS), flush=True)


if __name__ == "__main__":
    sys.exit(main())
