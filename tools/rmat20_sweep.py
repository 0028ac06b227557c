"""rmat20 SpMM layout sweep.

Sweeps degree-relabel x segment-width with the CHAINED protocol (output
feeds the next input — independent iterations overlap and overstate
throughput), whole-table vs column-segmented ELL.

  python tools/rmat20_sweep.py [--scale 20] [--feat 128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench_chained(spmm_fn, x0, iters=6, *args):
    """Graph/weight operands must ride in ``*args``: closed-over device
    arrays become constants embedded in the compiled program."""
    import jax

    run = jax.jit(lambda c, *a: jax.lax.fori_loop(
        0, iters, lambda i, v: spmm_fn(v, *a), c))
    _ = np.asarray(run(x0, *args)[0])
    times = []
    for k in range(3):
        xk = x0 + np.float32(1e-6) * (k + 1)
        _ = np.asarray(xk[0])
        t0 = time.perf_counter()
        out = run(xk, *args)
        _ = np.asarray(out[0])
        times.append((time.perf_counter() - t0) / iters)
    return sorted(times)[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--ef", type=int, default=32)
    ap.add_argument("--feat", type=int, default=128)
    args = ap.parse_args()

    import jax.numpy as jnp

    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import build_seg_ell, to_device_graph
    from graphaibench_tpu.ops.spmm import spmm_ell
    import dataclasses

    g = T.add_selfloop(rmat(args.scale, args.ef, seed=0))
    w = T.gcn_edge_norms(g)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, args.feat)).astype(np.float32))
    w_d = jnp.asarray(w)
    results = []

    def measure(tag, gg, ww):
        dt = bench_chained(
            lambda v, g_, w_: spmm_ell(g_, w_, v), x, 6, gg, ww)
        r = dict(tag=tag, ms=dt * 1e3, edges_per_s=g.ne / dt)
        results.append(r)
        print(json.dumps(r), flush=True)

    # baseline: plain ELL, whole-table gathers
    dg = to_device_graph(g, with_transpose=False, with_ell=True,
                         seg_ell=False)
    measure("plain", dg, w_d)

    # segment width sweep
    for seg_rows in (1 << 16, 1 << 17, 1 << 18):
        seg = build_seg_ell(g, seg_rows=seg_rows)
        dgs = dataclasses.replace(dg, seg_ell=seg)
        measure(f"seg{seg_rows >> 10}k", dgs, w_d)

    # bf16-gather ablation: above the seg-ELL gate spmm_ell rounds the
    # gathered operand to bf16 when GAB_SPMM_BF16 is set; measure the
    # same layouts with it forced OFF to quantify the win
    from graphaibench_tpu.ops import fused_gat as fg

    fg.V2_GATHER_BF16 = False
    measure("plain_f32", dg, w_d)
    seg = build_seg_ell(g, seg_rows=1 << 17)
    measure("seg128k_f32", dataclasses.replace(dg, seg_ell=seg), w_d)
    fg.V2_GATHER_BF16 = True

    # degree-relabel x segmenting: hot rows first shrinks the hot slice
    perm = np.argsort(-g.degrees(), kind="stable").astype(np.int32)
    g2 = T.relabel(g, perm)
    w2 = T.gcn_edge_norms(g2)
    w2_d = jnp.asarray(w2)
    dg2 = to_device_graph(g2, with_transpose=False, with_ell=True,
                          seg_ell=False)
    measure("degrelabel_plain", dg2, w2_d)
    for seg_rows in (1 << 16, 1 << 17):
        seg = build_seg_ell(g2, seg_rows=seg_rows)
        dgs2 = dataclasses.replace(dg2, seg_ell=seg)
        measure(f"degrelabel_seg{seg_rows >> 10}k", dgs2, w2_d)

    best = min(results, key=lambda r: r["ms"])
    print(json.dumps({"best": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
