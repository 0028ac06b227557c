"""SpMM inner-kernel A/B of the ELL forward:

  kernels: einsum ((r,W)x(r,W,F) contraction on reshaped views) vs
           flat (multiply + lanes.group_sum_cols)
  dtypes:  f32 vs bf16 gathered operand (GAB_SPMM_BF16)
  layouts: plain vs seg(+scan)

Chained-loop timing (output feeds the next input), median-of-3 with a
forced fetch.

  python tools/spmm_kernel_ab.py [--scale 20] [--ef 32] [--iters 5]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_looped(f, init, iters, *args):
    import jax

    run = jax.jit(lambda c, *a: jax.lax.fori_loop(
        0, iters, lambda i, v: f(i, v, *a), c))
    _ = np.asarray(run(init, *args)[0])
    times = []
    for k in range(3):
        init_k = init + np.float32(1e-6) * (k + 1)
        _ = np.asarray(init_k[0])
        t0 = time.perf_counter()
        out = run(init_k, *args)
        _ = np.asarray(out[0])
        times.append((time.perf_counter() - t0) / iters)
    return sorted(times)[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--ef", type=int, default=32)
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--kernels", default="einsum,flat")
    ap.add_argument("--dtypes", default="f32")
    ap.add_argument("--layouts", default="plain,seg")
    args = ap.parse_args()

    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.nn.model import GraphBundle
    from graphaibench_tpu.ops.spmm import spmm_ell

    g = rmat(args.scale, args.ef, seed=0, cache=True)
    rng = np.random.default_rng(0)
    out = {"graph": f"rmat{args.scale} nv={g.nv} ne={g.ne} "
                    f"feat={args.feat}"}
    print(json.dumps(out), flush=True)

    for layout in args.layouts.split(","):
        os.environ["GAB_SEG_ELL"] = ("1" if layout.startswith("seg")
                                     and layout != "segorder" else "0")
        os.environ["GAB_SEG_SCAN"] = "0" if layout == "seg_unroll" else "1"
        # seg_u: uniform per-width stacking (1.79x slot pad at rmat20); seg_g8: 8 groups/width (less pad, more scan bodies);
        # default grouped stacking is GAB_SEG_GROUPS=4
        os.environ["GAB_SEG_GROUPS"] = (
            "1" if layout == "seg_u" else "8" if layout == "seg_g8" else "4")
        # seg_r16 / seg_r15: finer column slices (32/16 MB windows at
        # F=128 f32) — affordable once grouped stacking decouples pad
        # from the segment count
        os.environ.pop("GAB_SEG_ROWS", None)
        if layout.startswith("seg_r"):
            os.environ["GAB_SEG_ROWS"] = str(1 << int(layout[5:]))
        g_l = g
        if layout == "seg_loc":
            # locality ordering before segmenting:
            # BFS/Cuthill-McKee frontier order, then the standard build
            from graphaibench_tpu.graph import transforms as T

            g_l = T.relabel(g, T.locality_order(g, method="bfs"))
        gb = GraphBundle.build(g_l, "gcn")
        if layout == "segorder":
            # plain ELL rows grouped by destination segment, GLOBAL ids
            import dataclasses as _dc

            from graphaibench_tpu.ops.device_graph import (
                build_segorder_ell,
                pack_edge_values,
            )
            dg2 = _dc.replace(gb.device, ell=build_segorder_ell(g))
            gb = _dc.replace(gb, device=dg2,
                             packed_w=pack_edge_values(dg2, gb.edge_w))
        x = jnp.asarray(
            rng.standard_normal((g.nv, args.feat)).astype(np.float32))
        for kern in args.kernels.split(","):
            os.environ["GAB_SPMM_KERNEL"] = kern
            for dt in args.dtypes.split(","):
                os.environ["GAB_SPMM_BF16"] = "1" if dt == "bf16" else "0"
                try:
                    sec = bench_looped(
                        lambda i, v, dg, w: spmm_ell(dg, w, v), x,
                        args.iters, gb.device, gb.edge_w_agg)
                    key = f"{layout}_{kern}_{dt}"
                    out[key] = {"ms": sec * 1e3,
                                "edges_per_s": g.ne / sec}
                    print(f"[ab] {key}: {sec*1e3:.1f} ms "
                          f"({g.ne/sec/1e6:.0f} M e/s)",
                          file=sys.stderr, flush=True)
                except Exception as e:  # noqa: BLE001
                    out[f"{layout}_{kern}_{dt}_error"] = \
                        f"{type(e).__name__}: {e}"[:200]
                print(json.dumps(out), flush=True)
        del gb, x
        gc.collect()
    for k in ("GAB_SEG_ELL", "GAB_SEG_SCAN", "GAB_SPMM_KERNEL",
              "GAB_SPMM_BF16", "GAB_SEG_GROUPS", "GAB_SEG_ROWS"):
        os.environ.pop(k, None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
