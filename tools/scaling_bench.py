"""Weak/strong scaling harness for the sharded SpMM.

BASELINE.md target: >=70% weak-scaling efficiency in edges/s across
shards. Runs the halo-exchange sharded SpMM at 1..N shards (the
machine's devices, or a virtual 8-device CPU mesh with ``--cpu``) and
reports edges/s + efficiency. Strong scaling: fixed graph; weak scaling:
edges grow with the shard count.

On a virtual CPU mesh all shards timeshare one host, so the measured
efficiency only validates correctness and plumbing.

  python tools/scaling_bench.py [--mode weak|strong] [--scale 14] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="weak", choices=["weak", "strong"])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="force a virtual 8-device CPU mesh")
    ap.add_argument("--balance", default="vertex",
                    choices=["vertex", "edge"])
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.parallel import (
        AXIS, build_sharded_graph, make_sharded_spmm, pad_rows,
    )

    devices = jax.devices()
    max_n = len(devices)
    shard_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= max_n]
    results = []
    base_rate = None
    for n in shard_counts:
        scale = args.scale + (shard_counts.index(n) if args.mode == "weak" else 0)
        g = T.add_selfloop(rmat(scale, 16, seed=0))
        w = T.gcn_edge_norms(g)
        sg = build_sharded_graph(g, w, n, balance=args.balance)
        mesh = Mesh(np.array(devices[:n]), (AXIS,))
        spmm = make_sharded_spmm(mesh, sg)
        x = jnp.asarray(pad_rows(
            np.random.default_rng(0).standard_normal(
                (g.nv, args.feat)).astype(np.float32), sg.padded_nv))
        spmm(x).block_until_ready()
        iters = 10 if not args.cpu else 3
        t0 = time.perf_counter()
        out = x
        for _ in range(iters):
            # chained: the output feeds the next input so iterations
            # cannot overlap (independent iterations overstate
            # throughput), and the serial chain keeps the virtual CPU
            # mesh from starving the all_to_all rendezvous
            out = spmm(out)
            if args.cpu:
                out.block_until_ready()
        out.block_until_ready()
        dt = (time.perf_counter() - t0) / iters
        rate = g.ne / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * (n if args.mode == "weak" else 1))
        if args.mode == "strong":
            eff = rate / base_rate / n
        halo_total = int(sg.halo_counts.sum())
        results.append(dict(shards=n, scale=scale, nv=g.nv, ne=g.ne,
                            ms=dt * 1e3, edges_per_s=rate, efficiency=eff,
                            halo_frac=halo_total / max(g.nv, 1),
                            platform=devices[0].platform,
                            device_kind=devices[0].device_kind))
        print(json.dumps(results[-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
