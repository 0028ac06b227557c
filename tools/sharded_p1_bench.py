"""Sharded trainer vs unsharded Model at P=1 on one device.

Quantifies the per-device overhead of the vertex-sharded halo-exchange
trainer (parallel/train.py) against the single-device Model on
identical graphs, as an epoch-time ratio.

  python tools/sharded_p1_bench.py [--scale 17] [--feat 128]
      [--arch gcn gat] [--epochs 10] [--use-segment-ops]

Timing: scan-batched epochs inside one dispatch, median-of-3 with the
result fetched, first post-compile call discarded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _median3(run):
    """run() must force execution and return nothing; median of 3."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return sorted(times)[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=17)
    ap.add_argument("--ef", type=int, default=16, help="edges per vertex")
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--arch", nargs="+", default=["gcn", "gat"])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--use-segment-ops", action="store_true",
                    help="bench the old gather+segment_sum sharded path")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig, init_params
    from graphaibench_tpu.nn.model import Model, aggregation_weights, prepare_graph
    from graphaibench_tpu.nn.optim import Adam
    from graphaibench_tpu.parallel import AXIS, build_sharded_graph, make_sharded_trainer

    g = rmat(args.scale, args.ef, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.nv, args.feat)).astype(np.float32)
    labels = rng.integers(0, 16, g.nv).astype(np.int32)
    mask = np.ones(g.nv, dtype=np.uint8)
    tr = (0, g.nv, g.nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=16,
                    train_range=tr, val_range=tr, test_range=tr)

    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    out = {"graph": f"rmat{args.scale} nv={g.nv} ne={g.ne} feat={args.feat}",
           "device": str(jax.devices()[0])}

    for arch in args.arch:
        cfg = ModelConfig(arch=arch, num_layers=2, dim_init=args.feat,
                          dim_hid=128, num_cls=16, lr=0.01)
        # --- unsharded Model ---
        model = Model(cfg, ds)
        model.train_epochs(args.epochs)  # compile + warm
        single_s = _median3(lambda: model.train_epochs(args.epochs)) / args.epochs
        # free the single-model device graph before building the sharded
        # one, so both never hold device memory at once
        del model
        import gc
        gc.collect()

        # --- sharded trainer at P=1 ---
        prepped = prepare_graph(g, arch)
        w = aggregation_weights(prepped, arch)
        sg = build_sharded_graph(prepped, w, 1)
        trainer = make_sharded_trainer(mesh, cfg, sg, feats, labels, tr, mask,
                                       use_ell=not args.use_segment_ops)
        params = init_params(cfg)
        opt_state = Adam(lr=cfg.lr).init(params)
        params, opt_state, losses = trainer.train_steps(
            params, opt_state, args.epochs)  # compile + warm
        _ = np.asarray(losses[-1])

        def run_sharded():
            nonlocal params, opt_state
            params, opt_state, losses = trainer.train_steps(
                params, opt_state, args.epochs)
            _ = np.asarray(losses[-1])     # force + fetch

        sharded_s = _median3(run_sharded) / args.epochs
        out[arch] = {"single_epoch_s": single_s,
                     "sharded_p1_epoch_s": sharded_s,
                     "ratio": sharded_s / single_s}
        print(json.dumps({arch: out[arch]}))

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
