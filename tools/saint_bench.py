"""GraphSAINT sampled-epoch timing.

Sampling + padding each epoch is host work; the double-buffered sampler
overlaps sampling subgraph k+1 with step k on device.

  python tools/saint_bench.py [--scale 17] [--subg 8000] [--epochs 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=17)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--subg", type=int, default=8000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig
    from graphaibench_tpu.nn.model import Model

    g = rmat(args.scale, args.ef, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.nv, args.feat)).astype(np.float32)
    labels = rng.integers(0, 16, g.nv).astype(np.int32)
    mask = np.ones(g.nv, dtype=np.uint8)
    tr = (0, g.nv, g.nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=16,
                    train_range=tr, val_range=tr, test_range=tr)
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=args.feat,
                      dim_hid=128, num_cls=16, lr=0.01)
    model = Model(cfg, ds)

    # warm (compile the padded-shape step), then timed run
    model.train_sampled(3, args.subg, verbose=False, seed=1)
    t0 = time.perf_counter()
    model.train_sampled(args.epochs, args.subg, verbose=False, seed=2)
    dt = (time.perf_counter() - t0) / args.epochs
    print(json.dumps({
        "graph": f"rmat{args.scale} nv={g.nv} ne={g.ne}",
        "subg": args.subg,
        "sampled_epoch_s": dt,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
