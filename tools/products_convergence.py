"""Products-shaped SAGE convergence run.

The reference's named large-graph recipe is a full training run to
accuracy: `cpu_train_sage ogbn-products 10 32 softmax 256 0 0 0.01 3 0
50 0` (scripts/run-sage-products.sh:1; the train loop prints per-epoch
loss/acc, net.cpp:361-419). The real dataset is unfetchable here (zero
egress), so this runs the same recipe — SAGE, 3 layers, hidden 256,
lr 0.01, 10 epochs, softmax loss — on the products-shaped synthetic
graph with PLANTED teacher labels (argmax of a random aggregation of
the features + noise), so accuracy has real signal to climb, and a
train/val/test range split shaped like ogbn-products' (~8% train).

Prints per-epoch train loss/acc + periodic val acc + final test acc as
one JSON artifact. Exactness of the SAGE semantics vs the compiled
reference binary is covered separately (tests/test_reference_parity.py,
exact 0.954 on synthetic-cora).

  python tools/products_convergence.py [--epochs 10] [--scale 21]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--ef", type=int, default=26)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--arch", default="sage")
    ap.add_argument("--val-every", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig
    from graphaibench_tpu.nn.model import Model
    from graphaibench_tpu.ops.spmm import spmm

    feat, classes = 100, 47
    t0 = time.perf_counter()
    g = rmat(args.scale, args.ef, seed=0, cache=True)
    nv, ne = g.nv, g.ne
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((nv, feat)).astype(np.float32)
    print(f"graph |V| {nv} |E| {ne} ({time.perf_counter()-t0:.0f}s)",
          flush=True)

    # remat: layer rematerialization for devices that cannot hold the
    # 3x256 recipe's activations
    cfg = ModelConfig(arch=args.arch, num_layers=args.layers,
                      dim_init=feat, dim_hid=args.hidden, num_cls=classes,
                      lr=0.01, remat=args.layers * args.hidden >= 512)

    # ogbn-products-shaped contiguous range split: ~8% train, ~2% val
    n_tr = int(nv * 0.08)
    n_val = int(nv * 0.02)
    tr = (0, n_tr, n_tr)
    va = (n_tr, n_tr + n_val, n_val)
    te = (n_tr + n_val, nv, nv - n_tr - n_val)
    mask = np.ones(nv, dtype=np.uint8)

    # placeholder labels; the real ones are planted below on device
    labels = np.zeros(nv, dtype=np.int32)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=classes,
                    train_range=tr, val_range=va, test_range=te)
    m = Model(cfg, ds)

    # planted teacher: one normalized aggregation + random readout +
    # noise -> argmax. ONE jitted program, not one eager compile per
    # bucket stage
    @jax.jit
    def teacher(dg, w, x):
        agg = spmm(dg, w, x)
        Wt = jax.random.normal(jax.random.PRNGKey(7), (feat, classes),
                               jnp.float32)
        noise = 0.5 * jax.random.normal(jax.random.PRNGKey(8),
                                        (x.shape[0], classes), jnp.float32)
        return jnp.argmax(agg @ Wt + noise, axis=1)

    labels = np.asarray(teacher(m.full.device, m.full.edge_w_agg,
                                m.feats), dtype=np.int32)
    m.labels = jnp.asarray(labels)
    m.data.labels = labels
    print(f"planted labels: {len(np.unique(labels))} classes used",
          flush=True)

    out = {"metric": "products_shaped_convergence",
           "recipe": f"{args.arch} {args.layers}x{args.hidden} lr0.01 "
                     f"softmax (run-sage-products.sh shape)",
           "nv": nv, "ne": ne, "train": tr, "val": va, "test": te,
           "epochs": []}
    for ep in range(args.epochs):
        t1 = time.perf_counter()
        loss, acc = m.train_epoch()
        rec = {"epoch": ep, "train_loss": round(loss, 4),
               "train_acc": round(acc, 4),
               "time_s": round(time.perf_counter() - t1, 2)}
        if ep % args.val_every == args.val_every - 1:
            rec["val_acc"] = round(m.evaluate("val"), 4)
        out["epochs"].append(rec)
        print(json.dumps(rec), flush=True)
    out["test_acc"] = round(m.evaluate("test"), 4)
    losses = [e["train_loss"] for e in out["epochs"]]
    out["loss_decreased"] = bool(losses[-1] < losses[0])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
