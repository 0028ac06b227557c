"""ogbn-products-shaped full-batch GNN benchmark (north-star metric).

BASELINE.json names "GCN epoch time on ogbn-products (full-batch)".
The real dataset is not fetchable in this environment (zero egress), so
this builds a SYNTHETIC graph of the same shape — ~2.4 M vertices,
~123 M directed edges (symmetrized power-law), feat 100, 47 classes —
and times full-batch GCN and SAGE epochs (fwd+bwd+Adam), single chip,
plus the sharded trainer at P=1. Degree structure is rmat, not the
Amazon co-purchase distribution; reported as "products-shaped", never
as the real dataset.

Env knobs: PRODUCTS_SCALE (default 21), PRODUCTS_EF (default 26; the
symmetrize roughly doubles it), PRODUCTS_EPOCHS (default 3).
Prints one JSON object.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig
    from graphaibench_tpu.nn.model import Model

    scale = int(os.environ.get("PRODUCTS_SCALE", "21"))
    ef = int(os.environ.get("PRODUCTS_EF", "26"))
    epochs = int(os.environ.get("PRODUCTS_EPOCHS", "3"))
    feat, classes, hid = 100, 47, 128

    t0 = time.perf_counter()
    # rmat() is already undirected (symmetrized + cleaned) and disk-
    # cached at scale >= 18; rmat21 ef26 -> ~103 M directed edges vs the
    # real dataset's 123.7 M — same shape class
    g = rmat(scale, ef, seed=0)
    build_s = time.perf_counter() - t0
    nv, ne = g.nv, g.ne
    print(f"products-shaped graph: |V| {nv} |E| {ne} "
          f"(build {build_s:.1f} s)", flush=True)

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((nv, feat)).astype(np.float32)
    labels = rng.integers(0, classes, nv).astype(np.int32)
    mask = np.ones(nv, dtype=np.uint8)
    tr = (0, nv, nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=classes,
                    train_range=tr, val_range=tr, test_range=tr)

    results = {"nv": nv, "ne": ne, "graph_build_s": build_s}
    archs = os.environ.get("PRODUCTS_ARCHS", "gcn,sage").split(",")
    for arch in archs:
        # each section guarded: an OOM in one arch must not erase the
        # other sections' records (bench.py hardening pattern)
        m = None
        try:
            cfg = ModelConfig(arch=arch, num_layers=2, dim_init=feat,
                              dim_hid=hid, num_cls=classes, lr=0.01,
                              remat=os.environ.get("PRODUCTS_REMAT",
                                                   "") == "1")
            m = Model(cfg, ds)
            m.train_epochs(epochs)          # compile + warm
            t0 = time.perf_counter()
            m.train_epochs(epochs)
            results[f"{arch}_epoch_s"] = (time.perf_counter() - t0) / epochs
            print(f"  {arch}: {results[f'{arch}_epoch_s']:.2f} s/epoch",
                  flush=True)
        except Exception as e:  # noqa: BLE001
            results[f"{arch}_error"] = f"{type(e).__name__}: {e}"[:300]
            print(f"  {arch} FAILED: {results[f'{arch}_error']}", flush=True)
        finally:
            # drop the model's device buffers even when the section
            # failed, or the next arch inherits the OOM
            m = None
            gc.collect()

    # sharded trainer at P=1 (the production multi-device path on one
    # device). PRODUCTS_SHARDED=0 skips it (single-chip-only ablations).
    if os.environ.get("PRODUCTS_SHARDED", "1") == "0":
        print(json.dumps({"metric": "products_shaped_epoch_s",
                          "config": f"rmat{scale} ef{ef} symmetrized, "
                                    f"feat {feat}, {classes} classes, "
                                    f"2x{hid} layers",
                          **results}))
        return
    try:
        import jax
        from jax.sharding import Mesh

        from graphaibench_tpu.nn.layers import init_params
        from graphaibench_tpu.nn.model import (
            aggregation_weights,
            prepare_graph,
        )
        from graphaibench_tpu.nn.optim import Adam
        from graphaibench_tpu.parallel import (
            AXIS,
            build_sharded_graph,
            make_sharded_trainer,
        )

        cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=feat,
                          dim_hid=hid, num_cls=classes, lr=0.01)
        prepped = prepare_graph(g, "gcn")
        w = aggregation_weights(prepped, "gcn")
        sg = build_sharded_graph(prepped, w, 1)
        mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
        trainer = make_sharded_trainer(mesh, cfg, sg, feats, labels, tr,
                                       mask)
        params = init_params(cfg)
        opt_state = Adam(lr=cfg.lr).init(params)
        params, opt_state, losses = trainer.train_steps(
            params, opt_state, epochs)      # compile + warm
        _ = np.asarray(losses[-1])
        t0 = time.perf_counter()
        params, opt_state, losses = trainer.train_steps(
            params, opt_state, epochs)
        _ = np.asarray(losses[-1])
        results["gcn_sharded_p1_epoch_s"] = (
            (time.perf_counter() - t0) / epochs)
        print(f"  gcn sharded P=1: "
              f"{results['gcn_sharded_p1_epoch_s']:.2f} s/epoch",
              flush=True)
    except Exception as e:  # report partial results either way
        results["sharded_p1_error"] = f"{type(e).__name__}: {e}"

    print(json.dumps({"metric": "products_shaped_epoch_s",
                      "config": f"rmat{scale} ef{ef} symmetrized, "
                                f"feat {feat}, {classes} classes, "
                                f"2x{hid} layers",
                      **results}))


if __name__ == "__main__":
    main()
