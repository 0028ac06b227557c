"""The sharded trainers' gradients equal the single-device Model's.

A one-step loss comparison cannot see the gradient (the step reports the
loss before its update), so these compare the parameter update of one
plain SGD step, where any scale error in the gradient shows directly."""

from __future__ import annotations

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.io import GnnDataset
from graphaibench_tpu.nn import Model, make_config
from graphaibench_tpu.nn.layers import init_params
from graphaibench_tpu.nn.model import aggregation_weights, prepare_graph
from graphaibench_tpu.nn.optim import SGD
from graphaibench_tpu.parallel import (AXIS, MODEL_AXIS, build_sharded_graph,
                                       make_sharded_trainer, make_tp_trainer)


@pytest.mark.parametrize("mesh_kind", ["graph4", "graph2xmodel2"])
@pytest.mark.parametrize("arch", ["gcn", "sage", "gat"])
def test_sharded_sgd_update_equals_single_device(arch, mesh_kind):
    g = rmat(9, 8, seed=0)
    rng = np.random.default_rng(0)
    feats = 0.1 * rng.standard_normal((g.nv, 16)).astype(np.float32)
    labels = rng.integers(0, 4, g.nv).astype(np.int32)
    mask = np.ones(g.nv, np.uint8)
    tr = (0, g.nv // 2, g.nv // 2)
    cfg = make_config(arch, 2, 16, 32, 4, lr=1.0, optimizer="sgd")
    prepped = prepare_graph(g, arch)
    w = aggregation_weights(prepped, arch)
    devs = jax.devices()[:4]
    if mesh_kind == "graph4":
        mesh = Mesh(np.array(devs), (AXIS,))
        trainer = make_sharded_trainer(
            mesh, cfg, build_sharded_graph(prepped, w, 4), feats, labels,
            tr, mask, optimizer="sgd")
    else:
        mesh = Mesh(np.array(devs).reshape(2, 2), (AXIS, MODEL_AXIS))
        trainer = make_tp_trainer(
            mesh, cfg, build_sharded_graph(prepped, w, 2), feats, labels,
            tr, mask, optimizer="sgd")
    params = init_params(cfg)
    sharded, _, loss = trainer.train_step(params, SGD(lr=1.0).init(params))

    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=tr, val_range=tr, test_range=tr)
    single = Model(cfg, ds, optimizer="sgd")
    s_loss, _ = single.train_epoch()
    assert abs(float(loss) - s_loss) < 1e-4
    for p0, ps, p1 in zip(jax.tree.leaves(params), jax.tree.leaves(sharded),
                          jax.tree.leaves(single.params)):
        step_sharded = np.asarray(ps) - np.asarray(p0)
        step_single = np.asarray(p1) - np.asarray(p0)
        np.testing.assert_allclose(step_sharded, step_single, rtol=1e-3,
                                   atol=1e-3 * np.abs(step_single).max())
