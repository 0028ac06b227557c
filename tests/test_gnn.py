"""GNN stack tests: per-layer parity vs the reference-semantics numpy
oracle, gradient/update parity over multiple steps, convergence on real
fixtures."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import fixture_path

from graphaibench_tpu.graph import load_gnn_dataset, transforms as T
from graphaibench_tpu.graph.generators import uniform_random
from graphaibench_tpu.nn import Model, ModelConfig, apply_model, init_params, make_config
from graphaibench_tpu.nn.model import GraphBundle
from graphaibench_tpu.ops import math as gmath
from graphaibench_tpu.ops.rng import glorot_reference

from oracle_gnn import GcnOracle, softmax_np, spmm_np


def make_toy(nv=60, ne=150, feat=10, ncls=4, seed=5):
    g = uniform_random(nv, ne, seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((nv, feat)).astype(np.float32)
    labels = rng.integers(0, ncls, nv).astype(np.int32)
    mask = np.zeros(nv, dtype=np.uint8)
    mask[: nv // 2] = 1
    return g, feats, labels, mask


def test_gcn_forward_parity_with_oracle():
    """Initial-forward per-layer activations match the reference-semantics
    oracle to f32 precision (the BASELINE.md allclose gate)."""
    g, feats, labels, mask = make_toy()
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=10, dim_hid=16,
                      num_cls=4, lr=0.02)
    gb = GraphBundle.build(g, "gcn")
    params = init_params(cfg)

    logits, acts = apply_model(cfg, params, gb.device, gb.edge_w,
                               jnp.asarray(feats), return_intermediates=True)

    oracle = GcnOracle(
        gb.host, np.asarray(gb.edge_w), cfg.gconv_dims,
        [np.asarray(p["W_neigh"]) for p in params["gconv"]],
        cfg.lr, 0, 30, labels, mask,
    )
    ref_acts = oracle.forward(feats)
    for a, r in zip(acts, ref_acts):
        np.testing.assert_allclose(np.asarray(a), r, rtol=1e-4, atol=1e-5)


def test_gcn_training_parity_three_steps():
    """Weights after 3 full train steps (fw+bw+Adam) match the oracle."""
    g, feats, labels, mask = make_toy()
    begin, end = 0, 30
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=10, dim_hid=16,
                      num_cls=4, lr=0.02)
    from graphaibench_tpu.graph.io import GnnDataset
    ds = GnnDataset(
        graph=g, feats=feats, labels=labels,
        train_mask=mask, val_mask=mask, test_mask=mask,
        num_classes=4, train_range=(begin, end, int(mask[begin:end].sum())),
        val_range=(begin, end, 1), test_range=(begin, end, 1),
    )
    model = Model(cfg, ds)
    gb = model.full
    oracle = GcnOracle(
        gb.host, np.asarray(gb.edge_w), cfg.gconv_dims,
        [np.asarray(p["W_neigh"]) for p in model.params["gconv"]],
        cfg.lr, begin, end, labels, mask,
    )
    for step in range(3):
        loss, acc = model.train_epoch()
        ref_loss, _ = oracle.step(feats)
        assert abs(loss - ref_loss) < 1e-4, (step, loss, ref_loss)
    for l in range(2):
        np.testing.assert_allclose(
            np.asarray(model.params["gconv"][l]["W_neigh"]), oracle.W[l],
            rtol=1e-3, atol=1e-5,
        )


def test_sage_forward_parity():
    """SAGE: mean aggregation + separate self path (sage_layer.cpp:5-25)."""
    g, feats, labels, mask = make_toy()
    cfg = ModelConfig(arch="sage", num_layers=2, dim_init=10, dim_hid=16,
                      num_cls=4)
    gb = GraphBundle.build(g, "sage")  # no selfloops
    params = init_params(cfg)
    logits, acts = apply_model(cfg, params, gb.device, gb.edge_w,
                               jnp.asarray(feats), return_intermediates=True)
    # oracle layer 0: mean-agg (X @ W) + X @ Wself, relu (din < dout path)
    W0 = np.asarray(params["gconv"][0]["W_neigh"])
    S0 = np.asarray(params["gconv"][0]["W_self"])
    agg = spmm_np(gb.host, np.asarray(gb.edge_w), feats.astype(np.float64))
    ref0 = np.maximum(agg @ W0 + feats @ S0, 0)
    np.testing.assert_allclose(np.asarray(acts[0]), ref0, rtol=1e-4, atol=1e-5)


def test_gat_forward_parity():
    """GAT: rank-1 logits, leaky relu 0.2, per-row softmax, weighted agg
    (gat_aggregator.cpp:57-102)."""
    g, feats, labels, mask = make_toy()
    cfg = ModelConfig(arch="gat", num_layers=2, dim_init=10, dim_hid=16,
                      num_cls=4, use_l2norm=True, use_dense=True)
    gb = GraphBundle.build(g, "gat")  # selfloops added
    params = init_params(cfg)
    logits, acts = apply_model(cfg, params, gb.device, gb.edge_w,
                               jnp.asarray(feats), return_intermediates=True)
    p0 = params["gconv"][0]
    h = feats.astype(np.float64) @ np.asarray(p0["W_neigh"])
    al, ar = np.asarray(p0["alpha_l"]), np.asarray(p0["alpha_r"])
    hg = gb.host
    src, dst = hg.coo()
    raw = h[src] @ al + h[dst] @ ar
    raw = np.where(raw > 0, raw, 0.2 * raw)
    scores = np.zeros(hg.ne)
    for v in range(hg.nv):
        b, e = hg.row_ptr[v], hg.row_ptr[v + 1]
        if e > b:
            scores[b:e] = softmax_np(raw[b:e])
    ref0 = np.maximum(spmm_np(hg, scores, h), 0)
    np.testing.assert_allclose(np.asarray(acts[0]), ref0, rtol=1e-3, atol=1e-4)
    # l2norm + dense head exist
    assert len(acts) == 2 + 2


def test_ggnn_forward_shapes():
    g, feats, labels, mask = make_toy()
    cfg = make_config("ggnn", 2, 10, 16, 4)
    assert cfg.num_layers == 1 and cfg.use_dense
    gb = GraphBundle.build(g, "ggnn")
    params = init_params(cfg)
    out = apply_model(cfg, params, gb.device, gb.edge_w, jnp.asarray(feats))
    assert out.shape == (g.nv, 4)
    assert bool(jnp.isfinite(out).all())


def test_ggnn_forward_matches_numpy_oracle():
    """Behavioral GGNN check: the full forward (projection, selfloop sum
    aggregation, GRU gates, l2norm + dense head) against an independent
    float64 numpy re-execution of the layer semantics
    (ggnn_aggregator.cu:12-14 gate math, densely re-expressed). The
    reference's GGNN is GPU-only (src/gnn/Makefile lists it in CUOBJS
    only), so there is no CPU binary to match — the oracle pins OUR
    documented semantics instead."""
    g, feats, labels, mask = make_toy()
    cfg = make_config("ggnn", 2, 10, 16, 4)
    gb = GraphBundle.build(g, "ggnn")
    params = init_params(cfg)
    out = np.asarray(apply_model(cfg, params, gb.device, gb.edge_w,
                                 jnp.asarray(feats)))

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    p = params["gconv"][0]
    hg = gb.host                      # selfloops added (arch != sage)
    x = feats.astype(np.float64) @ np.asarray(p["W_neigh"], np.float64)
    a = spmm_np(hg, np.ones(hg.ne), x)
    z = sig(a @ np.asarray(p["Wz"], np.float64)
            + x @ np.asarray(p["Uz"], np.float64))
    r = sig(a @ np.asarray(p["Wr"], np.float64)
            + x @ np.asarray(p["Ur"], np.float64))
    hc = np.tanh(a @ np.asarray(p["Wh"], np.float64)
                 + (r * x) @ np.asarray(p["Uh"], np.float64))
    h = (1 - z) * x + z * hc          # single layer -> act=False
    h = h / np.sqrt(np.maximum((h * h).sum(1, keepdims=True), 1e-12))
    ref = h @ np.asarray(params["dense"]["W"], np.float64)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)


def test_ggnn_training_trajectory_ell_matches_dense():
    """GGNN loss-trajectory test: 5 full train
    steps through the ELL aggregation path (flat slot gathers + custom
    VJP + packed weights) must reproduce the dense path's loss
    trajectory — two independent aggregation implementations with
    independent adjoints driving the same GRU training dynamics."""
    import dataclasses as _dc

    from graphaibench_tpu.graph.io import GnnDataset

    g, feats, labels, mask = make_toy(nv=80, ne=300)
    tr = (0, 40, 40)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=tr, val_range=tr, test_range=tr)
    traj = {}
    for impl in ("dense", "ell"):
        cfg = _dc.replace(make_config("ggnn", 2, 10, 16, 4, lr=0.05),
                          spmm_impl=impl)
        model = Model(cfg, ds)
        losses, _ = model.train_epochs(5)
        traj[impl] = np.asarray(losses)
    assert np.all(np.diff(traj["dense"]) < 0), traj  # it actually learns
    np.testing.assert_allclose(traj["ell"], traj["dense"],
                               rtol=2e-4, atol=2e-5)


def test_adam_matches_oracle():
    from graphaibench_tpu.nn.optim import Adam
    from oracle_gnn import AdamNp
    w = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    params = {"w": jnp.asarray(w)}
    opt = Adam(lr=0.05)
    st = opt.init(params)
    ref = AdamNp(0.05)
    wref = w.astype(np.float64).copy()
    for i in range(5):
        g = np.sin(wref + i).astype(np.float32)
        params, st = opt.update({"w": jnp.asarray(g)}, st, params)
        ref.update("w", g.astype(np.float64), wref)
        ref.end_step()
    np.testing.assert_allclose(np.asarray(params["w"]), wref, rtol=1e-4, atol=1e-6)


def test_nesterov_matches_oracle():
    """Serial re-execution of the reference rule (optimizer.cpp:66-74):
    V = mu*Vprev - lr*(dW + W*lambda); W += -mu*Vprev + (1+mu)*V."""
    from graphaibench_tpu.nn.optim import Nesterov
    w = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    params = {"w": jnp.asarray(w)}
    opt = Nesterov(lr=0.05, mu=0.9, weight_decay=0.01)
    st = opt.init(params)
    wref = w.astype(np.float64).copy()
    vprev = np.zeros_like(wref)
    for i in range(5):
        g = np.sin(wref + i)
        params, st = opt.update({"w": jnp.asarray(g.astype(np.float32))}, st, params)
        v = 0.9 * vprev - 0.05 * (g + wref * 0.01)
        wref += -0.9 * vprev + 1.9 * v
        vprev = v
    np.testing.assert_allclose(np.asarray(params["w"]), wref, rtol=1e-4, atol=1e-6)


def test_sigmoid_multilabel_training():
    g, feats, labels, mask = make_toy()
    ncls = 4
    multi = np.zeros((g.nv, ncls), dtype=np.uint8)
    multi[np.arange(g.nv), labels] = 1
    multi[np.arange(g.nv), (labels + 1) % ncls] = 1
    from graphaibench_tpu.graph.io import GnnDataset
    ds = GnnDataset(
        graph=g, feats=feats, labels=multi,
        train_mask=mask, val_mask=mask, test_mask=mask,
        num_classes=ncls, is_single_class=False,
        train_range=(0, 30, int(mask[:30].sum())),
        val_range=(0, 30, 1), test_range=(0, 30, 1),
    )
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=10, dim_hid=8,
                      num_cls=ncls, is_sigmoid=True, lr=0.05)
    model = Model(cfg, ds)
    losses = [model.train_epoch()[0] for _ in range(20)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["gcn", "sage", "gat"])
def test_convergence_citeseer(arch):
    """Training drives loss down and accuracy up on the real citeseer
    graph (synthesized features correlated with labels so the task is
    learnable — the fixtures ship no feats)."""
    ds = load_gnn_dataset(fixture_path("citeseer"), synth_feat_len=32)
    # make features informative: add label-dependent signal
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((ds.num_classes, ds.feat_len)).astype(np.float32)
    ds.feats = (ds.feats + centers[ds.labels % ds.num_classes]
                + 0.3 * rng.standard_normal(ds.feats.shape).astype(np.float32))
    # citeseer meta ships no mask ranges -> fabricate splits
    nv = ds.graph.nv
    ds.train_range, ds.val_range, ds.test_range = (0, 300, 300), (300, 800, 500), (2312, 3312, 1000)
    for name, rng_ in (("train_mask", ds.train_range), ("val_mask", ds.val_range), ("test_mask", ds.test_range)):
        m = np.zeros(nv, dtype=np.uint8); m[rng_[0]:rng_[1]] = 1
        setattr(ds, name, m)
    cfg = make_config(arch, 2, ds.feat_len, 16, ds.num_classes, lr=0.02)
    model = Model(cfg, ds)
    first_loss, first_acc = model.train_epoch()
    for _ in range(30):
        loss, acc = model.train_epoch()
    assert loss < first_loss
    test_acc = model.evaluate("test")
    assert test_acc > 0.5, f"{arch}: test acc {test_acc}"


def test_inductive_training():
    ds = load_gnn_dataset(fixture_path("citeseer"), synth_feat_len=16)
    nv = ds.graph.nv
    ds.train_range = (0, 500, 500)
    m = np.zeros(nv, dtype=np.uint8); m[:500] = 1
    ds.train_mask = m
    ds.val_range = ds.test_range = (500, 1000, 500)
    m2 = np.zeros(nv, dtype=np.uint8); m2[500:1000] = 1
    ds.val_mask = ds.test_mask = m2
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=16, dim_hid=8, num_cls=ds.num_classes)
    model = Model(cfg, ds, inductive=True)
    # training graph keeps only train-masked edges
    assert model.training.host.ne <= model.full.host.ne
    l0, _ = model.train_epoch()
    for _ in range(5):
        l, _ = model.train_epoch()
    assert np.isfinite(l)


def test_train_epochs_scan_batching():
    """Batched multi-epoch dispatch must train like the stepped path."""
    from graphaibench_tpu.nn import Model, make_config
    from tests.conftest import fixture_path

    ds = load_gnn_dataset(fixture_path("cora"), synth_feat_len=16)
    cfg = make_config("gcn", 2, ds.feat_len, 16, ds.num_classes)
    m = Model(cfg, ds)
    losses, accs = m.train_epochs(8)
    assert losses.shape == (8,) and accs.shape == (8,)
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]

    m2 = Model(cfg, ds)
    for _ in range(8):
        l2, _ = m2.train_epoch()
    # both training modes land in the same neighborhood
    assert abs(l2 - losses[-1]) < 0.35


def test_remat_matches_plain():
    """cfg.remat (jax.checkpoint per gconv layer) must not change the
    math: identical loss/grads over 3 steps for every arch."""
    import numpy as np

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig
    from graphaibench_tpu.nn.model import Model

    g = rmat(9, 6, seed=1)
    rng = np.random.default_rng(0)
    feat, ncls, nv = 12, 5, g.nv
    feats = rng.standard_normal((nv, feat)).astype(np.float32)
    labels = rng.integers(0, ncls, nv).astype(np.int32)
    mask = np.ones(nv, dtype=np.uint8)
    tr = (0, nv, nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=ncls,
                    train_range=tr, val_range=tr, test_range=tr)
    for arch in ("gcn", "sage", "gat"):
        losses = {}
        for remat in (False, True):
            cfg = ModelConfig(arch=arch, num_layers=3, dim_init=feat,
                              dim_hid=16, num_cls=ncls, remat=remat)
            m = Model(cfg, ds)
            losses[remat] = [m.train_epoch()[0] for _ in range(3)]
        np.testing.assert_allclose(losses[False], losses[True],
                                   rtol=2e-5, atol=2e-6)


def test_slim_packed_bundle_matches_full(monkeypatch):
    """slim_for_packed (COO/trans_perm/edge-id/raw-weight arrays dropped
    for the packed static-weight path) must not change training or eval
    — at products scale those arrays are ~2.6 GB of dead device
    memory."""
    import numpy as np

    import graphaibench_tpu.ops.device_graph as dg_mod
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig
    from graphaibench_tpu.nn.model import Model

    g = rmat(13, 8, seed=1)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.nv, 16)).astype(np.float32)
    labels = rng.integers(0, 4, g.nv).astype(np.int32)
    mask = np.ones(g.nv, np.uint8)
    tr = (0, g.nv, g.nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=tr, val_range=tr, test_range=tr)
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=16, dim_hid=8,
                      num_cls=4)
    m_ref = Model(cfg, ds)
    l_ref = [m_ref.train_epoch()[0] for _ in range(3)]
    monkeypatch.setattr(dg_mod, "SEG_ELL_MIN_NV", 1)
    m_slim = Model(cfg, ds)
    assert m_slim.full.device.trans_perm is None  # slim active
    l_slim = [m_slim.train_epoch()[0] for _ in range(3)]
    np.testing.assert_allclose(l_ref, l_slim, rtol=2e-5)
    assert 0.0 <= m_slim.evaluate("test") <= 1.0


def test_slim_gat_bundle_matches_full(monkeypatch):
    """The at-scale GAT bundle drops COO/trans_perm (v2 reads only the
    buckets) — training and eval must be unchanged."""
    import numpy as np

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig
    from graphaibench_tpu.nn.model import Model

    g = rmat(13, 8, seed=2)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.nv, 12)).astype(np.float32)
    labels = rng.integers(0, 4, g.nv).astype(np.int32)
    mask = np.ones(g.nv, np.uint8)
    tr = (0, g.nv, g.nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=tr, val_range=tr, test_range=tr)
    cfg = ModelConfig(arch="gat", num_layers=2, dim_init=12, dim_hid=8,
                      num_cls=4)
    m_ref = Model(cfg, ds)
    l_ref = [m_ref.train_epoch()[0] for _ in range(3)]
    # apply the at-scale slim replacement directly (the production gate
    # is a size literal)
    import dataclasses as dc

    import jax.numpy as jnp

    m_slim = Model(cfg, ds)
    one = jnp.zeros((1,), jnp.int32)
    slim_dev = dc.replace(m_slim.full.device, col_idx=one, edge_src=one,
                          trans_perm=None)
    m_slim.full = dc.replace(m_slim.full, device=slim_dev)
    m_slim.training = m_slim.full
    l_slim = [m_slim.train_epoch()[0] for _ in range(3)]
    np.testing.assert_allclose(l_ref, l_slim, rtol=2e-5)
    assert 0.0 <= m_slim.evaluate("test") <= 1.0
