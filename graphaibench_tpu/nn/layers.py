"""Functional GNN layers: GCN, GraphSAGE, GAT, GGNN, dense, l2norm.

Forward semantics follow the reference layer implementations
(src/gnn/gconv/*.cpp, src/layers/*.cpp) — including the y>z "order
optimization" that chooses GEMM-then-SpMM vs SpMM-then-GEMM
(gcn_layer.cpp:19-25) — but backward passes come from jax.grad instead of
the hand-written adjoints. Parameters are plain dict pytrees initialized
with the reference's deterministic Glorot seeds (seed 1 for W_neigh, 2
for W_self — graph_conv_layer.cpp:12-19; seeds 2/3 for the GAT attention
vectors — gat_aggregator.cpp:11-12), so per-layer activations are
directly comparable with the C++ binaries.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from graphaibench_tpu.ops import math as gmath
from graphaibench_tpu.ops.device_graph import DeviceGraph
from graphaibench_tpu.ops.rng import glorot_reference
from graphaibench_tpu.ops.segment import segment_softmax
from graphaibench_tpu.ops.spmm import sddmm_add, spmm

# full f32 products by default: parity with the reference CPU math
# (DEFAULT precision lets the GPU round f32 inputs to TF32).
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def matmul(a, b):
    return jnp.dot(a, b, precision=MATMUL_PRECISION)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Typed replacement for the reference's argv/#define config matrix
    (SURVEY.md §5): the architecture is a runtime value, not a build
    flavor."""

    arch: str                 # "gcn" | "sage" | "gat" | "ggnn"
    num_layers: int
    dim_init: int
    dim_hid: int
    num_cls: int
    feat_drop: float = 0.0
    score_drop: float = 0.0
    is_sigmoid: bool = False
    use_l2norm: bool = False
    use_dense: bool = False
    lr: float = 0.02
    spmm_impl: str = "auto"
    optimizer: str = "adam"   # any key of nn/optim.OPTIMIZERS
    # rematerialize each gconv layer in the backward pass
    # (jax.checkpoint): trades one extra forward sweep per layer for
    # not storing its activations (for the run-sage-products.sh 3x256
    # recipe shape on a device that cannot hold them)
    remat: bool = False

    def __post_init__(self):
        assert self.arch in ("gcn", "sage", "gat", "ggnn"), self.arch

    @property
    def gconv_dims(self) -> list[tuple[int, int, bool]]:
        """(dim_in, dim_out, is_act) per gconv layer — net.cpp:422-440."""
        dims = []
        for l in range(self.num_layers - 1):
            din = self.dim_init if l == 0 else self.dim_hid
            dims.append((din, self.dim_hid, True))
        dout = self.dim_hid if self.use_dense else self.num_cls
        last_in = self.dim_hid if self.num_layers > 1 else self.dim_init
        dims.append((last_in, dout, False))
        return dims


def make_config(
    arch: str,
    num_layers: int,
    dim_init: int,
    dim_hid: int,
    num_cls: int,
    *,
    subg_size: int = 0,
    **kw,
) -> ModelConfig:
    """Applies the reference's auto-wiring: GAT/GGNN/sampling turn on the
    trailing l2norm+dense head (net.cpp:69-72); GGNN forces 1 layer."""
    if arch == "ggnn":
        num_layers = 1
    use_l2norm = kw.pop("use_l2norm", subg_size > 0 or arch in ("gat", "ggnn"))
    use_dense = kw.pop("use_dense", use_l2norm)
    return ModelConfig(
        arch=arch, num_layers=num_layers, dim_init=dim_init, dim_hid=dim_hid,
        num_cls=num_cls, use_l2norm=use_l2norm, use_dense=use_dense, **kw,
    )


def init_params(cfg: ModelConfig) -> dict:
    """Deterministic reference initialization."""
    layers = []
    for (din, dout, _act) in cfg.gconv_dims:
        p = {"W_neigh": jnp.asarray(glorot_reference(din, dout, 1))}
        if cfg.arch == "sage":
            p["W_self"] = jnp.asarray(glorot_reference(din, dout, 2))
        elif cfg.arch == "gat":
            p["alpha_l"] = jnp.asarray(glorot_reference(dout, 1, 2)[:, 0])
            p["alpha_r"] = jnp.asarray(glorot_reference(dout, 1, 3)[:, 0])
        elif cfg.arch == "ggnn":
            # GRU gates (z, r, candidate) — reference ggnn_aggregator.cu
            for name, seed in (("Wz", 3), ("Uz", 4), ("Wr", 5),
                               ("Ur", 6), ("Wh", 7), ("Uh", 8)):
                p[name] = jnp.asarray(glorot_reference(dout, dout, seed))
        layers.append(p)
    params = {"gconv": layers}
    if cfg.use_dense:
        params["dense"] = {"W": jnp.asarray(glorot_reference(cfg.dim_hid, cfg.num_cls, 1))}
    return params


def _maybe_dropout(x, rate, train, key):
    if train and rate > 0.0 and key is not None:
        out, _ = gmath.dropout(key, x, rate)
        return out
    return x


def gcn_layer_fwd(p, dg: DeviceGraph, edge_w, x, *, act, cfg, train, key, trivial_w=False):
    """gcn_layer.cpp:5-28 with the y>z order optimization."""
    x = _maybe_dropout(x, cfg.feat_drop, train, key)
    y, z = x.shape[1], p["W_neigh"].shape[1]
    if y > z:
        h = matmul(x, p["W_neigh"])
        out = spmm(dg, edge_w, h, cfg.spmm_impl)
    else:
        h = spmm(dg, edge_w, x, cfg.spmm_impl)
        out = matmul(h, p["W_neigh"])
    return jax.nn.relu(out) if act else out


def sage_layer_fwd(p, dg: DeviceGraph, edge_w, x, *, act, cfg, train, key, trivial_w=False):
    """sage_layer.cpp:5-25: mean-aggregated neighbor path + separate
    self path, summed (the 'concat' accumulate-GEMM)."""
    x = _maybe_dropout(x, cfg.feat_drop, train, key)
    y, z = x.shape[1], p["W_neigh"].shape[1]
    if y > z:
        h = matmul(x, p["W_neigh"])
        out = spmm(dg, edge_w, h, cfg.spmm_impl)
    else:
        h = spmm(dg, edge_w, x, cfg.spmm_impl)
        out = matmul(h, p["W_neigh"])
    out = out + matmul(x, p["W_self"])
    return jax.nn.relu(out) if act else out


def gat_layer_fwd(p, dg: DeviceGraph, edge_w, x, *, act, cfg, train, key,
                  return_scores=False, trivial_w=False):
    """gat_layer.cpp:3-22 + gat_aggregator.cpp:57-102: project, rank-1
    edge logits a_l.h_src + a_r.h_dst, LeakyReLU(0.2), softmax over each
    source vertex's edge list, score-weighted aggregation."""
    x = _maybe_dropout(x, cfg.feat_drop, train, key)
    h = matmul(x, p["W_neigh"])
    sl = matmul(h, p["alpha_l"])
    sr = matmul(h, p["alpha_r"])
    # edge_w is 1 for ordinary graphs (reference semantics); for padded
    # sampled subgraphs it is the edge-validity mask zeroing fake edges
    needs_scores = return_scores or (
        train and cfg.score_drop > 0.0 and key is not None)
    from graphaibench_tpu.ops.spmm import _pick_impl

    if (dg.has_ell_layout and not needs_scores
            and _pick_impl(dg, cfg.spmm_impl) == "ell"):
        # fused softmax+aggregation (no per-edge score materialization)
        if trivial_w:
            # v2: logits computed inside the bucket passes; the (ne,)
            # logits array never exists (ops/fused_gat.py v2 notes)
            from graphaibench_tpu.ops.fused_gat import gat_attention_spmm_v2

            out = gat_attention_spmm_v2(dg, sl, sr, h)
        else:
            from graphaibench_tpu.ops.fused_gat import gat_attention_spmm

            logits = gmath.leaky_relu(sddmm_add(dg, sl, sr), 0.2)
            out = gat_attention_spmm(dg, logits, edge_w, h)
        return jax.nn.relu(out) if act else out
    logits = gmath.leaky_relu(sddmm_add(dg, sl, sr), 0.2)
    scores = segment_softmax(dg, logits) * edge_w
    if train and cfg.score_drop > 0.0 and key is not None:
        k2 = jax.random.fold_in(key, 1)
        scores, _ = gmath.dropout(k2, scores, cfg.score_drop)
    out = spmm(dg, scores, h, cfg.spmm_impl)
    out = jax.nn.relu(out) if act else out
    if return_scores:
        return out, scores
    return out


def ggnn_layer_fwd(p, dg: DeviceGraph, edge_w, x, *, act, cfg, train, key, trivial_w=False):
    """Gated GNN (GRU over summed neighbor messages) — the reference's
    GPU-only GGNN aggregator (ggnn_aggregator.cu) re-expressed densely:
    a = sum_nbr h; z = sig(aWz + hUz); r = sig(aWr + hUr);
    hcand = tanh(aWh + (r*h)Uh); h' = (1-z)*h + z*hcand."""
    x = _maybe_dropout(x, cfg.feat_drop, train, key)
    if x.shape[1] != p["W_neigh"].shape[1]:
        x = matmul(x, p["W_neigh"])  # project input into hidden size
    a = spmm(dg, edge_w, x, cfg.spmm_impl)
    z = jax.nn.sigmoid(matmul(a, p["Wz"]) + matmul(x, p["Uz"]))
    r = jax.nn.sigmoid(matmul(a, p["Wr"]) + matmul(x, p["Ur"]))
    hcand = jnp.tanh(matmul(a, p["Wh"]) + matmul(r * x, p["Uh"]))
    out = (1 - z) * x + z * hcand
    return jax.nn.relu(out) if act else out


_LAYER_FWD = {
    "gcn": gcn_layer_fwd,
    "sage": sage_layer_fwd,
    "gat": gat_layer_fwd,
    "ggnn": ggnn_layer_fwd,
}


def apply_model(
    cfg: ModelConfig,
    params: dict,
    dg: DeviceGraph,
    edge_w: jnp.ndarray,
    x: jnp.ndarray,
    *,
    train: bool = False,
    key: Optional[jax.Array] = None,
    return_intermediates: bool = False,
    trivial_w: bool = False,
):
    """Full forward pass: gconv stack [+ l2norm + dense] -> logits.
    Mirrors Model::forward_prop (net.cpp:457-502). ``trivial_w`` is a
    STATIC promise that edge_w is all-ones (full-batch graphs), which
    lets GAT take the v2 slot-space fused path."""
    fwd = _LAYER_FWD[cfg.arch]
    acts = []
    h = x
    for l, (_, _, act) in enumerate(cfg.gconv_dims):
        k = jax.random.fold_in(key, l) if key is not None else None
        layer = fwd
        if cfg.remat and not return_intermediates:
            layer = jax.checkpoint(
                functools.partial(fwd, act=act, cfg=cfg, train=train,
                                  key=k, trivial_w=trivial_w))
            h = layer(params["gconv"][l], dg, edge_w, h)
            if return_intermediates:
                acts.append(h)
            continue
        h = fwd(params["gconv"][l], dg, edge_w, h, act=act, cfg=cfg,
                train=train, key=k, trivial_w=trivial_w)
        if return_intermediates:
            acts.append(h)
    if cfg.use_l2norm:
        h = gmath.l2norm_rows(h)
        if return_intermediates:
            acts.append(h)
    if cfg.use_dense:
        h = matmul(h, params["dense"]["W"])
        if return_intermediates:
            acts.append(h)
    if return_intermediates:
        return h, acts
    return h
