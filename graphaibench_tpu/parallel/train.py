"""Distributed full-batch GNN training over a device mesh.

The multi-chip/multi-host training path (BASELINE.json north star):
vertex-sharded features, per-shard local CSR with halo exchange between
layers (parallel.halo), replicated weights, gradient psum over the mesh
axis — pjit/shard_map replacing the reference's per-GPU host threads +
MPI_Allreduce + NVSHMEM (SURVEY.md §2.4).

Supports GCN, SAGE, and GGNN (static aggregation weights, own/halo
overlap split) and GAT (runtime attention via the fused v2 kernel on
the unified extended-table layout).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphaibench_tpu.nn.layers import ModelConfig
from graphaibench_tpu.nn import optim
from graphaibench_tpu.ops import math as gmath
from graphaibench_tpu.parallel.halo import AXIS, halo_exchange, sharded_spmm_local
from graphaibench_tpu.ops.device_graph import SEG_ELL_MIN_NV
from graphaibench_tpu.parallel.partition import ShardedGraph, pad_rows
from graphaibench_tpu.parallel.shard_ell import (
    ShardEll,
    ShardPackedW,
    build_shard_ell,
    gat_fused_local_v2,
    pack_shard_values,
    shard_specs,
    slot_spmm,
    slot_spmm_packed,
    strip_shard,
)


def _local_segment_softmax(edge_src, logits, valid, nv_pad):
    """Per-local-row softmax over this shard's edges. Edges of a row
    never cross shards (1-D vertex partition), so no collective is
    needed; padded edges are masked to -inf / zero."""
    neg = jnp.finfo(logits.dtype).min
    lg = jnp.where(valid, logits, neg)
    row_max = jax.ops.segment_max(lg, edge_src, num_segments=nv_pad)
    e = jnp.where(valid, jnp.exp(lg - row_max[edge_src]), 0.0)
    denom = jax.ops.segment_sum(e, edge_src, num_segments=nv_pad)
    return e / jnp.maximum(denom[edge_src], 1e-30)


def _make_aggregators(ga, ell, nv_pad, axis):
    """The per-shard aggregation closures shared by the 1-D forward and
    the tensor-parallel forward (both operate on whatever feature width
    they are handed — the ELL kernels and the halo all_to_all are
    feature-width-agnostic)."""
    se, wp = ell["se"], ell["wp"]
    se_own, wp_own = ell["se_own"], ell["wp_own"]
    se_halo, wp_halo = ell["se_halo"], ell["wp_halo"]

    def exchange(h):
        halo = halo_exchange(h, ga["send_idx"], ga["halo_map"], axis=axis)
        return jnp.concatenate([h, halo], axis=0)

    def aggregate_w(h_ext, w):
        if se.fwd:
            return slot_spmm(nv_pad, se, w, h_ext, ga["edge_src"],
                             ga["col_idx"], ga["edge_valid"])
        return sharded_spmm_local(ga["edge_src"], ga["col_idx"], w,
                                  h_ext, nv_pad)

    def aggregate(h):
        if se_own.fwd or se_halo.fwd:
            # overlap split: start the collective, aggregate interior
            # edges meanwhile, add the halo contribution when it lands
            halo = halo_exchange(h, ga["send_idx"], ga["halo_map"],
                                 axis=axis)
            out = slot_spmm_packed(nv_pad, se_own, wp_own, h)
            if se_halo.fwd:
                out = out + slot_spmm_packed(nv_pad, se_halo, wp_halo, halo)
            return out
        if wp.fwd:
            return slot_spmm_packed(nv_pad, se, wp, exchange(h))
        return aggregate_w(exchange(h), ga["edge_w"])

    return exchange, aggregate_w, aggregate


def _local_gconv_forward(cfg: ModelConfig, params, ga, x_own, *, axis=AXIS,
                         ell=None):
    """Per-shard forward of the gconv stack. ``ga`` holds this shard's
    graph arrays (leading axis already stripped). ``ell`` bundles the
    stripped per-shard ELL layouts + pre-gathered static weights:

      se / wp           — unified layouts over ALL local edges (gather
                          from x_ext = concat(own, halo)); the GAT path
                          and the runtime-weight fallback use these.
      se_own / wp_own   — owned-edge layouts (gather from x_own only).
      se_halo / wp_halo — halo-edge layouts (gather from x_halo only).

    With the own/halo split populated, the static-weight aggregation
    (GCN/SAGE) computes the interior partial sum with NO data dependency
    on the halo all_to_all, so XLA's latency-hiding scheduler can
    overlap the collective with the interior gather+reduce — the
    prefetched-halo replacement for NVSHMEM's mid-kernel remote fetch
    (bs_warp_vertex_nvshmem.cuh:30-34; SURVEY §7 hard part (c)). The
    degree-bucketed kernels replace gather+segment_sum/max everywhere
    (as in ops.spmm); ``wp*`` remove the per-slot w[edge_id] scalar
    gather from the GCN/SAGE aggregation fwd+bwd."""
    nv_pad = x_own.shape[0]
    exchange, aggregate_w, aggregate = _make_aggregators(ga, ell, nv_pad,
                                                         axis)
    se = ell["se"]
    h = x_own
    for l, (din, dout, act) in enumerate(cfg.gconv_dims):
        p = params["gconv"][l]
        if cfg.arch == "gat":
            # project, exchange projected rows, rank-1 logits, local
            # segment softmax, score-weighted aggregation
            t = jnp.dot(h, p["W_neigh"], precision=jax.lax.Precision.HIGHEST)
            t_ext = exchange(t)
            sl = t @ p["alpha_l"]                  # (nv_pad,)
            sr = t_ext @ p["alpha_r"]              # (nv_pad + h_max,)
            if se.fwd:
                # v2: logits computed inside the bucket passes; no
                # slot-space array is ever gathered (shard_ell.py notes)
                out = gat_fused_local_v2(nv_pad, se, sl, sr, t_ext)
            else:
                logits = sl[ga["edge_src"]] + sr[ga["col_idx"]]
                logits = jnp.where(logits > 0, logits, 0.2 * logits)
                scores = _local_segment_softmax(
                    ga["edge_src"], logits, ga["edge_valid"], nv_pad
                )
                out = aggregate_w(t_ext, scores)
        elif cfg.arch == "ggnn":
            # GRU over summed neighbor messages (ggnn_layer_fwd): the
            # aggregation is the same static-weight SpMM (all-ones), the
            # gates are row-local dense ops — shard-trivial
            t = h
            if t.shape[1] != p["W_neigh"].shape[1]:
                t = jnp.dot(t, p["W_neigh"],
                            precision=jax.lax.Precision.HIGHEST)
            a = aggregate(t)
            hp = jax.lax.Precision.HIGHEST
            z = jax.nn.sigmoid(jnp.dot(a, p["Wz"], precision=hp)
                               + jnp.dot(t, p["Uz"], precision=hp))
            r = jax.nn.sigmoid(jnp.dot(a, p["Wr"], precision=hp)
                               + jnp.dot(t, p["Ur"], precision=hp))
            hcand = jnp.tanh(jnp.dot(a, p["Wh"], precision=hp)
                             + jnp.dot(r * t, p["Uh"], precision=hp))
            out = (1 - z) * t + z * hcand
        elif din > dout:
            t = jnp.dot(h, p["W_neigh"], precision=jax.lax.Precision.HIGHEST)
            out = aggregate(t)
        else:
            t = aggregate(h)
            out = jnp.dot(t, p["W_neigh"], precision=jax.lax.Precision.HIGHEST)
        if cfg.arch == "sage":
            out = out + jnp.dot(h, p["W_self"],
                                precision=jax.lax.Precision.HIGHEST)
        h = jax.nn.relu(out) if act else out
    if cfg.use_l2norm:
        h = gmath.l2norm_rows(h)
    if cfg.use_dense:
        h = jnp.dot(h, params["dense"]["W"],
                    precision=jax.lax.Precision.HIGHEST)
    return h


MODEL_AXIS = "model"


def _tp_matmul(h_m, w, model_axis, *, scatter):
    """Megatron-style row-block GEMM for feature-dimension tensor
    parallelism: ``h_m`` is this model shard's column block (n, ceil(F/M))
    of the activations, ``w`` the full replicated (F, H) weight. Each
    shard multiplies by its own row block of ``w`` (so weight gradients
    are block-distinct and a psum over the model axis assembles — never
    duplicates — them), then the partial sums reduce-scatter over the H
    columns (scatter=True: activations stay column-sharded) or psum to a
    full replicated output (the classifier head).

    Ragged dims are handled by zero padding: ``w`` rows pad up to
    blk*M (zero rows contribute nothing and autodiff slices their grads
    away), and under scatter the H columns pad up to a multiple of M —
    the zero tail rides through elementwise ops and multiplies the zero
    pad rows of the NEXT layer's weight, so the math stays exact."""
    m_n = jax.lax.axis_size(model_axis)
    m_i = jax.lax.axis_index(model_axis)
    blk = h_m.shape[1]
    w_p = jnp.pad(w, ((0, blk * m_n - w.shape[0]), (0, 0)))
    w_b = jax.lax.dynamic_slice_in_dim(w_p, m_i * blk, blk, 0)
    partial = jnp.dot(h_m, w_b, precision=jax.lax.Precision.HIGHEST)
    if scatter:
        h_pad = -(-w.shape[1] // m_n) * m_n - w.shape[1]
        partial = jnp.pad(partial, ((0, 0), (0, h_pad)))
        return jax.lax.psum_scatter(partial, model_axis,
                                    scatter_dimension=1, tiled=True)
    return jax.lax.psum(partial, model_axis)


def _sum_cotangent(model_axis):
    """Megatron's "f" op: identity forward, psum backward. Inserted
    after a value that is REPLICATED over the model axis but whose
    downstream uses differ per shard (each shard consumes it with its
    own column block): the true cotangent is the sum of the per-shard
    partials, which plain per-shard autodiff would silently drop."""
    @jax.custom_vjp
    def g(x):
        return x

    def fwd(x):
        return x, None

    def bwd(_, ct):
        return (jax.lax.psum(ct, model_axis),)

    g.defvjp(fwd, bwd)
    return g


def _tp_scalar_dot(t_m, vec, model_axis):
    """Attention-scalar inner product under feature sharding:
    s = <t, vec> computed as psum of per-block partials (vec rows
    zero-pad to the block grid like _tp_matmul). The result is
    replicated but consumed blockwise downstream, so the cotangent
    re-psums via _sum_cotangent."""
    m_n = jax.lax.axis_size(model_axis)
    m_i = jax.lax.axis_index(model_axis)
    blk = t_m.shape[1]
    v_p = jnp.pad(vec, (0, blk * m_n - vec.shape[0]))
    v_b = jax.lax.dynamic_slice_in_dim(v_p, m_i * blk, blk, 0)
    return _sum_cotangent(model_axis)(
        jax.lax.psum(t_m @ v_b, model_axis))


def _local_gconv_forward_tp(cfg: ModelConfig, params, ga, x_own, *,
                            axis=AXIS, model_axis=MODEL_AXIS, ell=None):
    """Tensor-parallel per-shard forward (GCN/SAGE): the 2-D
    (graph x model) mesh shards vertices over ``axis`` (halo exchange,
    as in the 1-D path) and the FEATURE dimension over ``model_axis``.
    Activations live column-sharded between layers, so the aggregation
    gathers, the halo all_to_all bytes, and the GEMM FLOPs all divide
    by the model-axis size; each GEMM reduce-scatters its partial sums
    (SURVEY §2.4's optional TP row — the reference has no analog).
    Ragged dims zero-pad per _tp_matmul; the classifier output psums to
    a replicated full-width logits block for the loss."""
    nv_pad = x_own.shape[0]
    exchange, _, aggregate = _make_aggregators(ga, ell, nv_pad, axis)
    se = ell["se"]
    m_n = jax.lax.axis_size(model_axis)
    m_i = jax.lax.axis_index(model_axis)

    # entry: take this shard's column block of the (replicated) input,
    # zero-padded so every shard's block has the same static width
    blk0 = -(-x_own.shape[1] // m_n)
    x_p = jnp.pad(x_own, ((0, 0), (0, blk0 * m_n - x_own.shape[1])))
    h = jax.lax.dynamic_slice_in_dim(x_p, m_i * blk0, blk0, 1)
    for l, (din, dout, act) in enumerate(cfg.gconv_dims):
        p = params["gconv"][l]
        last_gconv = (l == cfg.num_layers - 1) and not cfg.use_dense
        scatter = not last_gconv            # hidden dims divide m_n
        if cfg.arch == "gat":
            # project column-sharded; attention scalars are full inner
            # products over the feature dim -> psum'd partials whose
            # cotangents re-psum (_tp_scalar_dot); the fused kernel then
            # weights this shard's value columns with the replicated
            # softmax scalars. GAT output stays column-sharded (the loss
            # head is the dense layer, use_dense — asserted below).
            t = _tp_matmul(h, p["W_neigh"], model_axis, scatter=True)
            t_ext = exchange(t)
            sl = _tp_scalar_dot(t, p["alpha_l"], model_axis)
            sr = _tp_scalar_dot(t_ext, p["alpha_r"], model_axis)
            if se.fwd:
                out = gat_fused_local_v2(nv_pad, se, sl, sr, t_ext)
            else:
                logits = sl[ga["edge_src"]] + sr[ga["col_idx"]]
                logits = jnp.where(logits > 0, logits, 0.2 * logits)
                scores = _local_segment_softmax(
                    ga["edge_src"], logits, ga["edge_valid"], nv_pad)
                _, aggregate_w, _ = _make_aggregators(ga, ell, nv_pad,
                                                      axis)
                out = aggregate_w(t_ext, scores)
        elif din > dout:
            t = _tp_matmul(h, p["W_neigh"], model_axis, scatter=scatter)
            out = aggregate(t)
        else:
            t = aggregate(h)
            out = _tp_matmul(t, p["W_neigh"], model_axis, scatter=scatter)
        if cfg.arch == "sage":
            out = out + _tp_matmul(h, p["W_self"], model_axis,
                                   scatter=scatter)
        h = jax.nn.relu(out) if act else out
    if cfg.use_l2norm:
        # row norms need the full row; h is column-sharded iff the
        # dense head follows (the last gconv then kept scatter=True)
        s2 = jnp.sum(h * h, axis=-1, keepdims=True)
        if cfg.use_dense:
            s2 = jax.lax.psum(s2, model_axis)
        h = h / jnp.sqrt(jnp.maximum(s2, 1e-12))
    if cfg.use_dense:
        h = _tp_matmul(h, params["dense"]["W"], model_axis, scatter=False)
    return h


@dataclasses.dataclass
class ShardedTrainer:
    """Jitted sharded train/eval functions bound to one mesh + graph."""

    mesh: Mesh
    train_step: Callable  # (params, opt_state) -> (params, opt_state, loss)
    eval_logits: Callable  # (params) -> (nv, C) on host logical shape
    nv: int
    # (params, opt_state, n) -> (params, opt_state, losses[n]): n steps
    # inside ONE dispatch via lax.scan, like Model.train_epochs
    train_steps: Callable = None
    # () -> float: one dim_hid-wide halo all_to_all measured ALONE,
    # device-synced — the `halo` row of the --timers breakdown. In the
    # production step the collective overlaps interior compute, so this
    # is its standalone (upper-bound) cost, not an additive share.
    halo_probe: Callable = None
    # (params, which) -> float: masked single-class accuracy computed
    # IN-MESH (per-shard correct/total counts psum-reduced) — multi-host
    # safe, unlike eval_logits which fetches a global array. Available
    # for the names passed via eval_ranges ("val"/"test").
    eval_accuracy: Callable = None


def prepare_trainer_host(
    cfg: ModelConfig,
    sg: ShardedGraph,
    feats: np.ndarray,
    labels: np.ndarray,
    train_range: tuple[int, int, int],
    train_mask: np.ndarray,
    *,
    use_ell: bool = True,
    overlap: bool = True,
    eval_ranges: dict | None = None,
) -> dict:
    """Everything the sharded trainer ships to devices, as HOST arrays
    grouped with their scalars — built once. ``make_sharded_trainer``
    device_puts the whole dict; ``parallel.shard_io.write_trainer_shards``
    persists per-shard slices so each host of a multi-host run loads
    only its own shard (the per-PE partition-file flow of the
    reference's NVSHMEM solver, multigpu_nvshmem.cu:13-120).

    ``eval_ranges`` maps a name (e.g. "val", "test") to a
    (range, mask) pair; each becomes a padded validity array for the
    in-mesh psum accuracy (``ShardedTrainer.eval_accuracy``)."""
    begin, end, _count = train_range
    nv, nv_total = sg.nv, sg.padded_nv

    # rows scatter through sg.perm (identity layout under the uniform
    # "vertex" partition; block-compacted under balance="edge")
    x_pad = pad_rows(feats.astype(np.float32), nv_total, sg.perm)
    lab_pad = pad_rows(labels.astype(np.int32), nv_total, sg.perm)
    idx = np.arange(nv)

    def _valid(rng_, mask):
        b, e, _ = rng_
        v = (idx >= b) & (idx < e)          # GLOBAL id ranges
        v = v & (np.asarray(mask)[:nv] != 0)
        return pad_rows(v, nv_total, sg.perm)

    valid_np = _valid(train_range, train_mask)
    count = max(int(valid_np.sum()), 1)
    eval_masks = {k: _valid(rng_, m)
                  for k, (rng_, m) in (eval_ranges or {}).items()}

    ga = {
        "edge_src": sg.edge_src,
        "col_idx": sg.col_idx,
        "edge_w": sg.edge_w,
        "edge_valid": sg.edge_valid,
        "send_idx": sg.send_idx,
        "halo_map": sg.halo_map,
    }

    # per-shard ELL layouts (empty ShardEll = fall back to segment ops).
    # GCN/SAGE static-weight aggregation uses the own/halo overlap split
    # (see _local_gconv_forward); GAT's fused v2 kernel reads the
    # unified extended-table layout. Only the layouts actually consumed
    # are built and shipped.
    empty_se, empty_wp = ShardEll((), ()), ShardPackedW((), ())
    use_packed = use_ell and cfg.arch != "gat"
    use_overlap = overlap and use_packed
    # GAT keeps the UNSEGMENTED (whole-extended-table) shard layout at
    # any scale, mirroring the single-chip plain-layout default:
    # segmenting fragments the fused attention passes (chosen on another
    # chip; not yet measured on the H100).
    seg_min = (1 << 62) if cfg.arch == "gat" else SEG_ELL_MIN_NV
    se_host = (build_shard_ell(sg, seg_min_rows=seg_min)
               if use_ell and not use_overlap else empty_se)
    wp_host = (pack_shard_values(se_host, sg.edge_w)
               if use_packed and se_host.fwd else empty_wp)
    ell_host = {"se": se_host, "wp": wp_host,
                "se_own": empty_se, "wp_own": empty_wp,
                "se_halo": empty_se, "wp_halo": empty_wp}
    if use_overlap:
        se_own = build_shard_ell(sg, part="own")
        se_halo = build_shard_ell(sg, part="halo")
        ell_host.update(
            se_own=se_own, wp_own=pack_shard_values(se_own, sg.edge_w),
            se_halo=se_halo, wp_halo=pack_shard_values(se_halo, sg.edge_w))
    if use_packed:
        # the packed kernels never gather by edge id — drop the
        # (P, R*W) id arrays before shipping (shard_ell.drop_edge_ids)
        from graphaibench_tpu.parallel.shard_ell import drop_edge_ids

        for k in ("se", "se_own", "se_halo"):
            if ell_host[k].fwd or ell_host[k].trans:
                ell_host[k] = drop_edge_ids(ell_host[k])
    if use_packed and (use_overlap or se_host.fwd):
        # the packed static-weight path (GCN/SAGE) never reads the raw
        # slot-space edge arrays — the aggregation is fully described by
        # the ELL layouts + pre-gathered weights. Shipping them anyway
        # costs ~1.7 GB of dead device memory at products scale; ship
        # 1-slot dummies instead (shapes only matter at trace time, and
        # the traced branch never touches them).
        p_ = sg.num_shards
        ga.update(edge_src=np.zeros((p_, 1), np.int32),
                  col_idx=np.zeros((p_, 1), np.int32),
                  edge_w=np.zeros((p_, 1), np.float32),
                  edge_valid=np.zeros((p_, 1), bool))

    perm = (None if sg.perm is None
            or np.array_equal(sg.perm, np.arange(nv)) else sg.perm)
    return dict(x=x_pad, lab=lab_pad, valid=valid_np, ga=ga, ell=ell_host,
                eval_masks=eval_masks, perm=perm,
                nv=nv, nv_pad=sg.nv_pad, num_shards=sg.num_shards,
                begin=begin, end=end, count=count)


def make_sharded_trainer(
    mesh: Mesh,
    cfg: ModelConfig,
    sg: ShardedGraph,
    feats: np.ndarray,
    labels: np.ndarray,
    train_range: tuple[int, int, int],
    train_mask: np.ndarray,
    *,
    optimizer: str = "adam",
    axis: str = AXIS,
    use_ell: bool = True,
    overlap: bool = True,
    eval_ranges: dict | None = None,
) -> ShardedTrainer:
    host = prepare_trainer_host(cfg, sg, feats, labels, train_range,
                                train_mask, use_ell=use_ell, overlap=overlap,
                                eval_ranges=eval_ranges)

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    return trainer_from_host(mesh, cfg, host, put, optimizer=optimizer,
                             axis=axis)


def make_tp_trainer(
    mesh: Mesh,
    cfg: ModelConfig,
    sg: ShardedGraph,
    feats: np.ndarray,
    labels: np.ndarray,
    train_range: tuple[int, int, int],
    train_mask: np.ndarray,
    *,
    optimizer: str = "adam",
    axis: str = AXIS,
    model_axis: str = MODEL_AXIS,
    use_ell: bool = True,
    overlap: bool = True,
    eval_ranges: dict | None = None,
) -> ShardedTrainer:
    """Tensor-parallel trainer over a 2-D (graph x model) mesh
    (multihost.hybrid_mesh): vertices shard over ``axis`` exactly like
    make_sharded_trainer (``sg`` must be built for the GRAPH-axis size),
    the feature dimension shards over ``model_axis``
    (_local_gconv_forward_tp). GCN/SAGE/GAT; ragged feature dims
    zero-pad per _tp_matmul. GAT requires the dense head (its gconv
    output stays column-sharded; the reference's GAT config always has
    it, net.cpp:447). GGNN is excluded: its GRU state would have to go
    full-width replicated at the classifier, double-counting gate
    gradients under the (graph, model) psum."""
    assert cfg.arch in ("gcn", "sage", "gat"), \
        "tensor parallelism covers gcn/sage/gat"
    assert cfg.arch != "gat" or cfg.use_dense, \
        "TP GAT needs use_dense (column-sharded gconv output)"
    assert sg.num_shards == dict(zip(mesh.axis_names,
                                     mesh.devices.shape))[axis], \
        "build_sharded_graph must use the graph-axis size, not n_devices"
    host = prepare_trainer_host(cfg, sg, feats, labels, train_range,
                                train_mask, use_ell=use_ell,
                                overlap=overlap, eval_ranges=eval_ranges)

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    return trainer_from_host(mesh, cfg, host, put, optimizer=optimizer,
                             axis=axis, model_axis=model_axis)


def trainer_from_host(
    mesh: Mesh,
    cfg: ModelConfig,
    host: dict,
    put: Callable,
    *,
    optimizer: str = "adam",
    axis: str = AXIS,
    model_axis: str | None = None,
) -> ShardedTrainer:
    """Assemble the jitted trainer from prepared host arrays. ``put``
    maps (host_array, PartitionSpec) -> device array; the single-process
    path passes a device_put closure, the multi-host per-shard-file path
    one built on jax.make_array_from_process_local_data (each process
    supplies only its own shards).

    With ``model_axis`` set (a second mesh axis), the forward runs the
    tensor-parallel path (_local_gconv_forward_tp): graph data and
    features are replicated over the model axis (the specs never name
    it) and the per-shard function slices its own feature block."""
    nv = host["nv"]
    begin, end, count = host["begin"], host["end"], host["count"]
    fwd = (_local_gconv_forward if model_axis is None else
           functools.partial(_local_gconv_forward_tp,
                             model_axis=model_axis))

    x_d = put(host["x"], P(axis, None))
    lab_d = put(host["lab"], P(axis))
    valid_d = put(host["valid"], P(axis))
    graph_arrays = {
        k: put(v, P(axis, None, None) if k == "send_idx" else P(axis, None))
        for k, v in host["ga"].items()
    }
    opt = optim.OPTIMIZERS[optimizer](lr=cfg.lr)

    ell_host = host["ell"]
    ell_spec = shard_specs(ell_host, axis)
    ell_dev = jax.tree.map(lambda a, s: put(a, s), ell_host, ell_spec)

    def _strip(ga):
        return {
            "edge_src": ga["edge_src"][0],
            "col_idx": ga["col_idx"][0],
            "edge_w": ga["edge_w"][0],
            "edge_valid": ga["edge_valid"][0],
            "send_idx": ga["send_idx"][0],
            "halo_map": ga["halo_map"][0],
        }

    def local_loss(params, x_own, lab_own, valid_own, ga, ell):
        logits = _local_gconv_forward(cfg, params, _strip(ga), x_own,
                                      axis=axis, ell=ell)
        probs = jax.nn.softmax(logits, axis=-1)
        onehot = jax.nn.one_hot(lab_own, logits.shape[-1], dtype=logits.dtype)
        ce = gmath.cross_entropy(onehot, probs)
        ce = jnp.where(valid_own, ce, 0.0)
        # this shard's share of the loss, with the reference gradient
        # scaling / (end - begin). It is summed over shards only after
        # differentiation: a psum inside the loss would transpose to a
        # psum of its cotangent and, with the gradient psum below, scale
        # every gradient by the shard count.
        return jnp.sum(ce) / max(end - begin, 1)

    def local_step(params, opt_state, x_own, lab_own, valid_own, ell,
                   *ga_flat):
        ga = dict(zip(("edge_src", "col_idx", "edge_w", "edge_valid",
                       "send_idx", "halo_map"), ga_flat))
        loss, grads = jax.value_and_grad(local_loss)(
            params, x_own, lab_own, valid_own, ga, strip_shard(ell)
        )
        # over the graph axis only: on a (graph x model) mesh the
        # tensor-parallel ops already sum cotangents over the model axis,
        # so every model-axis member holds the whole gradient
        grads = jax.lax.psum(grads, axis)
        loss = jax.lax.psum(loss, axis)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss * (end - begin) / count

    ga_specs = (P(axis, None), P(axis, None), P(axis, None), P(axis, None),
                P(axis, None, None), P(axis, None))
    params_spec = jax.tree.map(lambda _: P(), {"gconv": [
        {} for _ in range(cfg.num_layers)], **({"dense": {}} if cfg.use_dense else {})})

    step_sm = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(axis), P(axis), ell_spec)
        + ga_specs,
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    # big arrays enter the jitted fns as ARGUMENTS (device-resident,
    # passed by reference), never as captured constants, which would be
    # embedded in the compiled program
    ga_args = (graph_arrays["edge_src"], graph_arrays["col_idx"],
               graph_arrays["edge_w"], graph_arrays["edge_valid"],
               graph_arrays["send_idx"], graph_arrays["halo_map"])
    _step_jit = jax.jit(step_sm)

    def train_step(params, opt_state):
        return _step_jit(params, opt_state, x_d, lab_d, valid_d, ell_dev,
                         *ga_args)

    import functools as _ft

    @_ft.partial(jax.jit, static_argnums=0)
    def _steps_jit(n, params, opt_state, x, lab, valid, ell, *ga):
        def body(carry, _):
            p, o = carry
            p, o, loss = step_sm(p, o, x, lab, valid, ell, *ga)
            return (p, o), loss
        (p, o), losses = jax.lax.scan(body, (params, opt_state), None,
                                      length=n)
        return p, o, losses

    nv_pad_shard = host["nv_pad"]

    def train_steps(params, opt_state, n):
        # scan-batching amortizes per-step dispatch on SMALL graphs; at
        # large scale the scanned sharded step was ~5x the plain step on
        # the chip this was tuned on (the scan's buffer management under
        # memory pressure), so epochs loop on host there (not yet
        # measured on the H100; ROADMAP speed item 7)
        if nv_pad_shard >= SEG_ELL_MIN_NV:
            losses = []
            for _ in range(n):
                params, opt_state, loss = train_step(params, opt_state)
                losses.append(loss)
            return params, opt_state, jnp.stack(losses)
        return _steps_jit(n, params, opt_state, x_d, lab_d, valid_d,
                          ell_dev, *ga_args)

    def local_logits(params, x_own, ell, *ga_flat):
        ga = dict(zip(("edge_src", "col_idx", "edge_w", "edge_valid",
                       "send_idx", "halo_map"), ga_flat))
        return fwd(cfg, params, _strip(ga), x_own, axis=axis,
                   ell=strip_shard(ell))

    logits_sm = jax.shard_map(
        local_logits,
        mesh=mesh,
        in_specs=(P(), P(axis, None), ell_spec) + ga_specs,
        out_specs=P(axis, None),
        check_vma=False,
    )

    _logits_jit = jax.jit(logits_sm)

    perm_h = host.get("perm")

    def eval_logits(params):
        lg = _logits_jit(params, x_d, ell_dev, *ga_args)
        if perm_h is not None:   # edge-balanced blocks: de-permute rows
            return jnp.asarray(np.asarray(lg)[perm_h])
        return lg[:nv]

    # in-mesh masked accuracy: per-shard correct/total counts,
    # psum-reduced — the replicated scalars are process-local to fetch,
    # so multi-host eval never gathers global logits
    def local_counts(params, x_own, lab_own, vmask_own, ell, *ga_flat):
        ga = dict(zip(("edge_src", "col_idx", "edge_w", "edge_valid",
                       "send_idx", "halo_map"), ga_flat))
        logits = fwd(cfg, params, _strip(ga), x_own,
                     axis=axis, ell=strip_shard(ell))
        pred = jnp.argmax(logits, axis=-1)
        correct = jnp.sum(jnp.where(vmask_own, pred == lab_own,
                                    False).astype(jnp.int32))
        total = jnp.sum(vmask_own.astype(jnp.int32))
        return (jax.lax.psum(correct, axis), jax.lax.psum(total, axis))

    counts_sm = jax.shard_map(
        local_counts, mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis), P(axis), ell_spec) + ga_specs,
        out_specs=(P(), P()), check_vma=False)
    _counts_jit = jax.jit(counts_sm)
    eval_mask_dev = {k: put(v, P(axis))
                     for k, v in host.get("eval_masks", {}).items()}

    def eval_accuracy(params, which: str = "val") -> float:
        c, t = _counts_jit(params, x_d, lab_d, eval_mask_dev[which],
                           ell_dev, *ga_args)
        return float(c) / max(float(t), 1.0)

    def local_halo(h_own, send_idx, halo_map):
        halo = halo_exchange(h_own, send_idx[0], halo_map[0], axis=axis)
        return jnp.sum(halo)   # scalar output forces the collective

    halo_sm = jax.shard_map(
        local_halo, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None, None), P(axis, None)),
        out_specs=P(), check_vma=False)
    _halo_jit = jax.jit(halo_sm)
    probe_w = min(cfg.dim_hid, host["x"].shape[1])  # layer activation width

    def halo_probe():
        t0 = time.perf_counter()
        float(_halo_jit(x_d[:, :probe_w], graph_arrays["send_idx"],
                        graph_arrays["halo_map"]))   # float() = device sync
        return time.perf_counter() - t0

    return ShardedTrainer(mesh=mesh, train_step=train_step,
                          eval_logits=eval_logits, nv=nv,
                          train_steps=train_steps, halo_probe=halo_probe,
                          eval_accuracy=eval_accuracy)
