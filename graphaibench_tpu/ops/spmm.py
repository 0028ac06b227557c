"""Sparse matrix-times-dense-matrix (SpMM) — the GNN aggregation kernel.

out[s] = sum over edges (s -> d) of  w_e * X[d]      (row-gather form)

This replaces the reference's hand-rolled aggregators
(gcn_aggregator.cpp:48-77 CPU loop, graph_operations.h:85-140 warp
kernels, cuSPARSE csrmm). Three execution strategies:

  * ``coo``   — X gather by col_idx + segment_sum over edge_src. Always
                correct; materializes an (E, F) intermediate.
  * ``ell``   — per degree-bucket dense gather + weighted reduction. XLA
                fuses gather*weight*sum into one streaming loop, so memory
                traffic is ~ E_padded*F reads + N*F writes (near optimal);
                power-law skew is handled by the pow-2 bucketing instead
                of warp-level load balancing.
  * ``dense`` — scatter w into an N x N dense matrix and use one
                matmul, for small graphs (N up to 4096) where the whole
                adjacency fits comfortably.

``spmm`` wraps the strategies in a custom VJP: for the structurally
symmetric graphs GNNs aggregate over, the adjoint is an SpMM on the same
topology with transpose-permuted weights (the reference leans on the same
fact: gcn_aggregator.cpp:35-46; GAT builds the transposed scores with
csr2csc, gat_aggregator.cpp:175 — here a host-precomputed permutation).
The weight gradient is an SDDMM.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from graphaibench_tpu.ops.device_graph import DeviceGraph


def spmm_coo(g: DeviceGraph, w: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Gather + segment-sum path."""
    msgs = x[g.col_idx] * w[:, None]
    return jax.ops.segment_sum(msgs, g.edge_src, num_segments=g.nv,
                               indices_are_sorted=True)


# gathered column slices of at most this many bytes per row: chosen on
# another chip whose gather unit fell off past 512-byte rows; not yet
# measured on the H100 (ROADMAP design item 2)
_GATHER_ROW_BYTES = 512


# Gathered-operand dtype for the PLAIN/SEG SpMM feature path: f32 (on
# the chip this was tuned on, bf16 gathers were slower here). GAT v2
# keeps bf16 (fused_gat._v2_gather_dtype). GAB_SPMM_BF16=1 re-enables
# rounding here for ablations.
def _spmm_gather_dtype(g: DeviceGraph, base):
    import os

    from graphaibench_tpu.ops.device_graph import SEG_ELL_MIN_NV

    env = os.environ.get("GAB_SPMM_BF16", "").strip().lower()
    want = env in ("1", "true", "on", "yes")
    if want and g.nv >= SEG_ELL_MIN_NV and base == jnp.float32:
        return jnp.bfloat16
    return base


def spmm_ell(g: DeviceGraph, w: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Degree-bucketed ELL path. Requires g.ell buckets. Wide feature
    matrices are processed in <=512-byte column slices
    (_GATHER_ROW_BYTES). Gathered operands stay f32
    (_spmm_gather_dtype)."""
    assert g.ell or g.seg_ell is not None, \
        "DeviceGraph built without ELL buckets"
    base = x.dtype
    gdt = _spmm_gather_dtype(g, base)
    if gdt != base:
        x = x.astype(gdt)
    f = x.shape[1]
    chunk = max(_GATHER_ROW_BYTES // x.dtype.itemsize, 1)
    if f <= chunk:
        return _spmm_ell_cols(g, w, x, base)
    parts = [
        _spmm_ell_cols(g, w, x[:, c : c + chunk], base)
        for c in range(0, f, chunk)
    ]
    return jnp.concatenate(parts, axis=1)


# cap on the materialized (rows, W, F) gather per stage: XLA materializes
# the einsum input, so an unchunked hub bucket on a ~30M-edge graph would
# need >10 GB. 2^28 padded f32 elements = 1 GB per stage
# (bucket_row_chunks counts f at its 128-lane-padded width). Chosen on
# another chip; not yet measured on the H100. GAB_STAGE_ELEMS_LOG2
# overrides — the narrow-F (class-dim) aggregation
# trades stage count against transient size 8x either way.
import os as _os

_ELL_STAGE_ELEMS = 1 << int(_os.environ.get("GAB_STAGE_ELEMS_LOG2", "28"))


def bucket_row_chunks(b, f: int, cap: int | None = None):
    """Row ranges of an ELL bucket bounded to ``cap`` (default
    _ELL_STAGE_ELEMS) elements of gathered (rows*W, f) data per chunk.

    ``f`` is counted at its width padded up to 128, as the tiled device
    memory of the chip this was tuned on stores a (slots, 16) gather
    output as (slots, 128): capping on logical elements let
    narrow-feature stages (the class-dim layer) grow 8x past the
    budget. Not yet measured on the H100."""
    r = b.rows
    cap = cap or _ELL_STAGE_ELEMS
    f_pad = -(-max(f, 1) // 128) * 128
    step = max(1, cap // max(b.width * f_pad, 1))
    return [(s, min(s + step, r)) for s in range(0, r, step)]


def _packed_view(w):
    """Per-bucket pre-gathered weights, if ``w`` carries them: a
    PackedEdgeW (forward view) or a bare tuple (adjoint view)."""
    from graphaibench_tpu.ops.device_graph import PackedEdgeW

    if isinstance(w, PackedEdgeW):
        return w.fwd
    if isinstance(w, tuple):
        return w
    return None


def _bucket_accumulate(out, b, xs, wb_flat, f):
    """Shared inner stage: flat gather + weight + group collapse +
    scatter-add, chunked to the padded-lane stage budget.

    Collapse kernels, GAB_SPMM_KERNEL (trace-time):
      * einsum2d (default) — reshape the (rw,) INDEX/weight arrays to
        (r, W) — small padded transients, ~(1/W)(128/F) of the gathered
        bytes — and gather DIRECTLY into (r, W, F) for the contraction,
        with the flat at-rest slot arrays intact.
      * einsum — flat gather (rw, F), then reshape the GATHERED data to
        3-D: the reshape materializes a copy of the whole gathered
        operand.
      * flat — multiply then ops.lanes.group_sum_cols tree adds
        (slowest, kept for the ablation record)."""
    import os

    from graphaibench_tpu.ops.lanes import group_sum_cols

    kern = os.environ.get(
        "GAB_SPMM_KERNEL", "einsum2d").strip().lower()
    w = b.width
    for clo, chi in bucket_row_chunks(b, f):
        rows, nbr, _ = b.slot_slice(clo, chi)
        wb = wb_flat if (clo, chi) == (0, b.rows) else \
            wb_flat[clo * w:chi * w]
        if kern == "einsum2d":
            contrib = jnp.einsum("rw,rwf->rf", wb.reshape(-1, w),
                                 xs[nbr.reshape(-1, w)])
        elif kern == "einsum":
            gat = xs[nbr]
            contrib = jnp.einsum("rw,rwf->rf", wb.reshape(-1, w),
                                 gat.reshape(-1, w, gat.shape[1]))
        else:
            # flat gather: (rw, F) output, minor dim = the feature
            # chunk — no narrow-lane padding (ops.lanes rationale)
            contrib = group_sum_cols(xs[nbr] * wb[:, None], w)
        # add, not set: heavy rows are split across several virtual
        # rows
        out = out.at[rows].add(contrib.astype(out.dtype))
    return out


def _spmm_ell_cols(g: DeviceGraph, w, x: jnp.ndarray,
                   out_dtype=None) -> jnp.ndarray:
    """One <=512-byte column slice of the ELL SpMM. ``w`` is a (ne,)
    array (runtime per-edge values, e.g. GAT scores) or a packed
    per-bucket view (static weights — skips the scalar edge-id gather;
    see PackedEdgeW). ``out_dtype`` is the accumulator dtype when ``x`` was
    rounded for gathering (bf16-at-scale policy). At scale the bucket
    sweep is a lax.scan over segments (device_graph.seg_sweep); padded
    scan rows contribute nothing
    (sentinel edge ids gather weight zero)."""
    from graphaibench_tpu.ops.device_graph import seg_sweep

    packed = _packed_view(w)
    out = jnp.zeros((g.nv, x.shape[1]), dtype=out_dtype or x.dtype)
    w_pad = (jnp.concatenate([w, jnp.zeros((1,), w.dtype)])
             if packed is None else None)
    f = x.shape[1]

    def bucket_fn(out, b, pk, xs):
        wb = w_pad[b.edge_id] if pk is None else pk
        return _bucket_accumulate(out, b, xs, wb, f)

    return seg_sweep(g, out, (x,), bucket_fn, packed)


def spmm_dense(g: DeviceGraph, w: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Materialize the weighted adjacency and use one matmul."""
    a = jnp.zeros((g.nv, g.nv), dtype=x.dtype)
    a = a.at[g.edge_src, g.col_idx].add(w)
    # full f32 products: default precision may round the inputs (TF32
    # on the GPU), which breaks allclose parity with the reference
    return jnp.dot(a, x, precision=jax.lax.Precision.HIGHEST)


_IMPLS = {"coo": spmm_coo, "ell": spmm_ell, "dense": spmm_dense}


def _pick_impl(g: DeviceGraph, impl: str) -> str:
    if impl != "auto":
        return impl
    # dense below 4096 vertices: chosen on another chip, where the matrix
    # unit was otherwise idle; not yet measured on the H100
    if g.nv <= 4096:
        return "dense"
    return "ell" if g.has_ell_layout else "coo"


def _zero_cotangent(g: DeviceGraph):
    """float0 cotangents for the (integer) graph arrays — the graph is
    data to the custom VJP but carries no gradient."""
    import numpy as np

    def z(t):
        if jnp.issubdtype(t.dtype, jnp.floating):
            return jnp.zeros_like(t)
        return np.zeros(t.shape, dtype=jax.dtypes.float0)

    return jax.tree.map(z, g)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _spmm_diff(g: DeviceGraph, w: jnp.ndarray, x: jnp.ndarray, impl: str = "auto") -> jnp.ndarray:
    return _IMPLS[_pick_impl(g, impl)](g, w, x)


def _spmm_fwd(g, w, x, impl):
    return _spmm_diff(g, w, x, impl), (g, w, x)


def _spmm_bwd(impl, res, ct):
    g, w, x = res
    assert g.has_transpose, "DeviceGraph built without transpose permutation"
    # adjoint aggregation: same topology, transpose-permuted weights
    w_t = w[g.trans_perm]
    dx = _IMPLS[_pick_impl(g, impl)](g, w_t, ct)
    # weight gradient: per-edge dot(ct[src], x[dst]) — SDDMM (chunked)
    dw = sddmm_dot(g, ct, x)
    return (_zero_cotangent(g), dw, dx)


_spmm_diff.defvjp(_spmm_fwd, _spmm_bwd)


@jax.custom_vjp
def _spmm_packed(g: DeviceGraph, wp, x: jnp.ndarray) -> jnp.ndarray:
    return spmm_ell(g, wp, x)


def _spmm_packed_fwd(g, wp, x):
    return spmm_ell(g, wp, x), (g, wp, x)


def _spmm_packed_bwd(res, ct):
    from graphaibench_tpu.ops.device_graph import PackedEdgeW

    g, wp, x = res
    assert wp.t is not None, "PackedEdgeW built without transpose view"
    # adjoint aggregation on the pre-gathered transpose view: no scalar
    # edge-id gather on the backward pass either
    dx = spmm_ell(g, wp.t, ct)
    # raw-weight cotangent (an SDDMM); the packed views carry none —
    # they are derived data. XLA DCEs this when w is a training constant
    # (the GCN/SAGE/GGNN case).
    dwp = PackedEdgeW(raw=sddmm_dot(g, ct, x),
                      fwd=jax.tree.map(jnp.zeros_like, wp.fwd),
                      t=jax.tree.map(jnp.zeros_like, wp.t))
    return (_zero_cotangent(g), dwp, dx)


_spmm_packed.defvjp(_spmm_packed_fwd, _spmm_packed_bwd)


def spmm(g: DeviceGraph, w, x: jnp.ndarray, impl: str = "auto") -> jnp.ndarray:
    """Differentiable SpMM. ``g`` must be structurally symmetric for the
    custom adjoint (all reference GNN graphs are); use the raw strategy
    functions for asymmetric topologies. ``w`` is a (ne,) per-edge value
    array or a PackedEdgeW of static pre-gathered weights (the fast path
    for GCN/SAGE/GGNN at scale)."""
    from graphaibench_tpu.ops.device_graph import PackedEdgeW

    if isinstance(w, PackedEdgeW):
        if _pick_impl(g, impl) == "ell":
            return _spmm_packed(g, w, x)
        # an explicitly requested non-ELL strategy (impl sweeps /
        # ablations) wins over the packed fast path: fall back to the
        # raw (ne,) weights so the measured strategy is the labeled one
        w = w.raw
    return _spmm_diff(g, w, x, impl)


def sddmm_dot(g: DeviceGraph, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-edge dot product s_e = <a[src_e], b[dst_e]> — the reference's
    score-gradient kernel (gat_aggregator.cpp:106-113,
    compute_scores_grad_warp graph_operations.h).

    Chunked over edges: the two (E, F) gathers are materialized by XLA,
    which at 32M edges x 128 features is 2 x 15.7 GB. Each chunk stays
    under ~1 GB."""
    f = max(a.shape[1], 1)
    step = max(1, (1 << 28) // f)
    if g.ne <= step:
        return jnp.einsum("ef,ef->e", a[g.edge_src], b[g.col_idx])
    parts = []
    for lo in range(0, g.ne, step):
        hi = min(lo + step, g.ne)
        parts.append(jnp.einsum("ef,ef->e", a[g.edge_src[lo:hi]],
                                b[g.col_idx[lo:hi]]))
    return jnp.concatenate(parts)


@jax.custom_vjp
def sddmm_add(g: DeviceGraph, sa: jnp.ndarray, sb: jnp.ndarray) -> jnp.ndarray:
    """Per-edge s_e = sa[src_e] + sb[dst_e] (GAT rank-1 attention logits,
    gat_aggregator.cpp:57-80: a_l.Wh_i + a_r.Wh_j).

    Custom VJP: the autodiff adjoint of a (ne,)-gather is a (ne,)-scatter
    -add; the row sums stream through the ELL
    buckets instead (dst side via the host-precomputed transpose
    permutation)."""
    return sa[g.edge_src] + sb[g.col_idx]


def _sddmm_add_fwd(g, sa, sb):
    return sa[g.edge_src] + sb[g.col_idx], g


def _sddmm_add_bwd(g, ct):
    if g.has_ell_layout:
        from graphaibench_tpu.ops.segment import _row_reduce_ell

        dsa = _row_reduce_ell(g, ct, "sum")
        dsb = (_row_reduce_ell(g, ct[g.trans_perm], "sum")
               if g.has_transpose else
               jax.ops.segment_sum(ct, g.col_idx, num_segments=g.nv))
    else:
        dsa = jax.ops.segment_sum(ct, g.edge_src, num_segments=g.nv,
                                  indices_are_sorted=True)
        dsb = jax.ops.segment_sum(ct, g.col_idx, num_segments=g.nv)
    return _zero_cotangent(g), dsa, dsb


sddmm_add.defvjp(_sddmm_add_fwd, _sddmm_add_bwd)
