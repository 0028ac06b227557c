"""Fused GAT attention: softmax-over-edges + weighted SpMM in one op.

The reference fuses attention score + softmax + dropout into one CUDA
kernel (``compute_attn_score_warp``, include/gnn/graph_operations.h:250)
because materializing per-edge score traffic dominates GAT. In XLA the
expensive parts are per-edge (ne,)-sized broadcasts of the row max / row
denominator (``x[seg]`` gathers) and the scatter-heavy
``jax.ops.segment_*`` row reductions.

This op removes them: inside each ELL degree bucket the normalizers are
indexed **per row** (an (R,)-sized gather, ~30x fewer lookups), so the
softmax fuses into the aggregation pass and no normalized score vector is
ever written to device memory on the forward path. The backward pass is
an exact custom VJP (softmax adjoint + transposed-permutation SpMM + SDDMM),
mirroring the reference's hand-written GAT backward
(gat_aggregator.cpp:106-175) with the csr2cs​c replaced by the
host-precomputed edge permutation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from graphaibench_tpu.ops.device_graph import DeviceGraph
from graphaibench_tpu.ops.segment import _row_reduce_ell
from graphaibench_tpu.ops.spmm import sddmm_dot, spmm_ell


def _fused_fwd_pass(g: DeviceGraph, logits, edge_w, x, m, z):
    """One streaming pass: per-bucket normalized scores -> aggregation."""
    from graphaibench_tpu.ops.device_graph import seg_sweep
    from graphaibench_tpu.ops.lanes import group_sum_cols
    from graphaibench_tpu.ops.spmm import bucket_row_chunks

    l_pad = jnp.concatenate([logits, jnp.full((1,), -jnp.inf, logits.dtype)])
    w_pad = jnp.concatenate([edge_w, jnp.zeros((1,), edge_w.dtype)])
    out = jnp.zeros((g.nv, x.shape[1]), x.dtype)

    def bucket_fn(out, b, _pk, xs):
        for lo, hi in bucket_row_chunks(b, xs.shape[1]):
            rows, nbr, eid = b.slot_slice(lo, hi)
            lb = l_pad[eid].reshape(-1, b.width)     # (r, W)
            # row-indexed normalizers: r gathers, not ne
            sb = jnp.exp(lb - m[rows][:, None]) * z[rows][:, None]
            sb = (sb.reshape(-1) * w_pad[eid])       # flat (r*W,)
            # padded slots: exp(-inf - m) = 0 (m finite, edge_w pad 0)
            out = out.at[rows].add(
                group_sum_cols(xs[nbr] * sb[:, None], b.width))
        return out

    return seg_sweep(g, out, (x,), bucket_fn)


def _row_denom_ell(g: DeviceGraph, logits, m):
    """rowsum(exp(l - m[row])) as a streaming bucket pass (row-indexed m,
    no (ne,)-sized broadcast gather)."""
    from graphaibench_tpu.ops.device_graph import all_buckets

    from graphaibench_tpu.ops.lanes import group_reduce

    l_pad = jnp.concatenate([logits, jnp.full((1,), -jnp.inf, logits.dtype)])
    out = jnp.zeros((g.nv,), logits.dtype)
    for b in all_buckets(g):
        lb = l_pad[b.edge_id].reshape(-1, b.width)       # (R, W)
        eb = jnp.exp(lb - m[b.row_ids][:, None]).reshape(-1)
        out = out.at[b.row_ids].add(group_reduce(eb, b.width, "sum"))
    return out


def _norm_consts(g: DeviceGraph, logits):
    m = _row_reduce_ell(g, logits, "max")
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    # NORMAL f32 floor: 1e-38 is subnormal and XLA may flush it to zero,
    # making empty rows (padded sampled subgraphs) produce inf here
    # and NaN downstream (same rule as the v2 path below)
    z = 1.0 / jnp.maximum(_row_denom_ell(g, logits, m), 1e-30)
    return m, z


@functools.partial(jax.custom_vjp, nondiff_argnums=())
def gat_attention_spmm(g: DeviceGraph, logits: jnp.ndarray,
                       edge_w: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """out = A(softmax_row(logits) * edge_w) @ x, fused over ELL buckets.

    Fully differentiable in logits, edge_w, and x (edge_w's cotangent is
    softmax(logits) * <ct[src], x[dst]>, matching the unfused path)."""
    m, z = _norm_consts(g, logits)
    return _fused_fwd_pass(g, logits, edge_w, x, m, z)


def _fwd(g, logits, edge_w, x):
    m, z = _norm_consts(g, logits)
    y = _fused_fwd_pass(g, logits, edge_w, x, m, z)
    return y, (g, logits, edge_w, x, m, z)


def _scores_soft(g: DeviceGraph, logits, m, z):
    """Materialize the softmax scores (backward only). m and z travel in
    one packed (nv, 2) row gather instead of two scalar gathers."""
    mz = jnp.stack([m, z], axis=1)[g.edge_src]     # (ne, 2)
    return jnp.exp(logits - mz[:, 0]) * mz[:, 1]


def _bwd(res, ct):
    g, logits, edge_w, x, m, z = res
    # backward affords one materialized score vector
    s_soft = _scores_soft(g, logits, m, z)         # softmax(l)
    s = s_soft * edge_w                            # masked scores
    # dx: adjoint aggregation = same topology, transpose-permuted weights
    assert g.has_transpose
    dx = spmm_ell(g, s[g.trans_perm], ct)
    # per-edge <ct[src], x[dst]> feeds both the edge_w cotangent and the
    # softmax adjoint (matching the unfused segment_softmax path, so
    # gradient semantics don't depend on which implementation dispatches)
    raw = sddmm_dot(g, ct, x)
    dew = s_soft * raw
    dsw = raw * edge_w
    # softmax adjoint: dl = s * (dsw - rowsum(s*dsw)) with the row sum
    # computed by a streaming ELL pass
    inner = _row_reduce_ell(g, s_soft * dsw, "sum")
    dl = s_soft * (dsw - inner[g.edge_src])
    from graphaibench_tpu.ops.spmm import _zero_cotangent

    return (_zero_cotangent(g), dl, dew, dx)


gat_attention_spmm.defvjp(_fwd, _bwd)


# ---------------------------------------------------------------------------
# v2: slot-space fused attention — no per-edge logits array EVER exists.
# ---------------------------------------------------------------------------
#
# v1 materializes (ne,) logits via sddmm_add (2 slot gathers + adjoint
# row reductions) and then re-gathers them in every ELL pass (3 fwd
# passes). v2 exploits three structural facts:
#
#  1. PACKING: sr rides as an extra feature column of h — the
#     aggregation gather serves the logit computation, and z (the softmax
#     denominator) accumulates as an extra output column of the same
#     scatter. Forward needs ONE packed pass + one scalar rowmax pass.
#  2. EXACT ROWMAX VIA MONOTONICITY: leaky_relu is monotone, so
#     max_j leaky(sl_i + sr_j) = leaky(sl_i + max_j sr_j); the row max
#     of a PER-VERTEX quantity replaces the row max of per-edge logits.
#  3. INNER = <ct, out>: the softmax-adjoint row term
#     sum_j p_j <ct_i, h_j> equals <ct_i, sum_j p_j h_j> = <ct_i, out_i>
#     — computable elementwise from the saved forward output, deleting
#     an entire backward reduction pass.
#
# Backward = 2 passes (one fwd-layout for d_sl, one transpose-role for
# d_h + d_sr; the graph is structurally symmetric so the same buckets
# serve both roles, as in the v1 adjoint). Reference analog: the fused
# compute_attn_score_warp idea, include/gnn/graph_operations.h:250,
# with the cuSPARSE csr2csc adjoint replaced by bucket reuse.


# packed gathers in column chunks of at most this many bytes per row:
# chosen on another chip whose gather unit fell off past 512-byte rows;
# not yet measured on the H100 (ROADMAP design item 2)
_GATHER_MAX_BYTES = 512


def _col_chunks(total: int, itemsize: int = 4):
    """Split a packed gather of ``total`` columns of ``itemsize`` bytes
    into equal chunks that each stay within _GATHER_MAX_BYTES per row."""
    max_cols = max(_GATHER_MAX_BYTES // itemsize, 1)
    n = -(-total // max_cols)
    step = -(-total // n)
    return [(lo, min(lo + step, total)) for lo in range(0, total, step)]


# Gathered-operand dtype on LARGE graphs (shared policy: the v2 passes
# here and the sharded _ell_apply twins): bf16 halves bytes/row, so the
# (1+F)-column packed table fits ONE <=512 B gather chunk where f32
# needs two. Accumulation stays f32 (bf16 operands promote on use); only the
# gathered h / attention-scalar values round to bf16. Gated on the same
# threshold as the seg-ELL layout so small-graph parity stays exact.
V2_GATHER_BF16 = True


# default threshold 2^17, chosen on another chip where one bf16 gather
# chunk beat two f32 ones from this size; not yet measured on the H100.
# Small graphs (reference-parity tests) stay exact f32.
V2_BF16_MIN_NV = 1 << 17


def _v2_bf16_min_nv() -> int:
    """Vertex count above which v2 gathers round to bf16
    (GAB_V2_BF16_MIN_NV overrides for ablations)."""
    import os

    env = os.environ.get("GAB_V2_BF16_MIN_NV", "").strip()
    return int(env) if env else V2_BF16_MIN_NV


def _v2_gather_dtype(g: DeviceGraph, base):
    if V2_GATHER_BF16 and g.nv >= _v2_bf16_min_nv() and base == jnp.float32:
        return jnp.bfloat16
    return base


def _bucket_views(b, clo, chi):
    """Row-chunk views: (row_ids, edge_id 2-D (r, W) view, nbr FLAT).
    The gather indexes with the flat ids (unpadded (r*W, c) output);
    per-slot arithmetic happens in (r, W) space via _gather3."""
    rows, nbrf, eidf = b.slot_slice(clo, chi)
    return rows, eidf.reshape(-1, b.width), nbrf


def _gather3(xs, nbr_flat, width):
    """(r, W, c) gather via a 2-D view of the flat INDEX array. The
    index reshape is a small padded transient (~(1/W)(128/c) of the
    gathered bytes); reshaping the GATHERED data instead materializes a
    copy of the whole operand."""
    return xs[nbr_flat.reshape(-1, width)]


def _seq(acc, nbr, enable):
    """Tie a bucket chunk's gather indices to the running accumulator.
    Without this artificial dependency XLA hoists EVERY bucket/chunk
    gather before the first scatter — at rmat20 that kept ~128 GB of
    (r, W, F) stages live. The barrier forces one-stage-at-a-time
    liveness. Hoisting overlaps work on smaller graphs, so it is gated
    on graph size — the same threshold as the seg-ELL layout switch."""
    if not enable:
        return acc, nbr
    acc, nbr = jax.lax.optimization_barrier((acc, nbr))
    return acc, nbr


# Narrow-bucket W-reductions are UNROLLED into 2-D slice ops: for any
# 3-D reduction over a small middle dim, XLA materializes a transposed
# copy with the middle dim minormost and T(8,128)-padded (32x for a
# width-4 bucket on tiled device memory). 2-D slices have no such
# layout freedom.
_UNROLL_W = 16
# tighter per-stage cap for the v2 passes on LARGE graphs: two packed
# column-chunks are live per stage plus outputs, and at rmat20 the
# default 1 GB stages exhausted device memory on the chip this was
# tuned on: 2^27 elements = 512 MB per gathered chunk (not yet measured
# on the H100)
_V2_STAGE_ELEMS = 1 << 27


def _wsum(w, x):
    """einsum('rw,rwf->rf') without dot/reduce layout hazards."""
    W = x.shape[1]
    if W <= _UNROLL_W:
        out = w[:, 0, None] * x[:, 0, :]
        for k in range(1, W):
            out = out + w[:, k, None] * x[:, k, :]
        return out
    return (w[:, :, None] * x).sum(axis=1)


def _dotw(a, x):
    """einsum('rf,rwf->rw') without dot/reduce layout hazards."""
    W = x.shape[1]
    if W <= _UNROLL_W:
        return jnp.stack([(a * x[:, k, :]).sum(axis=-1) for k in range(W)],
                         axis=1)
    return (a[:, None, :] * x).sum(axis=-1)


def _sr_rowmax(g: DeviceGraph, sr):
    """Per-row max of the neighbor-side attention scalar. The table is
    packed to 2 columns (see ops.segment.neighbor_reduce)."""
    from graphaibench_tpu.ops.device_graph import seg_sweep
    from graphaibench_tpu.ops.lanes import group_reduce
    from graphaibench_tpu.ops.spmm import bucket_row_chunks

    sr2 = jnp.stack([sr, sr], axis=1)                     # (nv, 2)
    out = jnp.full((g.nv,), -jnp.inf, sr.dtype)

    def bucket_fn(out, b, _pk, xs):
        # chunked: on tiled device memory the (slots, 2) gather output
        # pads its minor dim to 128 lanes (64x)
        for clo, chi in bucket_row_chunks(b, 2):
            rows, nbr, eid = b.slot_slice(clo, chi)
            vb = jnp.where(eid == g.ne, -jnp.inf, xs[nbr][:, 0])
            out = out.at[rows].max(group_reduce(vb, b.width, "max"))
        return out

    return seg_sweep(g, out, (sr2,), bucket_fn)


def _v2_fwd_pass(g: DeviceGraph, sl, sr, h, m):
    """Packed pass: gather [sr | h] in <=_GATHER_MAX_BYTES column
    chunks, logits per slot from chunk 0, online exp, accumulate
    [sum eb*h | sum eb] in one scatter."""
    from graphaibench_tpu.ops.device_graph import SEG_ELL_MIN_NV, seg_sweep
    from graphaibench_tpu.ops.spmm import bucket_row_chunks

    seq = g.nv >= SEG_ELL_MIN_NV
    f = h.shape[1]
    gdt = _v2_gather_dtype(g, h.dtype)
    xa = jnp.concatenate([sr[:, None], h], axis=1).astype(gdt)  # (nv, 1+F)
    chunks = _col_chunks(f + 1, jnp.dtype(gdt).itemsize)
    acc = jnp.zeros((g.nv, f + 1), h.dtype)

    def bucket_fn(acc, b, _pk, xs):
        for clo, chi in bucket_row_chunks(
                b, f + 1, _V2_STAGE_ELEMS if seq else None):
            rows, eid, nbr = _bucket_views(b, clo, chi)
            acc, nbr = _seq(acc, nbr, seq)
            gs = [_gather3(xs[:, c0:c1], nbr, b.width) for c0, c1 in chunks]
            raw = sl[rows][:, None] + gs[0][..., 0]
            l = jnp.where(raw > 0, raw, 0.2 * raw)
            eb = jnp.exp(l - m[rows][:, None])
            eb = jnp.where(eid == g.ne, 0.0, eb)
            parts = [_wsum(eb, gs[0][..., 1:])]
            parts += [_wsum(eb, ga) for ga in gs[1:]]
            parts.append(eb.sum(axis=1)[:, None])
            acc = acc.at[rows].add(jnp.concatenate(parts, axis=1))
        return acc

    acc = seg_sweep(g, acc, (xa,), bucket_fn)
    z = acc[:, f]
    # floor must be a NORMAL f32: 1e-38 is subnormal and flushes to zero
    # under XLA, making zinv=inf and 0*inf=NaN on edgeless rows
    zinv = 1.0 / jnp.maximum(z, 1e-30)
    return acc[:, :f] * zinv[:, None], zinv


@jax.custom_vjp
def gat_attention_spmm_v2(g: DeviceGraph, sl: jnp.ndarray, sr: jnp.ndarray,
                          h: jnp.ndarray) -> jnp.ndarray:
    """out = softmax-weighted aggregation with logits
    leaky_relu(sl[src] + sr[dst]) computed INSIDE the bucket passes.
    Requires trivial (all-ones) edge weights and a structurally
    symmetric graph — the full-batch GAT case (gat_aggregator.cpp:57-102
    semantics); sampled/masked paths use v1."""
    m0 = _sr_rowmax(g, sr)
    m = jnp.where(jnp.isfinite(m0), m0, 0.0)
    raw = sl + m
    m = jnp.where(raw > 0, raw, 0.2 * raw)   # = exact row max of logits
    out, _ = _v2_fwd_pass(g, sl, sr, h, m)
    return out


def _v2_fwd(g, sl, sr, h):
    m0 = _sr_rowmax(g, sr)
    m = jnp.where(jnp.isfinite(m0), m0, 0.0)
    raw = sl + m
    m = jnp.where(raw > 0, raw, 0.2 * raw)
    out, zinv = _v2_fwd_pass(g, sl, sr, h, m)
    return out, (g, sl, sr, h, m, zinv, out)


def _v2_bwd(res, ct):
    from graphaibench_tpu.ops.spmm import _zero_cotangent, bucket_row_chunks

    g, sl, sr, h, m, zinv, out = res
    from graphaibench_tpu.ops.device_graph import SEG_ELL_MIN_NV, seg_sweep

    seq = g.nv >= SEG_ELL_MIN_NV
    f = h.shape[1]
    # softmax-adjoint row term: inner_i = sum_j p_j <ct_i, h_j>
    #                                   = <ct_i, out_i>  (fact 3)
    inner = jnp.sum(ct * out, axis=1)

    # pass B1 (fwd layout): d_sl[i] = sum_j p_ij (dsw_ij - inner_i) l'
    # packed [sr | h], gathered in <=512-byte chunks (bf16 at scale)
    gdt = _v2_gather_dtype(g, h.dtype)
    xa = jnp.concatenate([sr[:, None], h], axis=1).astype(gdt)
    chunks1 = _col_chunks(f + 1, jnp.dtype(gdt).itemsize)

    def b1_fn(dsl, b, _pk, xs):
        for clo, chi in bucket_row_chunks(
                b, f + 1, _V2_STAGE_ELEMS if seq else None):
            rows, eid, nbr = _bucket_views(b, clo, chi)
            dsl, nbr = _seq(dsl, nbr, seq)
            gs = [_gather3(xs[:, c0:c1], nbr, b.width) for c0, c1 in chunks1]
            raw = sl[rows][:, None] + gs[0][..., 0]
            l = jnp.where(raw > 0, raw, 0.2 * raw)
            p = jnp.exp(l - m[rows][:, None]) * zinv[rows][:, None]
            p = jnp.where(eid == g.ne, 0.0, p)
            ctr = ct[rows]
            dsw = _dotw(ctr[:, chunks1[0][0]:chunks1[0][1] - 1],
                        gs[0][..., 1:])
            for (c0, c1), ga in zip(chunks1[1:], gs[1:]):
                dsw = dsw + _dotw(ctr[:, c0 - 1:c1 - 1], ga)
            dlraw = p * (dsw - inner[rows][:, None])
            dlraw = dlraw * jnp.where(raw > 0, 1.0, 0.2)
            dsl = dsl.at[rows].add(dlraw.sum(axis=1))
        return dsl

    dsl = seg_sweep(g, jnp.zeros((g.nv,), sl.dtype), (xa,), b1_fn)

    # pass B2 (transpose role -- same buckets, symmetric graph): for
    # bucket rows j with neighbors i, edge (i -> j) carries
    # p = exp(leaky(sl_i + sr_j) - m_i) * zinv_i;
    #   d_h[j]  = sum_i p ct_i        d_sr[j] = sum_i dlraw_ij
    # packed [sl, m, zinv, inner | ct] chunked the same way
    tb = jnp.concatenate(
        [sl[:, None], m[:, None], zinv[:, None], inner[:, None], ct],
        axis=1).astype(gdt)
    chunks2 = _col_chunks(f + 4, jnp.dtype(gdt).itemsize)

    def b2_fn(carry, b, _pk, ts):
        dh, dsr = carry
        for clo, chi in bucket_row_chunks(
                b, f + 4, _V2_STAGE_ELEMS if seq else None):
            rows, eid, nbr = _bucket_views(b, clo, chi)
            dh, nbr = _seq(dh, nbr, seq)
            gs = [_gather3(ts[:, c0:c1], nbr, b.width) for c0, c1 in chunks2]
            raw = gs[0][..., 0] + sr[rows][:, None]        # sl_i + sr_j
            l = jnp.where(raw > 0, raw, 0.2 * raw)
            p = jnp.exp(l - gs[0][..., 1]) * gs[0][..., 2]
            p = jnp.where(eid == g.ne, 0.0, p)
            hr = h[rows]
            # ct columns start at packed col 4; chunk k covers packed
            # cols [c0, c1) -> ct cols [c0-4, c1-4)
            dsw = _dotw(hr[:, chunks2[0][0]:chunks2[0][1] - 4],
                        gs[0][..., 4:])
            dh_parts = [_wsum(p, gs[0][..., 4:])]
            for (c0, c1), ga in zip(chunks2[1:], gs[1:]):
                dsw = dsw + _dotw(hr[:, c0 - 4:c1 - 4], ga)
                dh_parts.append(_wsum(p, ga))
            dlraw = p * (dsw - gs[0][..., 3])
            dlraw = dlraw * jnp.where(raw > 0, 1.0, 0.2)
            dh = dh.at[rows].add(jnp.concatenate(dh_parts, axis=1))
            dsr = dsr.at[rows].add(dlraw.sum(axis=1))
        return dh, dsr

    dh, dsr = seg_sweep(
        g, (jnp.zeros((g.nv, f), h.dtype), jnp.zeros((g.nv,), sr.dtype)),
        (tb,), b2_fn)

    return (_zero_cotangent(g), dsl, dsr, dh)


gat_attention_spmm_v2.defvjp(_v2_fwd, _v2_bwd)
