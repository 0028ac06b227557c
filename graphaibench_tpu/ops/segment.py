"""Segment ops over CSR rows: softmax over each vertex's edge list.

The GAT attention normalization (gat_aggregator.cpp:78-80 softmax over a
vertex's outgoing edges) and its exact derivative (d_softmax,
gat_aggregator.cpp:132-153) expressed as edge-parallel segment ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from graphaibench_tpu.ops.device_graph import DeviceGraph, all_buckets


def _row_reduce_ell(g: DeviceGraph, vals: jnp.ndarray, kind: str) -> jnp.ndarray:
    """Per-source-row reduction of per-edge values via the ELL buckets:
    flat slot gathers + lane-halving group reductions + one small
    scatter per bucket, in place of jax.ops.segment_max/_sum's
    (ne,)-sized scatters (faster on the chip this was tuned on; not yet
    measured on the H100); the flat slot layout keeps every temp
    unpadded (ops.lanes)."""
    from graphaibench_tpu.ops.lanes import group_reduce

    if kind == "max":
        pad_val, init = -jnp.inf, jnp.full((g.nv,), -jnp.inf, vals.dtype)
    else:
        pad_val, init = 0.0, jnp.zeros((g.nv,), vals.dtype)
    v_pad = jnp.concatenate([vals, jnp.full((1,), pad_val, vals.dtype)])
    out = init
    for b in all_buckets(g):
        vb = group_reduce(v_pad[b.edge_id], b.width, kind)   # (R,)
        if kind == "max":
            out = out.at[b.row_ids].max(vb)
        else:
            out = out.at[b.row_ids].add(vb)
    return out


def segment_softmax(g: DeviceGraph, scores: jnp.ndarray) -> jnp.ndarray:
    """Row-wise (per-source-vertex) softmax of per-edge scores.

    Matches the reference's per-row ``softmax(deg, scores, norm_scores)``:
    max-subtracted exp, normalized within the row. The max shift is
    gradient-stopped (softmax is shift-invariant, and autodiff through a
    scatter-max transpose is pure waste)."""
    seg = g.edge_src
    use_ell = g.has_ell_layout
    if use_ell:
        row_max = _row_reduce_ell(g, scores, "max")
    else:
        row_max = jax.ops.segment_max(scores, seg, num_segments=g.nv,
                                      indices_are_sorted=True)
    # rows with no edges produce -inf max; they have no edges to index
    shifted = scores - jax.lax.stop_gradient(row_max)[seg]
    e = jnp.exp(shifted)
    if use_ell:
        denom = _row_reduce_ell(g, e, "sum")
    else:
        denom = jax.ops.segment_sum(e, seg, num_segments=g.nv,
                                    indices_are_sorted=True)
    return e / denom[seg]


def segment_softmax_vjp(
    g: DeviceGraph, y: jnp.ndarray, dy: jnp.ndarray
) -> jnp.ndarray:
    """Adjoint of segment_softmax given outputs y and cotangent dy:
    dx_e = y_e * (dy_e - sum_row(y*dy))  — the d_softmax of
    math_functions.cpp applied per row."""
    seg = g.edge_src
    inner = jax.ops.segment_sum(y * dy, seg, num_segments=g.nv,
                                indices_are_sorted=True)
    return y * (dy - inner[seg])


def segment_sum_edges(g: DeviceGraph, vals: jnp.ndarray) -> jnp.ndarray:
    return jax.ops.segment_sum(vals, g.edge_src, num_segments=g.nv,
                               indices_are_sorted=True)


# identity elements per reduction kind, chosen per dtype at trace time
def _ident(kind: str, dtype):
    if jnp.issubdtype(dtype, jnp.floating):
        return {"max": -jnp.inf, "min": jnp.inf, "sum": 0.0}[kind]
    info = jnp.iinfo(dtype)
    return {"max": info.min, "min": info.max, "sum": 0}[kind]


def _pad_edge_vals(edge_vals: jnp.ndarray) -> jnp.ndarray:
    """Append the pad-slot sentinel value. Pad slots are overwritten
    with the combine identity AFTER the edge-value combine
    (``neighbor_reduce``'s edge_id==ne mask), so any finite sentinel
    works; 0 keeps the combine arithmetic NaN-free for +/*."""
    return jnp.concatenate([edge_vals, jnp.zeros((1,), edge_vals.dtype)])


def pack_neighbor_edge_vals(g: DeviceGraph, edge_vals: jnp.ndarray,
                            kind: str = "min") -> tuple:
    """Pre-gather per-edge values into the ELL slot layout, one flat
    (R*W,) array per bucket. Passing the result as ``neighbor_reduce``'s
    ``edge_vals`` skips the per-slot edge-id scalar gather on EVERY
    call — for fixpoint solvers (SSSP) that gather is loop-invariant
    and this hoists it explicitly instead of trusting XLA's while-loop
    LICM with a multi-MB gather. ``kind`` is accepted for call-site
    symmetry with ``neighbor_reduce`` but does not affect the packing
    (pad slots are masked to the combine identity after the combine).
    Aligned with ``device_graph.layout_buckets`` ([S]-stacked per width
    on segmented graphs, flat per bucket on plain ELL). One jitted
    program for all buckets, not one eager gather each."""
    from graphaibench_tpu.ops.device_graph import layout_buckets

    eids = tuple(b.edge_id for b in layout_buckets(g))
    return _pack_nbr_gathers(jnp.asarray(edge_vals), eids)


@jax.jit
def _pack_nbr_gathers(edge_vals, eids):
    ev_pad = _pad_edge_vals(edge_vals)
    return jax.tree.map(lambda e: ev_pad[e], eids)


def neighbor_reduce(g: DeviceGraph, vals: jnp.ndarray, kind: str,
                    edge_vals=None) -> jnp.ndarray:
    """out[i] = reduce_{j in N(i)} vals[j]  (optionally combined with the
    per-edge value: vals[j] + edge_vals[e] for min/max, vals[j] *
    edge_vals[e] for sum). ``edge_vals`` is a (ne,) array or a
    pre-packed per-bucket tuple from ``pack_neighbor_edge_vals``.

    The PULL-mode relaxation primitive for frontier analytics
    (BFS/CC/PR/BC/SSSP): one dense (R, W) gather + reduction per degree
    bucket replaces the (ne,)-sized scatter-min/max of the push
    formulation (the reference's direction-optimizing pull pass,
    src/traversal/omp_direction.cc:31, mapped to row gathers). The
    vertex table is packed to 2 columns because on the chip this was
    tuned on a pure scalar gather ran at half the row rate (not yet
    measured on the H100).

    Requires ELL buckets (plain or column-segmented); N(i) here are the
    row-i neighbors in the bucket layout, i.e. out-neighbors — pass the
    reverse graph for in-neighbor pulls on directed graphs."""
    from graphaibench_tpu.ops.device_graph import seg_sweep
    from graphaibench_tpu.ops.lanes import group_reduce

    ident = _ident(kind, vals.dtype)
    v2 = jnp.stack([vals, vals], axis=1)               # 2-col packed
    out = jnp.full((g.nv,), ident, vals.dtype)
    packed = isinstance(edge_vals, tuple)
    if edge_vals is not None and not packed:
        ev_pad = _pad_edge_vals(edge_vals)

    def bucket_fn(out, b, pk, xs):
        from graphaibench_tpu.ops.spmm import bucket_row_chunks

        # chunked: on tiled device memory the (slots, 2) gather output
        # pads its minor dim to 128 lanes (64x), and an unchunked hub
        # bucket's temp reached GBs at rmat20
        w = b.width
        for clo, chi in bucket_row_chunks(b, 2):
            rows, nbr, eid = b.slot_slice(clo, chi)
            vb = xs[nbr][:, 0]                         # flat (r*W,)
            if edge_vals is not None:
                eb = (pk[clo * w:chi * w] if packed
                      else ev_pad[eid])
                vb = vb * eb if kind == "sum" else vb + eb
            vb = jnp.where(eid == g.ne, ident, vb)
            vb = group_reduce(vb, w, kind)             # (r,)
            if kind == "max":
                out = out.at[rows].max(vb)
            elif kind == "min":
                out = out.at[rows].min(vb)
            else:
                out = out.at[rows].add(vb)
        return out

    return seg_sweep(g, out, (v2,), bucket_fn,
                     edge_vals if packed else None)
