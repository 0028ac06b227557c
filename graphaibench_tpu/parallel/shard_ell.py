"""Stacked per-shard ELL layouts + slot-space kernels for the sharded
trainer.

``jax.ops.segment_sum``/``segment_max`` big scatters lost badly to
degree-bucketed ELL reductions on the chip this was tuned on (not yet
measured on the H100).  This module brings the ELL machinery to the
sharded trainer:

  * Each shard's local edge list (local row -> extended-local col, see
    ``parallel.partition``) is packed into degree-bucketed ELL on host,
    BOTH ways: a forward layout grouped by local row and a transpose
    layout grouped by extended-local column.  The transpose built once
    on host replaces autodiff's big scatter in the backward pass — the
    same trick ``DeviceGraph.trans_perm`` plays for the single-chip
    path (reference analog: cuSPARSE csr2csc per step,
    gat_aggregator.cu:88-92, hoisted to preprocessing).
  * Because shard_map needs identical array shapes on every shard, the
    per-shard bucket lists are padded to a common (R, W) grid and
    stacked with a leading [P] axis (``ShardEll``); padding rows carry
    the sentinel edge id so they gather weight 0 and contribute nothing.
  * The local kernels (``slot_spmm``, ``slot_sddmm_add``,
    ``gat_fused_local``) mirror ops.spmm / ops.fused_gat but operate on
    a RECTANGULAR local graph: nv_pad output rows x (nv_pad + h_max)
    input rows.  That asymmetry is why the single-chip custom VJPs
    (which assume structural symmetry) cannot be reused directly.

Per-edge values live in "slot space": arrays of length e_max indexed by
the shard's edge slot, with slot e_max acting as the zero/neutral
sentinel (so each kernel pads value arrays by one element before
gathering by bucket edge ids).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.ops.device_graph import (
    SEG_ELL_MIN_NV,
    SEG_ROWS,
    EllBucket,
    ell_from_coo,
)
from graphaibench_tpu.ops.spmm import _zero_cotangent, bucket_row_chunks


def _seq_local(acc, nbr, n_gather_rows: int):
    """Sequential-liveness barrier for large shards (see
    ops.fused_gat._seq: XLA otherwise hoists every stage's gather and
    the program exceeds device memory at million-row shards)."""
    from graphaibench_tpu.ops.device_graph import SEG_ELL_MIN_NV

    if n_gather_rows < SEG_ELL_MIN_NV:
        return acc, nbr
    acc, nbr = jax.lax.optimization_barrier((acc, nbr))
    return acc, nbr


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardEll:
    """Stacked ELL layouts of all shards' local graphs. Every array has
    a leading shard axis [P] so the structure shards along the mesh
    axis; strip it inside shard_map with ``local_shard_ell``.
    ``sentinel`` is the STATIC padding edge id (= e_max at build).

    When a layout is column-SEGMENTED (its gather table exceeds the
    seg threshold), its buckets carry an extra segment axis —
    row_ids (P, S, R_w), nbr/edge_id (P, S, R_w*w), padded to uniform
    shapes like ops.device_graph.SegmentedEll — and the matching
    ``*_bounds`` tuple holds the static equal-edge column ranges. The
    kernels then sweep segments with ONE lax.scan body
    (shard_sweep): the unrolled segmented programs grew with segments x
    buckets and churned buffers at products scale."""

    fwd: tuple    # tuple[EllBucket, ...] rows = local rows [0, nv_pad)
    trans: tuple  # tuple[EllBucket, ...] rows = ext-local cols [0, nv_pad+h_max)
    sentinel: int = 0
    fwd_bounds: tuple = None    # static ((lo, hi), ...) or None
    trans_bounds: tuple = None
    # GROUPED stacking (mirroring SegmentedEll.group_segs):
    # fwd[i]/trans[i] is one width's row-sorted GROUP of segments with
    # arrays (P, Sg, ...) stacked over these static segment-id tuples;
    # None = legacy uniform stacking (P, S, ...) aligned with bounds.
    # Row counts pad to the group max over BOTH the shard and segment
    # axes (shard_map needs shard-uniform shapes) — 1.52x -> ~1.2x ne
    # slots at products shape.
    fwd_groups: tuple = None
    trans_groups: tuple = None

    def tree_flatten(self):
        return (self.fwd, self.trans), (self.sentinel, self.fwd_bounds,
                                        self.trans_bounds, self.fwd_groups,
                                        self.trans_groups)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(fwd=children[0], trans=children[1], sentinel=aux[0],
                   fwd_bounds=aux[1], trans_bounds=aux[2],
                   fwd_groups=aux[3], trans_groups=aux[4])


def _iter_shard(buckets: tuple, bounds, groups=None):
    """Unrolled iteration over a (possibly segmented) stripped layout:
    yields (bucket_view, (lo, hi) or None). With grouped stacking
    (``groups``: static segment-id tuples aligned with buckets), each
    bucket is one width's group and iteration is group-major."""
    if bounds is None:
        for b in buckets:
            yield b, None
        return
    if groups is not None:
        for segs_ids, b in zip(groups, buckets):
            for j, s in enumerate(segs_ids):
                eid = None if b.edge_id is None else b.edge_id[j]
                yield (EllBucket(row_ids=b.row_ids[j], nbr=b.nbr[j],
                                 edge_id=eid, width=b.width), bounds[s])
        return
    for s, (lo, hi) in enumerate(bounds):
        for b in buckets:
            eid = None if b.edge_id is None else b.edge_id[s]
            yield (EllBucket(row_ids=b.row_ids[s], nbr=b.nbr[s],
                             edge_id=eid, width=b.width), (lo, hi))


def _iter_shard_packed(buckets, bounds, groups, packed):
    """(bucket_view, slice, packed_slice) triples for unrolled sweeps —
    packed tuples align with buckets (per group when grouped)."""
    if bounds is None:
        for k, b in enumerate(buckets):
            yield b, None, (None if packed is None else packed[k])
        return
    if groups is not None:
        for gi, (segs_ids, b) in enumerate(zip(groups, buckets)):
            for j, s in enumerate(segs_ids):
                eid = None if b.edge_id is None else b.edge_id[j]
                bv = EllBucket(row_ids=b.row_ids[j], nbr=b.nbr[j],
                               edge_id=eid, width=b.width)
                yield bv, bounds[s], (
                    None if packed is None else packed[gi][j])
        return
    for s, (lo, hi) in enumerate(bounds):
        for i, b in enumerate(buckets):
            eid = None if b.edge_id is None else b.edge_id[s]
            bv = EllBucket(row_ids=b.row_ids[s], nbr=b.nbr[s],
                           edge_id=eid, width=b.width)
            yield bv, (lo, hi), (None if packed is None else packed[i][s])


def shard_sweep(buckets: tuple, bounds, carry, tables: tuple, bucket_fn,
                packed=None, groups=None):
    """Run ``bucket_fn(carry, bucket, packed_slice, *table_slices)``
    over a stripped shard layout — lax.scan per stacked group when
    grouped (mirroring ops.device_graph.sweep_grouped), lax.scan over
    the uniform segment axis otherwise (sweep_stacked; GAB_SEG_SCAN=0
    forces unrolled), plain loop when unsegmented. ``tables`` are
    gather tables sliced per segment; per-row tables must be closed
    over."""
    import os

    from graphaibench_tpu.ops.device_graph import sweep_stacked

    scan_on = os.environ.get("GAB_SEG_SCAN", "").strip().lower() not in (
        "0", "false", "off", "no")
    if bounds is not None and groups is not None:
        rows_needed = max((hi for _, hi in bounds), default=1)
        for segs_ids in groups:
            if len(segs_ids) > 1 and scan_on:
                win_g = max(bounds[s][1] - bounds[s][0] for s in segs_ids)
                reach = max(bounds[s][0] for s in segs_ids) + win_g
                rows_needed = max(rows_needed, reach)

        def pad_tab(t):
            pad = rows_needed - t.shape[0]
            if pad <= 0:
                return t
            return jnp.pad(t, ((0, pad),) + ((0, 0),) * (t.ndim - 1))

        tabs = tuple(pad_tab(t) for t in tables)
        for gi, (segs_ids, b) in enumerate(zip(groups, buckets)):
            pk = None if packed is None else packed[gi]
            if len(segs_ids) == 1 or not scan_on:
                for j, s in enumerate(segs_ids):
                    lo, hi = bounds[s]
                    eid = None if b.edge_id is None else b.edge_id[j]
                    bv = EllBucket(row_ids=b.row_ids[j], nbr=b.nbr[j],
                                   edge_id=eid, width=b.width)
                    ts = tuple(t[lo:hi] for t in tables)
                    carry = bucket_fn(carry, bv,
                                      None if pk is None else pk[j], *ts)
                continue
            win = max(bounds[s][1] - bounds[s][0] for s in segs_ids)
            los = jnp.asarray(np.asarray(
                [bounds[s][0] for s in segs_ids], np.int32))

            def body(c, ins, win=win):
                lo_s, bk, pkk = ins
                ts = tuple(jax.lax.dynamic_slice_in_dim(t, lo_s, win,
                                                        axis=0)
                           for t in tabs)
                return bucket_fn(c, bk, pkk, *ts), None

            carry, _ = jax.lax.scan(body, carry, (los, b, pk))
        return carry
    if bounds is not None and len(bounds) >= 2 and scan_on:
        return sweep_stacked(bounds, buckets, carry, tables, bucket_fn,
                             packed)
    for b, sl, pk in _iter_shard_packed(buckets, bounds, None, packed):
        ts = tuple(t if sl is None else t[sl[0]:sl[1]] for t in tables)
        carry = bucket_fn(carry, b, pk, *ts)
    return carry


def strip_shard(tree):
    """Strip the leading length-1 block axis shard_map hands each shard
    (any pytree of stacked per-shard arrays)."""
    return jax.tree.map(lambda a: a[0], tree)


def shard_specs(tree, axis: str):
    """PartitionSpec pytree sharding every leaf along its leading axis
    (any pytree of stacked per-shard arrays)."""
    from jax.sharding import PartitionSpec as P

    return jax.tree.map(
        lambda a: P(axis, *([None] * (np.asarray(a).ndim - 1))), tree)


# the historical per-structure names, kept for external callers
local_shard_ell = strip_shard
shard_ell_specs = shard_specs


def _stack_bucket_lists(bucket_lists, num_shards: int, sentinel: int):
    """Pad per-shard bucket lists to common shapes and stack on a new
    leading [P] axis. Widths absent on a shard become all-padding rows
    (row id 0, edge id = sentinel -> zero contribution)."""
    widths = sorted({b.width for bl in bucket_lists for b in bl})
    out = []
    for w in widths:
        per = [next((b for b in bl if b.width == w), None)
               for bl in bucket_lists]
        rmax = max((b.rows for b in per if b is not None), default=0)
        rmax = max(rmax, 1)
        row = np.zeros((num_shards, rmax), np.int32)
        # flat (P, rmax*w) slot arrays — the EllBucket storage layout
        nbr = np.zeros((num_shards, rmax * w), np.int32)
        eid = np.full((num_shards, rmax * w), sentinel, np.int32)
        for p, b in enumerate(per):
            if b is None:
                continue
            r = b.rows
            row[p, :r] = b.row_ids
            nbr[p, :r * w] = b.nbr
            eid[p, :r * w] = b.edge_id
        out.append(EllBucket(row_ids=row, nbr=nbr, edge_id=eid, width=w))
    return tuple(out)


def _stack_layout(per_shard_lists, num_shards, sentinel, bounds):
    """Stack per-shard bucket lists. ``bounds`` non-None means the
    lists are per-segment (one entry per bounds range, aligned across
    shards because the ranges come from the GLOBAL column histogram).

    GROUPED stacking (mirroring device_graph._group_segments): within a
    width, segments sort by their max-over-shards row count and cut into
    <= GAB_SEG_GROUPS groups; each group stacks (P, Sg, R_g) /
    (P, Sg, R_g*w) padded only to ITS max over both axes (shard_map
    needs shard-uniform shapes, so the shard axis still pads to the
    worst shard). Empty (width, segment) pairs vanish. Returns
    (buckets, group_segs) — group_segs None when unsegmented."""
    import os

    if bounds is None:
        return (_stack_bucket_lists(per_shard_lists, num_shards, sentinel),
                None)
    widths = sorted({b.width for bl in per_shard_lists
                     for seg in bl for b in seg})
    nseg = len(bounds)
    max_groups = max(int(os.environ.get("GAB_SEG_GROUPS", "4") or 4), 1)
    group_segs, buckets = [], []
    for w in widths:
        rows_s = np.zeros(nseg, np.int64)
        per: dict = {}
        for p, bl in enumerate(per_shard_lists):
            for s, seg in enumerate(bl):
                b = next((b for b in seg if b.width == w), None)
                if b is not None and b.rows > 0:
                    per[(p, s)] = b
                    rows_s[s] = max(rows_s[s], b.rows)
        entries = [(s, int(rows_s[s])) for s in range(nseg) if rows_s[s]]
        if not entries:
            continue
        entries.sort(key=lambda e: (-e[1], e[0]))
        ratio = 1.3
        while True:
            groups, cur = [], [entries[0]]
            for e in entries[1:]:
                if cur[0][1] > ratio * e[1]:
                    groups.append(cur)
                    cur = [e]
                else:
                    cur.append(e)
            groups.append(cur)
            if len(groups) <= max_groups:
                break
            ratio *= 1.5
        for grp in groups:
            rmax = max(r for _, r in grp)
            sg_n = len(grp)
            row = np.zeros((num_shards, sg_n, rmax), np.int32)
            nbr = np.zeros((num_shards, sg_n, rmax * w), np.int32)
            eid = np.full((num_shards, sg_n, rmax * w), sentinel, np.int32)
            for j, (s, _r) in enumerate(grp):
                for p in range(num_shards):
                    b = per.get((p, s))
                    if b is None:
                        continue
                    r = b.rows
                    row[p, j, :r] = b.row_ids
                    nbr[p, j, :r * w] = b.nbr
                    eid[p, j, :r * w] = b.edge_id
            group_segs.append(tuple(s for s, _ in grp))
            buckets.append(EllBucket(row_ids=row, nbr=nbr, edge_id=eid,
                                     width=w))
    return tuple(buckets), tuple(group_segs)


def build_shard_ell(sg, split: Optional[int] = None,
                    seg_rows: int = SEG_ROWS,
                    seg_min_rows: int = SEG_ELL_MIN_NV,
                    part: str = "all",
                    with_trans: bool = True) -> ShardEll:
    """Build both stacked layouts from a host ShardedGraph. The edge-id
    space of shard p is its slot index [0, e_max) with sentinel e_max,
    matching the per-shard edge arrays the trainer already ships.

    Shards whose gather tables exceed ``seg_min_rows`` rows get the
    column-segmented layout (every gather confined to a seg_rows slice);
    below that, whole-table gathers are already in the fast regime.

    ``part`` selects which edges the layout covers (the halo-overlap
    split, SURVEY §7 hard part (c)):
      * "all"  — every local edge; forward gathers from the extended
        table x_ext = concat(x_own, x_halo) (nv_pad + h_max rows).
      * "own"  — only edges whose source column is an OWNED row; the
        forward gathers straight from x_own (nv_pad rows), with no
        data dependency on the halo exchange.
      * "halo" — only halo-sourced edges, columns shifted by -nv_pad so
        the forward gathers from x_halo (h_max rows).
    Aggregating "own" + "halo" separately equals the "all" layout
    exactly (disjoint edge partition scatter-added into the same rows),
    but frees XLA to overlap the all_to_all with the interior ("own")
    aggregation — the NVSHMEM-mid-kernel-fetch replacement's latency
    hiding (bs_warp_vertex_nvshmem.cuh:30-34)."""
    from graphaibench_tpu.ops.device_graph import seg_bounds

    P, e_max = sg.num_shards, sg.e_max
    nv_ext = sg.nv_pad + sg.h_max
    n_fwd_gather = {"all": nv_ext, "own": sg.nv_pad, "halo": sg.h_max}[part]

    # per-shard edge triples first: the segment boundaries are EQUAL-
    # EDGE over the GLOBAL column histogram (ops.device_graph.seg_bounds
    # rationale — equal-vertex ranges + power-law skew padded the
    # stacked slots 3-4x; global bounds keep them static and identical
    # across shards, which shard_map requires)
    triples = []
    for p in range(P):
        n_e = int(sg.edge_valid[p].sum())
        rows = sg.edge_src[p, :n_e].astype(np.int64)
        cols = sg.col_idx[p, :n_e].astype(np.int64)
        eids = np.arange(n_e, dtype=np.int64)
        if part == "own":
            sel = cols < sg.nv_pad
            rows, cols, eids = rows[sel], cols[sel], eids[sel]
        elif part == "halo":
            sel = cols >= sg.nv_pad
            rows, cols, eids = rows[sel], cols[sel] - sg.nv_pad, eids[sel]
        triples.append((rows, cols, eids))

    seg_fwd = n_fwd_gather >= seg_min_rows
    seg_trans = sg.nv_pad >= seg_min_rows
    fwd_bounds = trans_bounds = None
    if seg_fwd:
        fwd_bounds = seg_bounds(
            n_fwd_gather, np.concatenate([t[1] for t in triples]), seg_rows)
    if seg_trans and with_trans:
        trans_bounds = seg_bounds(
            sg.nv_pad, np.concatenate([t[0] for t in triples]), seg_rows)

    def layouts(rows, cols, eids, bounds):
        if bounds is None:
            return ell_from_coo(rows, cols, eids, e_max, split,
                                as_numpy=True)
        # ONE stable counting sort by segment key instead of a boolean
        # mask pass per segment (O(nseg * ne) -> O(ne), which dominated
        # the products-scale trainer build)
        from graphaibench_tpu import native
        from graphaibench_tpu.ops.device_graph import _run_lengths

        nseg = len(bounds)
        los = np.asarray([lo for lo, _ in bounds], np.int64)
        keys = (np.searchsorted(los, np.asarray(cols, np.int64),
                                side="right") - 1).astype(np.int32)
        perm = native.stable_key_sort(keys, nseg)
        if perm is None:
            perm = np.argsort(keys, kind="stable")
        counts = np.bincount(keys, minlength=nseg)
        starts = np.concatenate([[0], np.cumsum(counts)])
        per_seg = []
        for s, (lo, _hi) in enumerate(bounds):
            sel = perm[starts[s]:starts[s + 1]]
            per_seg.append(ell_from_coo(rows[sel], cols[sel] - lo,
                                        eids[sel], e_max, split,
                                        as_numpy=True))
        return per_seg

    fwd_lists, trans_lists = [], []
    for rows, cols, eids in triples:
        fwd_lists.append(layouts(rows, cols, eids, fwd_bounds))
        if with_trans:
            trans_lists.append(layouts(cols, rows, eids, trans_bounds))
    fwd, fwd_groups = _stack_layout(fwd_lists, P, e_max, fwd_bounds)
    # the transpose layout (the x-adjoint's scatter replacement) is only
    # needed for training; forward-only consumers (distributed
    # analytics, the weak-scaling bench) skip the edge-scale build+ship
    trans, trans_groups = (), None
    if with_trans:
        trans, trans_groups = _stack_layout(trans_lists, P, e_max,
                                            trans_bounds)
    return ShardEll(fwd=fwd, trans=trans, sentinel=e_max,
                    fwd_bounds=fwd_bounds, trans_bounds=trans_bounds,
                    fwd_groups=fwd_groups, trans_groups=trans_groups)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardPackedW:
    """Pre-gathered static edge weights for the sharded kernels — the
    stacked twin of ops.device_graph.PackedEdgeW. ``fwd[i]`` aligns with
    se.fwd[i] (and ``t`` with se.trans): (P, R*W) stacked flat, or
    (R*W,) after local stripping. Kills the runtime w_pad[edge_id] scalar
    gather (see PackedEdgeW) from GCN/SAGE forward+backward
    aggregation."""

    fwd: tuple
    t: tuple

    def tree_flatten(self):
        return (self.fwd, self.t), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(fwd=children[0], t=children[1])


def pack_shard_values(se: ShardEll, w: np.ndarray) -> ShardPackedW:
    """Host-side pre-gather: ``w`` is the stacked (P, e_max) slot-value
    array (sg.edge_w). Runs in numpy at build time — no device gathers."""
    w = np.asarray(w)
    w_pad = np.concatenate([w, np.zeros((w.shape[0], 1), w.dtype)], axis=1)

    def pk(buckets):
        out = []
        for b in buckets:
            eid = np.asarray(b.edge_id)      # (P, R*W) or (P, S, R*W)
            flat = np.take_along_axis(w_pad, eid.reshape(eid.shape[0], -1),
                                      axis=1)
            out.append(flat.reshape(eid.shape).astype(w_pad.dtype))
        return tuple(out)

    return ShardPackedW(fwd=pk(se.fwd), t=pk(se.trans))


def drop_edge_ids(se: ShardEll) -> ShardEll:
    """ShardEll with edge_id arrays dropped (None): the packed
    static-weight kernels gather weights from the pre-packed tables and
    never by edge id, so shipping the (P, R*W) int32 id arrays is dead
    device memory — ~1.3 GB across the fwd+trans layouts at products
    scale."""

    def strip_any(bk):
        return dataclasses.replace(bk, edge_id=None)

    return dataclasses.replace(
        se, fwd=tuple(strip_any(b) for b in se.fwd),
        trans=tuple(strip_any(b) for b in se.trans))


def local_packed_w(wp: ShardPackedW) -> ShardPackedW:
    """Strip the leading length-1 block axis shard_map hands each shard."""
    return jax.tree.map(lambda a: a[0], wp)


def packed_w_specs(wp: ShardPackedW, axis: str):
    from jax.sharding import PartitionSpec as P

    return jax.tree.map(lambda a: P(axis, *([None] * (a.ndim - 1))), wp)


# ---------------------------------------------------------------------------
# slot-space kernels (run INSIDE shard_map on a stripped ShardEll)
# ---------------------------------------------------------------------------


def ell_row_reduce(buckets, vals: jnp.ndarray, n_rows: int,
                   kind: str) -> jnp.ndarray:
    """Per-row reduction of slot values over a bucket tuple — the
    rectangular generalization of ops.segment._row_reduce_ell."""
    if kind == "max":
        pad_val, init = -jnp.inf, jnp.full((n_rows,), -jnp.inf, vals.dtype)
    else:
        pad_val, init = 0.0, jnp.zeros((n_rows,), vals.dtype)
    from graphaibench_tpu.ops.lanes import group_reduce

    v_pad = jnp.concatenate([vals, jnp.full((1,), pad_val, vals.dtype)])
    out = init
    for b in buckets:
        # slot reductions ignore the gather slice: flatten any segment
        # axis (slot ids are global in [0, e_max])
        rows = b.row_ids.reshape(-1)
        vb = group_reduce(v_pad[b.edge_id.reshape(-1)], b.width, kind)
        if kind == "max":
            out = out.at[rows].max(vb)
        else:
            out = out.at[rows].add(vb)
    return out


def ell_gather_reduce(buckets, x_ext: jnp.ndarray, n_out: int,
                      kind: str, sentinel: int,
                      bounds=None, groups=None) -> jnp.ndarray:
    """out[r] = reduce over this shard's edges (r -> c) of x_ext[c] —
    the rectangular pull-mode reduction (ops.segment.neighbor_reduce's
    sharded twin), used by the distributed frontier solvers. ``x_ext``
    is a 1-D extended-local value vector; padding slots (edge_id ==
    ``sentinel``) are masked to the reduction identity."""
    if jnp.issubdtype(x_ext.dtype, jnp.floating):
        lo, hi = jnp.finfo(x_ext.dtype).min, jnp.finfo(x_ext.dtype).max
    else:
        lo, hi = jnp.iinfo(x_ext.dtype).min, jnp.iinfo(x_ext.dtype).max
    from graphaibench_tpu.ops.lanes import group_reduce

    ident = {"min": hi, "max": lo, "sum": 0}[kind]
    ident = jnp.asarray(ident, x_ext.dtype)
    out = jnp.full((n_out,), ident, x_ext.dtype)

    def bucket_fn(out, b, _pk, xs):
        for clo, chi in bucket_row_chunks(b, 1):
            rows, nbr, eid = b.slot_slice(clo, chi)
            vb = jnp.where(eid == sentinel, ident, xs[nbr])
            vb = group_reduce(vb, b.width, kind)
            if kind == "min":
                out = out.at[rows].min(vb)
            elif kind == "max":
                out = out.at[rows].max(vb)
            else:
                out = out.at[rows].add(vb)
        return out

    return shard_sweep(buckets, bounds, out, (x_ext,), bucket_fn,
                       groups=groups)


def ell_gather_reduce_plus(buckets, packed: tuple, x_ext: jnp.ndarray,
                           n_out: int, kind: str, sentinel: int,
                           bounds=None, groups=None) -> jnp.ndarray:
    """out[r] = reduce over this shard's edges (r -> c) of
    (x_ext[c] + w_slot) — the tropical (min-plus / max-plus) pull
    reduction behind distributed SSSP relaxation. ``packed[i]`` aligns
    with buckets[i] (pre-gathered static edge weights, ShardPackedW
    layout), so no per-slot edge-id gather happens at runtime. Padding
    slots reduce to the identity (+inf for min on floats)."""
    if jnp.issubdtype(x_ext.dtype, jnp.floating):
        ident = {"min": jnp.inf, "max": -jnp.inf}[kind]
    else:
        ii = jnp.iinfo(x_ext.dtype)
        ident = {"min": ii.max, "max": ii.min}[kind]
    from graphaibench_tpu.ops.lanes import group_reduce

    ident = jnp.asarray(ident, x_ext.dtype)
    out = jnp.full((n_out,), ident, x_ext.dtype)

    def bucket_fn(out, b, pk, xs):
        w = b.width
        for clo, chi in bucket_row_chunks(b, 1):
            rows, nbr, eid = b.slot_slice(clo, chi)
            wb = pk[clo * w:chi * w]
            vb = jnp.where(eid == sentinel, ident,
                           xs[nbr] + wb.astype(x_ext.dtype))
            vb = group_reduce(vb, w, kind)
            if kind == "min":
                out = out.at[rows].min(vb)
            else:
                out = out.at[rows].max(vb)
        return out

    return shard_sweep(buckets, bounds, out, (x_ext,), bucket_fn, packed,
                       groups=groups)


def _ell_apply(buckets, w_pad: jnp.ndarray, x: jnp.ndarray,
               n_out: int, bounds=None, groups=None) -> jnp.ndarray:
    """out[r] += sum_w w_pad[eid] * x[nbr] over every bucket. ``w_pad``
    already carries the sentinel zero slot. Sliced buckets gather from
    their static x slice (column-segmented fast-gather window). At
    scale the gathered operand rounds to bf16 (shared policy of
    ``_shard_gather_dtype``); accumulation stays in the input dtype."""
    from graphaibench_tpu.ops.lanes import group_sum_cols

    base = x.dtype
    x = x.astype(_shard_spmm_gather_dtype(x.shape[0], base))
    f = x.shape[1]
    out = jnp.zeros((n_out, f), base)

    def bucket_fn(out, b, _pk, xs):
        for lo, hi in bucket_row_chunks(b, f):
            rows, nbr, eid = b.slot_slice(lo, hi)
            w = b.width
            contrib = jnp.einsum("rw,rwf->rf",
                                 w_pad[eid].reshape(-1, w),
                                 xs[nbr.reshape(-1, w)])
            out = out.at[rows].add(contrib.astype(base))
        return out

    return shard_sweep(buckets, bounds, out, (x,), bucket_fn,
                       groups=groups)


def _ell_apply_packed(buckets, packed: tuple, x: jnp.ndarray,
                      n_out: int, bounds=None, groups=None) -> jnp.ndarray:
    """out[r] += sum_w packed[i] * x[nbr]: the pre-gathered-weight twin
    of _ell_apply — no per-slot edge-id gather at all. Gathered operand
    rounds to bf16 at scale (same policy as _ell_apply)."""
    from graphaibench_tpu.ops.lanes import group_sum_cols

    base = x.dtype
    x = x.astype(_shard_spmm_gather_dtype(x.shape[0], base))
    f = x.shape[1]
    out = jnp.zeros((n_out, f), base)

    def bucket_fn(out, b, pk, xs):
        w = b.width
        for lo, hi in bucket_row_chunks(b, f):
            rows, nbr, _ = b.slot_slice(lo, hi)
            wb = pk[lo * w:hi * w]                     # flat (rw,)
            contrib = jnp.einsum("rw,rwf->rf", wb.reshape(-1, w),
                                 xs[nbr.reshape(-1, w)])
            out = out.at[rows].add(contrib.astype(base))
        return out

    return shard_sweep(buckets, bounds, out, (x,), bucket_fn, packed,
                       groups=groups)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def slot_spmm_packed(n_out: int, se: ShardEll, wp: ShardPackedW,
                     x: jnp.ndarray) -> jnp.ndarray:
    """Rectangular sharded SpMM on pre-gathered STATIC weights
    (GCN/SAGE aggregation norms — constant over training). Only ``x``
    carries a gradient; the weight cotangent is zero by construction
    (use slot_spmm for runtime-differentiable per-edge values)."""
    return _ell_apply_packed(se.fwd, wp.fwd, x, n_out, se.fwd_bounds,
                             se.fwd_groups)


def _slot_spmm_packed_fwd(n_out, se, wp, x):
    return (_ell_apply_packed(se.fwd, wp.fwd, x, n_out, se.fwd_bounds,
                              se.fwd_groups),
            (se, wp, x))


def _slot_spmm_packed_bwd(n_out, res, ct):
    se, wp, x = res
    dx = _ell_apply_packed(se.trans, wp.t, ct, x.shape[0],
                           se.trans_bounds, se.trans_groups)
    return (_zero_cotangent(se), _zero_cotangent(wp), dx)


slot_spmm_packed.defvjp(_slot_spmm_packed_fwd, _slot_spmm_packed_bwd)


def _slot_sddmm_dot(ct: jnp.ndarray, x: jnp.ndarray, edge_src, col_idx):
    """Per-slot <ct[src], x[col]> (the weight-gradient SDDMM), chunked so
    the materialized gathers stay ~<1 GB."""
    e = edge_src.shape[0]
    f = max(ct.shape[1], 1)
    step = max(1, (1 << 28) // f)
    if e <= step:
        return jnp.einsum("ef,ef->e", ct[edge_src], x[col_idx])
    parts = [
        jnp.einsum("ef,ef->e", ct[edge_src[lo:lo + step]],
                   x[col_idx[lo:lo + step]])
        for lo in range(0, e, step)
    ]
    return jnp.concatenate(parts)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def slot_spmm(n_out: int, se: ShardEll, w: jnp.ndarray, x: jnp.ndarray,
              edge_src: jnp.ndarray, col_idx: jnp.ndarray,
              valid: jnp.ndarray) -> jnp.ndarray:
    """Rectangular sharded SpMM: out[r] = sum over local edges (r -> c)
    of w[slot] * x[c], streaming through the forward ELL buckets.
    Differentiable in ``w`` and ``x``; the x-adjoint streams through the
    transpose buckets instead of autodiff's (e_max,)-scatter."""
    w_pad = jnp.concatenate([w, jnp.zeros((1,), w.dtype)])
    return _ell_apply(se.fwd, w_pad, x, n_out, se.fwd_bounds,
                      se.fwd_groups)


def _slot_spmm_fwd(n_out, se, w, x, edge_src, col_idx, valid):
    return slot_spmm(n_out, se, w, x, edge_src, col_idx, valid), (
        se, w, x, edge_src, col_idx, valid)


def _slot_spmm_bwd(n_out, res, ct):
    se, w, x, edge_src, col_idx, valid = res
    w_pad = jnp.concatenate([w, jnp.zeros((1,), w.dtype)])
    dx = _ell_apply(se.trans, w_pad, ct, x.shape[0], se.trans_bounds,
                    se.trans_groups)
    dw = jnp.where(valid, _slot_sddmm_dot(ct, x, edge_src, col_idx), 0.0)
    return (_zero_cotangent(se), dw, dx, _zero_cotangent(edge_src),
            _zero_cotangent(col_idx), _zero_cotangent(valid))


slot_spmm.defvjp(_slot_spmm_fwd, _slot_spmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def slot_sddmm_add(n_out: int, n_ext: int, se: ShardEll, sa: jnp.ndarray,
                   sb: jnp.ndarray, edge_src: jnp.ndarray,
                   col_idx: jnp.ndarray) -> jnp.ndarray:
    """Per-slot sa[src] + sb[col] (GAT rank-1 logits). The adjoint row
    sums stream through the ELL buckets (fwd for sa, transpose for sb)
    instead of (e_max,)-sized segment scatters."""
    return sa[edge_src] + sb[col_idx]


def _slot_sddmm_add_fwd(n_out, n_ext, se, sa, sb, edge_src, col_idx):
    return sa[edge_src] + sb[col_idx], (se, edge_src, col_idx)


def _slot_sddmm_add_bwd(n_out, n_ext, res, ct):
    se, edge_src, col_idx = res
    dsa = ell_row_reduce(se.fwd, ct, n_out, "sum")
    dsb = ell_row_reduce(se.trans, ct, n_ext, "sum")
    return (_zero_cotangent(se), dsa, dsb, _zero_cotangent(edge_src),
            _zero_cotangent(col_idx))


slot_sddmm_add.defvjp(_slot_sddmm_add_fwd, _slot_sddmm_add_bwd)


def _norm_consts_local(se: ShardEll, logits, n_out):
    m = ell_row_reduce(se.fwd, logits, n_out, "max")
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    from graphaibench_tpu.ops.lanes import group_reduce

    l_pad = jnp.concatenate([logits, jnp.full((1,), -jnp.inf, logits.dtype)])
    denom = jnp.zeros((n_out,), logits.dtype)
    for b in se.fwd:
        rows = b.row_ids.reshape(-1)   # slot-space: flatten any seg axis
        lb = l_pad[b.edge_id.reshape(-1)].reshape(-1, b.width)
        eb = jnp.exp(lb - m[rows][:, None]).reshape(-1)
        denom = denom.at[rows].add(group_reduce(eb, b.width, "sum"))
    # NORMAL f32 floor: 1e-38 is subnormal and flushes to zero under XLA,
    # making z=inf on edgeless rows
    z = 1.0 / jnp.maximum(denom, 1e-30)
    return m, z


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def gat_fused_local(n_out: int, se: ShardEll, logits: jnp.ndarray,
                    x: jnp.ndarray, edge_src: jnp.ndarray,
                    col_idx: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Fused per-shard GAT: out = A(softmax_row(logits)) @ x over the
    rectangular local graph, the sharded twin of ops.fused_gat. Edge
    validity is structural (padded slots never appear in the buckets),
    so no separate mask weight is needed on the forward path."""
    m, z = _norm_consts_local(se, logits, n_out)
    return _gat_fwd_pass(se, logits, x, m, z, n_out)


def _gat_fwd_pass(se, logits, x, m, z, n_out):
    from graphaibench_tpu.ops.lanes import group_sum_cols

    l_pad = jnp.concatenate([logits, jnp.full((1,), -jnp.inf, logits.dtype)])
    out = jnp.zeros((n_out, x.shape[1]), x.dtype)
    for b, sl in _iter_shard(se.fwd, se.fwd_bounds, se.fwd_groups):
        xs = x if sl is None else x[sl[0]:sl[1]]
        for lo, hi in bucket_row_chunks(b, x.shape[1]):
            rows, nbr, eid = b.slot_slice(lo, hi)
            lb = l_pad[eid].reshape(-1, b.width)
            sb = jnp.exp(lb - m[rows][:, None]) * z[rows][:, None]
            prod = xs[nbr] * sb.reshape(-1)[:, None]
            out = out.at[rows].add(group_sum_cols(prod, b.width))
    return out


def _gat_fused_fwd(n_out, se, logits, x, edge_src, col_idx, valid):
    m, z = _norm_consts_local(se, logits, n_out)
    y = _gat_fwd_pass(se, logits, x, m, z, n_out)
    return y, (se, logits, x, edge_src, col_idx, valid, m, z)


def _gat_fused_bwd(n_out, res, ct):
    se, logits, x, edge_src, col_idx, valid, m, z = res
    # materialize softmax scores once (one packed (n, 2) row gather)
    mz = jnp.stack([m, z], axis=1)[edge_src]          # (e_max, 2)
    s_soft = jnp.exp(logits - mz[:, 0]) * mz[:, 1]
    s_soft = jnp.where(valid, s_soft, 0.0)            # kill garbage slots
    s_pad = jnp.concatenate([s_soft, jnp.zeros((1,), s_soft.dtype)])
    # dx: adjoint aggregation through the transpose buckets
    dx = _ell_apply(se.trans, s_pad, ct, x.shape[0], se.trans_bounds,
                    se.trans_groups)
    # softmax adjoint: dl = s * (raw - rowsum(s * raw))
    raw = _slot_sddmm_dot(ct, x, edge_src, col_idx)
    inner = ell_row_reduce(se.fwd, s_soft * raw, n_out, "sum")
    dl = s_soft * (raw - inner[edge_src])
    return (_zero_cotangent(se), dl, dx, _zero_cotangent(edge_src),
            _zero_cotangent(col_idx), _zero_cotangent(valid))


gat_fused_local.defvjp(_gat_fused_fwd, _gat_fused_bwd)


# ---------------------------------------------------------------------------
# v2 sharded GAT: logits computed inside the bucket passes (the sharded
# twin of ops.fused_gat.gat_attention_spmm_v2). No slot-space array is
# ever gathered: sr rides as a packed column of the aggregation gather,
# z accumulates as an extra output column, the exact row max comes from
# leaky_relu's monotonicity, and the softmax-adjoint inner term is
# <ct, out> elementwise. Rectangular local graphs use the explicit
# transpose layout where the single-chip op reuses symmetric buckets.
# ---------------------------------------------------------------------------


# column chunking, gathered-operand dtype, and the tighter large-graph
# stage cap are SHARED with the single-chip op so the sharded kernels
# can never silently diverge from it
from graphaibench_tpu.ops.fused_gat import (  # noqa: E402
    _col_chunks as _col_chunks_local,
    _gather3,
    _V2_STAGE_ELEMS as _V2_STAGE_ELEMS_LOCAL,
)


def _shard_gather_dtype(n_gather_rows: int, base):
    """bf16 gathered operands at scale for the fused GAT v2 locals,
    same policy and threshold as ops.fused_gat._v2_gather_dtype."""
    from graphaibench_tpu.ops import fused_gat as _fg

    if (_fg.V2_GATHER_BF16 and n_gather_rows >= _fg._v2_bf16_min_nv()
            and base == jnp.float32):
        return jnp.bfloat16
    return base


def _shard_spmm_gather_dtype(n_gather_rows: int, base):
    """The SpMM twins follow ops.spmm's policy instead: f32;
    GAB_SPMM_BF16=1 re-enables bf16."""
    import os

    from graphaibench_tpu.ops.device_graph import SEG_ELL_MIN_NV

    env = os.environ.get("GAB_SPMM_BF16", "").strip().lower()
    if (env in ("1", "true", "on", "yes")
            and n_gather_rows >= SEG_ELL_MIN_NV and base == jnp.float32):
        return jnp.bfloat16
    return base


def _shard_stage_cap(n_gather_rows: int):
    from graphaibench_tpu.ops.device_graph import SEG_ELL_MIN_NV

    return _V2_STAGE_ELEMS_LOCAL if n_gather_rows >= SEG_ELL_MIN_NV else None


def _sr_rowmax_local(se: ShardEll, sr_ext, n_out, sent):
    """Exact per-local-row max of the neighbor-side attention scalar
    (2-col packed table: scalar gathers run at half the row rate)."""
    from graphaibench_tpu.ops.lanes import group_reduce

    sr2 = jnp.stack([sr_ext, sr_ext], axis=1)
    out = jnp.full((n_out,), -jnp.inf, sr_ext.dtype)
    for b, sl_ in _iter_shard(se.fwd, se.fwd_bounds,
                              se.fwd_groups):
        tb = sr2 if sl_ is None else sr2[sl_[0]:sl_[1]]
        # chunked: on tiled device memory the (slots, 2) gather output
        # pads its minor dim to 128 lanes (64x)
        for clo, chi in bucket_row_chunks(b, 2):
            rows, nbr, eid = b.slot_slice(clo, chi)
            vb = jnp.where(eid == sent, -jnp.inf, tb[nbr][:, 0])
            out = out.at[rows].max(group_reduce(vb, b.width, "max"))
    return out


def _gat_v2_fwd_local(se, sl, sr_ext, h_ext, m, n_out, sent):
    from graphaibench_tpu.ops.spmm import bucket_row_chunks

    f = h_ext.shape[1]
    gdt = _shard_gather_dtype(h_ext.shape[0], h_ext.dtype)
    cap = _shard_stage_cap(h_ext.shape[0])
    xa = jnp.concatenate([sr_ext[:, None], h_ext],
                         axis=1).astype(gdt)                 # (nv_ext, 1+F)
    chunks = _col_chunks_local(f + 1, jnp.dtype(gdt).itemsize)
    acc = jnp.zeros((n_out, f + 1), h_ext.dtype)
    for b, sl_ in _iter_shard(se.fwd, se.fwd_bounds,
                              se.fwd_groups):
        xs = xa if sl_ is None else xa[sl_[0]:sl_[1]]
        for clo, chi in bucket_row_chunks(b, f + 1, cap):
            rows, nbr, eid = b.slot_slice(clo, chi)
            eid = eid.reshape(-1, b.width)
            acc, nbr = _seq_local(acc, nbr, h_ext.shape[0])
            gs = [_gather3(xs[:, c0:c1], nbr, b.width)
                  for c0, c1 in chunks]
            raw = sl[rows][:, None] + gs[0][..., 0]
            l = jnp.where(raw > 0, raw, 0.2 * raw)
            eb = jnp.exp(l - m[rows][:, None])
            eb = jnp.where(eid == sent, 0.0, eb)
            from graphaibench_tpu.ops.fused_gat import _wsum

            parts = [_wsum(eb, gs[0][..., 1:])]
            parts += [_wsum(eb, ga) for ga in gs[1:]]
            parts.append(eb.sum(axis=1)[:, None])
            acc = acc.at[rows].add(jnp.concatenate(parts, axis=1))
    z = acc[:, f]
    zinv = 1.0 / jnp.maximum(z, 1e-30)    # NORMAL f32 floor (not 1e-38)
    return acc[:, :f] * zinv[:, None], zinv


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def gat_fused_local_v2(n_out: int, se: ShardEll, sl: jnp.ndarray,
                       sr_ext: jnp.ndarray, h_ext: jnp.ndarray) -> jnp.ndarray:
    """Sharded fused GAT, logits never materialized. sl: (nv_pad,)
    row-side scalars; sr_ext/h_ext: (nv_pad + h_max, ...) extended-local
    neighbor-side values. Differentiable in all three."""
    sent = se.sentinel
    m0 = _sr_rowmax_local(se, sr_ext, n_out, sent)
    m = jnp.where(jnp.isfinite(m0), m0, 0.0)
    raw = sl + m
    m = jnp.where(raw > 0, raw, 0.2 * raw)   # exact row max of the logits
    out, _ = _gat_v2_fwd_local(se, sl, sr_ext, h_ext, m, n_out, sent)
    return out


def _gat_v2_bwd_local(n_out, res, ct):
    from graphaibench_tpu.ops.spmm import bucket_row_chunks

    se, sl, sr_ext, h_ext, m, zinv, out, sent = res
    f = h_ext.shape[1]
    inner = jnp.sum(ct * out, axis=1)          # softmax-adjoint row term

    # B1 (fwd layout): d_sl
    gdt = _shard_gather_dtype(h_ext.shape[0], h_ext.dtype)
    cap = _shard_stage_cap(h_ext.shape[0])
    xa = jnp.concatenate([sr_ext[:, None], h_ext], axis=1).astype(gdt)
    chunks1 = _col_chunks_local(f + 1, jnp.dtype(gdt).itemsize)
    dsl = jnp.zeros((n_out,), sl.dtype)
    for b, sl_ in _iter_shard(se.fwd, se.fwd_bounds,
                              se.fwd_groups):
        xs = xa if sl_ is None else xa[sl_[0]:sl_[1]]
        for clo, chi in bucket_row_chunks(b, f + 1, cap):
            rows, nbr, eid = b.slot_slice(clo, chi)
            eid = eid.reshape(-1, b.width)
            dsl, nbr = _seq_local(dsl, nbr, h_ext.shape[0])
            gs = [_gather3(xs[:, c0:c1], nbr, b.width)
                  for c0, c1 in chunks1]
            raw = sl[rows][:, None] + gs[0][..., 0]
            l = jnp.where(raw > 0, raw, 0.2 * raw)
            p = jnp.exp(l - m[rows][:, None]) * zinv[rows][:, None]
            p = jnp.where(eid == sent, 0.0, p)
            ctr = ct[rows]
            from graphaibench_tpu.ops.fused_gat import _dotw

            dsw = _dotw(ctr[:, chunks1[0][0]:chunks1[0][1] - 1],
                        gs[0][..., 1:])
            for (c0, c1), ga in zip(chunks1[1:], gs[1:]):
                dsw = dsw + _dotw(ctr[:, c0 - 1:c1 - 1], ga)
            dlraw = p * (dsw - inner[rows][:, None])
            dlraw = dlraw * jnp.where(raw > 0, 1.0, 0.2)
            dsl = dsl.at[rows].add(dlraw.sum(axis=1))

    # B2 (transpose layout): rows j = ext-local cols, nbr i = local rows
    tb = jnp.concatenate(
        [sl[:, None], m[:, None], zinv[:, None], inner[:, None], ct],
        axis=1).astype(gdt)
    chunks2 = _col_chunks_local(f + 4, jnp.dtype(gdt).itemsize)
    nv_ext = h_ext.shape[0]
    dh = jnp.zeros((nv_ext, f), h_ext.dtype)
    dsr = jnp.zeros((nv_ext,), sr_ext.dtype)
    for b, sl_ in _iter_shard(se.trans, se.trans_bounds,
                              se.trans_groups):
        ts = tb if sl_ is None else tb[sl_[0]:sl_[1]]
        for clo, chi in bucket_row_chunks(b, f + 4, cap):
            rows, nbr, eid = b.slot_slice(clo, chi)
            eid = eid.reshape(-1, b.width)
            dh, nbr = _seq_local(dh, nbr, h_ext.shape[0])
            gs = [_gather3(ts[:, c0:c1], nbr, b.width)
                  for c0, c1 in chunks2]
            raw = gs[0][..., 0] + sr_ext[rows][:, None]      # sl_i + sr_j
            l = jnp.where(raw > 0, raw, 0.2 * raw)
            p = jnp.exp(l - gs[0][..., 1]) * gs[0][..., 2]
            p = jnp.where(eid == sent, 0.0, p)
            hr = h_ext[rows]
            from graphaibench_tpu.ops.fused_gat import _dotw, _wsum

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

    return (_zero_cotangent(se), dsl, dsr, dh)


def _gat_v2_fwd_res(n_out, se, sl, sr_ext, h_ext):
    sent = se.sentinel
    m0 = _sr_rowmax_local(se, sr_ext, n_out, sent)
    m = jnp.where(jnp.isfinite(m0), m0, 0.0)
    raw = sl + m
    m = jnp.where(raw > 0, raw, 0.2 * raw)
    out, zinv = _gat_v2_fwd_local(se, sl, sr_ext, h_ext, m, n_out, sent)
    return out, (se, sl, sr_ext, h_ext, m, zinv, out, sent)


gat_fused_local_v2.defvjp(_gat_v2_fwd_res, _gat_v2_bwd_local)
