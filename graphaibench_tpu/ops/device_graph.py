"""Device-resident graph representation for the sparse ops.

Replaces the reference's GPU graph mirrors (``LearningGraph`` device
pointers, lgraph.cu:56-118, and ``GraphGPU``, include/graph_gpu.h) with a
JAX pytree holding several *layouts* of the same adjacency, each tuned to
a different execution strategy:

  * COO (edge_src / col_idx, CSR-ordered) — for XLA gather + segment_sum
    and for per-edge ops (SDDMM, segment softmax).
  * Degree-bucketed ELL — rows grouped by pow2 degree up to width 64,
    heavier rows split into 64-wide virtual-row chunks (scatter-add
    accumulated), neighbor ids padded to the bucket width. The SpMM over
    a bucket is a dense gather + weighted reduction XLA fuses into a
    streaming kernel; this replaces the reference's warp/CTA
    load-balancing tricks (include/gnn/graph_operations.h:85-178).
  * Optional dense adjacency — for small graphs the N x N normalized
    adjacency lives on the device and aggregation is a single matmul.

The transpose permutation (built once on host) replaces the reference's
per-step cuSPARSE csr2csc in the GAT adjoint (gat_aggregator.cu:88-92).

All index arrays are int32: graphs are sharded so per-shard edge counts
fit in 32 bits.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.graph import transforms as T


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class EllBucket:
    """Rows of (padded) degree exactly ``width``; padding slots carry
    edge_id == ne (one past the end) so runtime per-edge values gather a
    zero from a sentinel slot.

    Slot arrays are FLAT (..., R*W) — row r's slots are the consecutive
    run [r*W, (r+1)*W). A (R, W) matrix with W in {4..64} would pad its
    minor dim to 128 lanes on tiled device memory (up to 32x the logical
    bytes), so the 2-D view exists only transiently inside kernels
    (``ops.lanes``). The optional leading axes carry the
    sharded trainer's stacked [P] dimension."""

    row_ids: jnp.ndarray   # (..., R) int32
    nbr: jnp.ndarray       # (..., R*W) int32, padded with 0
    edge_id: jnp.ndarray   # (..., R*W) int32, padded with ne (sentinel)
    width: int             # static

    def tree_flatten(self):
        return (self.row_ids, self.nbr, self.edge_id), (self.width,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, width=aux[0])

    @property
    def rows(self) -> int:
        """Row count R (the last row_ids axis)."""
        return self.row_ids.shape[-1]

    def slot_slice(self, lo: int, hi: int):
        """(row_ids, nbr, edge_id) restricted to rows [lo, hi) — flat
        slot arrays sliced on slot boundaries. edge_id may be None
        (dropped from packed-weight layouts, which never gather by edge
        id — ~1.3 GB of dead device memory at products scale)."""
        if (lo, hi) == (0, self.rows):
            return self.row_ids, self.nbr, self.edge_id
        w = self.width
        eid = (None if self.edge_id is None
               else self.edge_id[lo * w:hi * w])
        return self.row_ids[lo:hi], self.nbr[lo * w:hi * w], eid

    def nbr2(self) -> jnp.ndarray:
        """(..., R, W) view of the neighbor ids (padded transient —
        cold paths only)."""
        return self.nbr.reshape(self.nbr.shape[:-1] + (self.rows,
                                                       self.width))

    def eid2(self) -> jnp.ndarray:
        """(..., R, W) view of the edge ids (padded transient — cold
        paths only)."""
        return self.edge_id.reshape(self.edge_id.shape[:-1] + (self.rows,
                                                               self.width))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SegmentedEll:
    """Column-segmented ELL: per column range [lo, hi) of the x table,
    the edges whose neighbor falls in that range, as ELL buckets with
    locally reindexed neighbor ids. The reference's CSR segmenting
    ("making caches work for graph analytics", graph_partition.cc:184)
    mapped to row gathers: gathers stay inside a <=64 MB slice of x,
    which on the chip this was tuned on gathered ~5x faster than the
    whole table on million-vertex graphs (not yet measured on the H100;
    ROADMAP design item 3).

    STACKED layout: one EllBucket per width whose arrays carry a
    leading segment axis [S] — row_ids (S, R_w), nbr/edge_id
    (S, R_w*w) — padded to uniform shapes across segments (padding rows:
    row 0, nbr 0, edge_id = the global sentinel, so they gather weight
    zero). Uniform shapes let a ``lax.scan`` body consume one segment
    per step, shrinking program size from O(S * buckets) gather stages
    to O(buckets).

    ``bounds`` are EQUAL-EDGE column ranges (width-capped), not equal
    vertex ranges: power-law graphs concentrate edges in the low-id
    columns, so equal-vertex segments gave per-width row counts varying
    ~10x across segments and max-padding blew the stacked slots to 3.2x
    ne at rmat20 — vs ~1.2x with balanced edges.
    The scan body handles the varying range widths with one
    dynamic-slice x window of ``window`` rows per step.

    GROUPED stacking: even under equal-edge bounds the per-(width,
    segment) row counts still vary enough that padding every width to
    its max-over-segments cost 1.79x ne slots at rmat20. ``buckets[i]``
    is therefore one width's ROW-COUNT-SORTED GROUP of segments
    (possibly several buckets per width), stacked over ``group_segs[i]``
    (the static segment ids, aligned leading axis) and padded only to
    the group max; empty (width, segment) pairs vanish
    entirely. The sweep scans each group (``sweep_grouped``), so program
    size stays O(widths x groups)."""

    bounds: tuple                  # static ((lo, hi), ...) column ranges
    nv: int                        # static gather-table rows
    buckets: tuple                 # tuple[EllBucket, ...], leading [Sg]
    group_segs: tuple = None       # static tuple[tuple[int, ...], ...]

    def tree_flatten(self):
        return (self.buckets,), (self.bounds, self.nv, self.group_segs)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(bounds=aux[0], nv=aux[1], buckets=children[0],
                   group_segs=aux[2])

    @property
    def nseg(self) -> int:
        return len(self.bounds)

    @property
    def window(self) -> int:
        """Static scan-mode gather-window rows (max range width)."""
        return max((hi - lo for lo, hi in self.bounds), default=1)

    @property
    def segs(self) -> tuple:
        """Per-segment bucket views (leading-axis slices — XLA slices at
        trace time, no copies) for unrolled consumers. With grouped
        stacking a segment's buckets are scattered across groups; views
        are reassembled in bucket order (padding-only group rows were
        never materialized, so absent (width, segment) pairs are simply
        missing from that segment's tuple)."""
        def _eid(e, k):
            return None if e is None else e[k]

        if self.group_segs is None:
            return tuple(
                tuple(EllBucket(row_ids=b.row_ids[s], nbr=b.nbr[s],
                                edge_id=_eid(b.edge_id, s), width=b.width)
                      for b in self.buckets)
                for s in range(self.nseg))
        per_seg: list = [[] for _ in range(self.nseg)]
        for segs_ids, b in zip(self.group_segs, self.buckets):
            for j, s in enumerate(segs_ids):
                per_seg[s].append(
                    EllBucket(row_ids=b.row_ids[j], nbr=b.nbr[j],
                              edge_id=_eid(b.edge_id, j), width=b.width))
        return tuple(tuple(bl) for bl in per_seg)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Static-topology device graph. Edge weights are supplied separately
    at call sites so one topology serves GCN norms, SAGE means, and GAT
    attention scores alike."""

    row_ptr: jnp.ndarray           # (N+1,) int32
    col_idx: jnp.ndarray           # (E,) int32  — CSR destination ids
    edge_src: jnp.ndarray          # (E,) int32  — CSR-ordered source ids
    deg: jnp.ndarray               # (N,) int32
    # host-precomputed transpose: edge k of G^T corresponds to edge
    # trans_perm[k] of G (see transforms.transpose_edge_permutation)
    trans_perm: Optional[jnp.ndarray]  # (E,) int32 or None
    ell: tuple                     # tuple[EllBucket, ...] (possibly empty)
    nv: int                        # static
    ne: int                        # static
    seg_ell: Optional[SegmentedEll] = None  # large-graph layout

    def tree_flatten(self):
        children = (self.row_ptr, self.col_idx, self.edge_src, self.deg,
                    self.trans_perm, self.ell, self.seg_ell)
        return children, (self.nv, self.ne)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:6], nv=aux[0], ne=aux[1], seg_ell=children[6])

    @property
    def has_transpose(self) -> bool:
        return self.trans_perm is not None

    @property
    def has_ell_layout(self) -> bool:
        """True when a bucketed layout exists (plain ELL or column-
        segmented) — the gate for every streaming bucket-pass op. At
        scale the device graph carries ONLY the segmented layout."""
        return bool(self.ell) or self.seg_ell is not None


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PackedEdgeW:
    """Per-bucket pre-gathered edge values for STATIC edge weights
    (GCN norms, SAGE means, GGNN ones — constant for a whole training
    run).

    Why: at million-vertex scale the runtime ``w_pad[edge_id]`` lookup
    is a SCALAR gather over a >=128 MB window, which on the chip this
    was tuned on cost ~3x the feature gather it feeds (not yet measured
    on the H100). Pre-gathering once per graph leaves every SpMM only
    the feature gather. The reference's PRECOMPUTE_SCORES/MKL-csrmm path
    (gcn_aggregator.cpp:27-28) makes the same static-weight assumption.

    ``fwd[i]`` == w_pad[bucket_i.edge_id] for the i-th bucket in
    ``layout_buckets`` order ([S]-stacked on segmented graphs, flat on
    plain ELL); ``t`` is the same layout for the
    transpose-permuted weights (the SpMM adjoint), or None.
    ``raw`` keeps the (ne,) array for non-ELL consumers (dense/COO
    fallbacks, parity tests)."""

    raw: jnp.ndarray
    fwd: tuple
    t: Optional[tuple]

    def tree_flatten(self):
        return (self.raw, self.fwd, self.t), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@functools.partial(jax.jit, static_argnames=("with_t",))
def _pack_gathers(w, trans_perm, eids, with_t: bool):
    """All pack gathers in ONE jitted program, not ~10 separate eager
    ops each compiled on its own."""
    zero = jnp.zeros((1,), w.dtype)
    w_pad = jnp.concatenate([w, zero])
    fwd = jax.tree.map(lambda e: w_pad[e], eids)
    t = None
    if with_t:
        wt_pad = jnp.concatenate([w[trans_perm], zero])
        t = jax.tree.map(lambda e: wt_pad[e], eids)
    return fwd, t


def pack_edge_values(g: DeviceGraph, w: jnp.ndarray,
                     *, with_transpose: bool = True) -> PackedEdgeW:
    """One-time per-bucket pre-gather of static per-edge values (device
    gathers; ~one slow pass — amortized over every subsequent SpMM).
    Aligned with ``layout_buckets``: stacked (S, R*w) per width on
    segmented graphs, flat (R*w,) on plain ELL."""
    w = jnp.asarray(w)
    eids = tuple(b.edge_id for b in layout_buckets(g))
    with_t = bool(with_transpose and g.has_transpose)
    trans = g.trans_perm if with_t else jnp.zeros((1,), jnp.int32)
    fwd, t = _pack_gathers(w, trans, eids, with_t)
    return PackedEdgeW(raw=w, fwd=fwd, t=t)


def layout_buckets(g: DeviceGraph) -> tuple:
    """The STORED bucket tuple of the active layout: [S]-stacked
    buckets on segmented graphs, plain flat buckets otherwise. This is
    the alignment order of every packed per-bucket value tuple
    (pack_edge_values, segment.pack_neighbor_edge_vals)."""
    return g.seg_ell.buckets if g.seg_ell is not None else g.ell


def iter_layout(g: DeviceGraph, packed=None):
    """Yield (bucket_view, (lo, hi), packed_slice) for the unrolled
    consumption order (group-major on segmented graphs). ``packed``
    is a per-bucket tuple aligned with ``layout_buckets``; its yielded
    slice matches the bucket view ([j] leading-axis slice on segmented
    graphs), or None when no packed values were passed."""
    if g.seg_ell is not None:
        ss = g.seg_ell
        if ss.group_segs is not None:
            for gi, (segs_ids, b) in enumerate(zip(ss.group_segs,
                                                   ss.buckets)):
                for j, s in enumerate(segs_ids):
                    eid = None if b.edge_id is None else b.edge_id[j]
                    bv = EllBucket(row_ids=b.row_ids[j], nbr=b.nbr[j],
                                   edge_id=eid, width=b.width)
                    yield bv, ss.bounds[s], (
                        None if packed is None else packed[gi][j])
            return
        for s, bounds in enumerate(ss.bounds):
            for i, b in enumerate(ss.buckets):
                eid = None if b.edge_id is None else b.edge_id[s]
                bv = EllBucket(row_ids=b.row_ids[s], nbr=b.nbr[s],
                               edge_id=eid, width=b.width)
                yield bv, bounds, (None if packed is None else packed[i][s])
    else:
        for i, b in enumerate(g.ell):
            yield b, (0, g.nv), (None if packed is None else packed[i])


def iter_buckets_sliced(g: DeviceGraph):
    """Yield (bucket, (lo, hi)) with the gather-table slice bounds the
    bucket's neighbor ids index into; plain ELL yields the whole-table
    range, the column-segmented layout its per-segment slices."""
    for b, bounds, _ in iter_layout(g):
        yield b, bounds


# lax.scan over segments when the segmented layout has at least this
# many segments: the unrolled program grows O(S * buckets) gather
# stages, while the scanned body compiles once (6.6x smaller StableHLO
# at S=8). GAB_SEG_SCAN=0 forces unrolled (ablations).
_SEG_SCAN_MIN = 2


def use_seg_scan(g: DeviceGraph) -> bool:
    if g.seg_ell is None or g.seg_ell.nseg < _SEG_SCAN_MIN:
        return False
    env = os.environ.get("GAB_SEG_SCAN", "").strip().lower()
    return env not in ("0", "false", "off", "no")


def sweep_stacked(bounds: tuple, buckets: tuple, carry, tables: tuple,
                  bucket_fn, packed=None):
    """lax.scan over [S]-stacked width-buckets: one compiled body
    consumes one column segment per step (a smaller program, and far
    friendlier to XLA buffer reuse than O(S * buckets) unrolled
    stages). Each step's gather tables are one ``window``-row
    dynamic slice — the equal-edge ranges have varying widths; local
    neighbor ids stay below each range's true width, so the tail of a
    wider window is simply never indexed."""
    win = max((hi - lo for lo, hi in bounds), default=1)
    rows_needed = max((lo for lo, _ in bounds), default=0) + win
    los = jnp.asarray(np.asarray([lo for lo, _ in bounds], np.int32))

    def pad_tab(t):
        pad = rows_needed - t.shape[0]
        if pad <= 0:
            return t
        return jnp.pad(t, ((0, pad),) + ((0, 0),) * (t.ndim - 1))

    tabs = tuple(pad_tab(t) for t in tables)

    def body(c, ins):
        lo_s, bks, pks = ins
        ts = tuple(jax.lax.dynamic_slice_in_dim(t, lo_s, win, axis=0)
                   for t in tabs)
        for i, b in enumerate(bks):
            c = bucket_fn(c, b, None if pks is None else pks[i], *ts)
        return c, None

    carry, _ = jax.lax.scan(body, carry, (los, buckets, packed))
    return carry


def sweep_grouped(ss: "SegmentedEll", carry, tables: tuple, bucket_fn,
                  packed=None, scan: bool = True):
    """Sweep a GROUP-stacked segmented layout: one lax.scan per (width,
    group) over its row-count-sorted segments — same O(widths x groups)
    program size as the uniform scan, with padding only to each group's
    max rows (1.79x -> ~1.1x ne slots at rmat20). Groups of one segment
    run inline (no scan machinery). ``scan=False`` unrolls every
    segment (the GAB_SEG_SCAN=0 ablation path)."""
    bounds = ss.bounds
    # each group's dynamic slices read [lo, lo + win_g); jax clamps
    # out-of-range starts (shifting the window base silently), so the
    # tables must be padded to the worst group's reach
    rows_needed = max((hi for _, hi in bounds), default=1)
    for segs_ids in ss.group_segs:
        if len(segs_ids) > 1 and scan:
            win_g = max(bounds[s][1] - bounds[s][0] for s in segs_ids)
            reach = max(bounds[s][0] for s in segs_ids) + win_g
            rows_needed = max(rows_needed, reach)

    def pad_tab(t):
        pad = rows_needed - t.shape[0]
        if pad <= 0:
            return t
        return jnp.pad(t, ((0, pad),) + ((0, 0),) * (t.ndim - 1))

    tabs = tuple(pad_tab(t) for t in tables)
    for gi, (segs_ids, b) in enumerate(zip(ss.group_segs, ss.buckets)):
        pk = None if packed is None else packed[gi]
        if len(segs_ids) == 1 or not scan:
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
        los = jnp.asarray(np.asarray([bounds[s][0] for s in segs_ids],
                                     np.int32))

        def body(c, ins, win=win):
            lo_s, bk, pkk = ins
            ts = tuple(jax.lax.dynamic_slice_in_dim(t, lo_s, win, axis=0)
                       for t in tabs)
            return bucket_fn(c, bk, pkk, *ts), None

        carry, _ = jax.lax.scan(body, carry, (los, b, pk))
    return carry


def seg_sweep(g: DeviceGraph, carry, tables: tuple, bucket_fn,
              packed=None):
    """Run ``bucket_fn(carry, bucket, packed_slice, *table_slices)``
    over every (segment, width-bucket) pair of the active layout and
    return the final carry.

    ``tables`` are (n_gather_rows, C) arrays the bucket body gathers
    from by neighbor id: on segmented graphs each is sliced to the
    segment's column range (the <=64 MB fast-gather window); per-ROW
    tables indexed by ``bucket.row_ids`` must be closed over instead
    (row ids are global in every layout). ``packed`` is a per-width
    tuple aligned with ``layout_buckets``.

    At scale the sweep is a ``lax.scan`` per stacked group
    (sweep_grouped; sweep_stacked for legacy uniform stacks); otherwise
    the trace-time unrolled loop."""
    ss = g.seg_ell
    if ss is not None and ss.group_segs is not None:
        return sweep_grouped(ss, carry, tables, bucket_fn, packed,
                             scan=use_seg_scan(g))
    if use_seg_scan(g):
        return sweep_stacked(ss.bounds, ss.buckets, carry, tables,
                             bucket_fn, packed)
    for b, (lo, hi), pk in iter_layout(g, packed):
        whole = (lo, hi) == (0, tables[0].shape[0]) if tables else True
        ts = tuple(t if whole else t[lo:hi] for t in tables)
        carry = bucket_fn(carry, b, pk, *ts)
    return carry


def all_buckets(g: DeviceGraph) -> tuple:
    """Every ELL bucket of ``g`` regardless of layout. Row reductions
    (per-edge values -> per-row scalars) are oblivious to column
    segmentation, so seg-ELL-only graphs (the sharded trainer's local
    graphs at large scale) reduce over the flattened segment buckets."""
    if g.ell:
        return g.ell
    if g.seg_ell is not None:
        return tuple(b for seg in g.seg_ell.segs for b in seg)
    return ()


# Width grid + heavy-row splitting, chosen on another chip with a
# chained SpMM benchmark at rmat17/F=128 among grids from {1..512} to
# {4..32}; not yet measured on the H100. Per-bucket fixed cost (gather,
# einsum, scatter) favours FEWER buckets as long as padding stays
# ~<1.25x; splitting every row wider than 64 into 64-wide virtual rows
# bounds padding without adding buckets.
_WIDTH_GRID = (4, 8, 16, 32, 64)
ELL_SPLIT = 64


def _virtual_rows(targets, counts, starts, split):
    """Split (target, start, count) row descriptors into <=split-wide
    virtual rows. Returns (vr_target, vr_start, vr_len)."""
    counts = counts.astype(np.int64)
    nchunks = np.maximum((counts + split - 1) // split, 1)
    vt = np.repeat(targets, nchunks)
    vstart = np.repeat(starts.astype(np.int64), nchunks)
    first = np.repeat(np.cumsum(nchunks) - nchunks, nchunks)
    k = np.arange(len(vt), dtype=np.int64) - first
    vs = vstart + k * split
    vl = np.minimum(np.repeat(counts, nchunks) - k * split, split)
    keep = vl > 0
    return vt[keep], vs[keep], vl[keep]


def _pack_buckets(vr_t, vr_s, vr_l, col, edge_ids, ne, widths,
                  as_numpy: bool = False):
    """Width-bucket virtual rows and pack padded (R, W) matrices.
    ``col[pos]`` supplies neighbor ids, ``edge_ids[pos]`` global edge
    ids (None means identity). ``as_numpy`` keeps arrays on host (for
    shard builders that stack + device_put with explicit shardings)."""
    buckets: list[EllBucket] = []
    conv = (lambda a: a) if as_numpy else jnp.asarray
    for wi, w in enumerate(widths):
        lo = widths[wi - 1] if wi > 0 else 0
        sel = (vr_l > lo) & (vr_l <= w)
        if not sel.any():
            continue
        rows, starts, lens = vr_t[sel], vr_s[sel], vr_l[sel]
        offs = np.arange(w, dtype=np.int64)[None, :]         # (1, w)
        in_row = offs < lens[:, None]
        pos_c = np.where(in_row, starts[:, None] + offs, 0)
        nbr = np.where(in_row, col[pos_c], 0).astype(np.int32)
        raw_eid = pos_c if edge_ids is None else edge_ids[pos_c]
        eid = np.where(in_row, raw_eid, ne).astype(np.int32)
        buckets.append(
            EllBucket(row_ids=conv(rows.astype(np.int32)),
                      nbr=conv(nbr.reshape(-1)),
                      edge_id=conv(eid.reshape(-1)),
                      width=w))
    return buckets


def _widths_for_split(split: int) -> list[int]:
    return ([w for w in _WIDTH_GRID if w < split] + [split]
            if split >= _WIDTH_GRID[0] else [split])


def _pack_rows(targets, starts, counts, col, eid, sentinel, widths, split,
               as_numpy: bool = False):
    """Pack grouped rows (row r: ``counts[r]`` entries at
    ``starts[r]``) into ELL buckets — one native pass when the
    toolchain is available (~6x over the numpy virtual-row path at
    rmat20), bit-identical numpy fallback otherwise."""
    from graphaibench_tpu import native

    res = native.ell_pack(targets, starts, counts, col, eid, sentinel,
                          widths, split)
    conv = (lambda a: a) if as_numpy else jnp.asarray
    if res is not None:
        return [EllBucket(row_ids=conv(r), nbr=conv(n), edge_id=conv(e),
                          width=w)
                for (w, r, n, e) in res]
    vr_t, vr_s, vr_l = _virtual_rows(np.asarray(targets, np.int32),
                                     np.asarray(counts),
                                     np.asarray(starts), split)
    return _pack_buckets(vr_t, vr_s, vr_l, col, eid, sentinel, widths,
                         as_numpy=as_numpy)


def ell_from_coo(rows: np.ndarray, cols: np.ndarray, eids: np.ndarray,
                 sentinel: int, split: Optional[int] = None,
                 as_numpy: bool = False) -> list[EllBucket]:
    """Pack an arbitrary COO edge list into degree-bucketed ELL with
    heavy-row splitting. ``rows`` need not be sorted (stable-sorted
    here, preserving CSR order within a row); ``eids[k]`` is the index
    into the per-edge value array the consumer will gather from, with
    ``sentinel`` marking the zero padding slot. Used by the sharded
    trainer to build per-shard forward (group by local row) and
    transpose (group by extended column) layouts — the transpose built
    once on host replaces autodiff's big scatter, like trans_perm does
    for the single-chip path (gat_aggregator.cu:88-92 analog)."""
    split = split or ELL_SPLIT
    if len(rows) == 0:
        return []
    from graphaibench_tpu import native

    r_in = np.asarray(rows)
    order = native.stable_key_sort(r_in.astype(np.int32),
                                   int(r_in.max()) + 1)
    if order is None:
        order = np.argsort(r_in, kind="stable")
    r = r_in[order]
    c = np.asarray(cols)[order]
    e = np.asarray(eids)[order]
    uniq, starts, counts = _run_lengths(r)
    return _pack_rows(uniq.astype(np.int32), starts, counts, c, e, sentinel,
                      _widths_for_split(split), split, as_numpy=as_numpy)


def build_ell_buckets(g: CSRGraph, split: Optional[int] = None) -> list[EllBucket]:
    """Host-side degree-bucketed ELL packing with heavy-row splitting.

    Rows of degree 0 are skipped (their aggregation output is zero).
    Rows wider than ``split`` are broken into several virtual rows that
    target the same output row — consumers MUST accumulate with
    scatter-add, not set (spmm.py does)."""
    if g.nv == 0 or g.ne == 0:
        return []
    split = split or ELL_SPLIT
    widths = _widths_for_split(split)
    deg = g.degrees().astype(np.int64)
    return _pack_rows(np.arange(g.nv, dtype=np.int32), g.row_ptr[:-1], deg,
                      g.col_idx, None, g.ne, widths, split)


# column-segment width: a 2^17-row slice of a 128-feature f32 x is 64 MB,
# the fast-gather window of the chip this was tuned on
SEG_ROWS = 1 << 17
# enable the segmented layout automatically above this vertex count
# (chosen on another chip; not yet measured on the H100, ROADMAP design
# item 3)
SEG_ELL_MIN_NV = 1 << 19


def _run_lengths(sorted_keys):
    """(uniq, starts, counts) of an already-sorted key array in O(n) —
    np.unique re-sorts, which at 62M edges costs ~1 s per pass."""
    if len(sorted_keys) == 0:
        z = np.empty(0, np.int64)
        return sorted_keys, z, z
    idx = np.flatnonzero(sorted_keys[1:] != sorted_keys[:-1]) + 1
    starts = np.concatenate([[0], idx])
    counts = np.diff(np.concatenate([starts, [len(sorted_keys)]]))
    return sorted_keys[starts], starts, counts


def _pack_segment(es, ed, eid, ne, split, widths):
    """Pack one column segment's (src, local-dst, edge-id) triples —
    already in CSR (src-major) order — into ELL buckets (host numpy;
    the stacked device transfer happens once in _stack_segments)."""
    uniq, starts, counts = _run_lengths(es)
    return tuple(_pack_rows(uniq.astype(np.int32), starts, counts, ed, eid,
                            ne, widths, split, as_numpy=True))


def _group_segments(seg_lists, sentinel: int, max_groups: int = 4):
    """Stack per-segment bucket lists into per-width ROW-SORTED GROUPS:
    within a width, segments are sorted by row count and greedily cut
    where the group max exceeds ``ratio``x the next segment's rows
    (ratio grows until <= max_groups groups). Padding only reaches each
    group's max (1.79x -> ~1.1x ne slots at rmat20) and empty
    (width, segment) pairs are dropped entirely. Returns
    (group_segs, buckets) aligned tuples."""
    widths = sorted({b.width for bl in seg_lists for b in bl})
    group_segs, buckets = [], []
    for w in widths:
        entries = []
        for s, bl in enumerate(seg_lists):
            b = next((b for b in bl if b.width == w), None)
            if b is not None and b.rows > 0:
                entries.append((s, b))
        if not entries:
            continue
        entries.sort(key=lambda e: (-e[1].rows, e[0]))
        ratio = 1.3
        while True:
            groups, cur = [], [entries[0]]
            for e in entries[1:]:
                if cur[0][1].rows > ratio * e[1].rows:
                    groups.append(cur)
                    cur = [e]
                else:
                    cur.append(e)
            groups.append(cur)
            if len(groups) <= max_groups:
                break
            ratio *= 1.5
        for grp in groups:
            rmax = max(b.rows for _, b in grp)
            sg_n = len(grp)
            row = np.zeros((sg_n, rmax), np.int32)
            nbr = np.zeros((sg_n, rmax * w), np.int32)
            eid = np.full((sg_n, rmax * w), sentinel, np.int32)
            for j, (_s, b) in enumerate(grp):
                r = b.rows
                row[j, :r] = b.row_ids
                nbr[j, :r * w] = b.nbr
                eid[j, :r * w] = b.edge_id
            group_segs.append(tuple(s for s, _ in grp))
            buckets.append(EllBucket(row_ids=jnp.asarray(row),
                                     nbr=jnp.asarray(nbr),
                                     edge_id=jnp.asarray(eid), width=w))
    return tuple(group_segs), tuple(buckets)


def _stack_segments(seg_lists, nseg: int, sentinel: int) -> tuple:
    """Pad per-segment bucket lists to uniform shapes per width and
    stack on a leading [S] axis (one device transfer per width)."""
    widths = sorted({b.width for bl in seg_lists for b in bl})
    out = []
    for w in widths:
        per = [next((b for b in bl if b.width == w), None)
               for bl in seg_lists]
        rmax = max(max((b.rows for b in per if b is not None), default=0), 1)
        row = np.zeros((nseg, rmax), np.int32)
        nbr = np.zeros((nseg, rmax * w), np.int32)
        eid = np.full((nseg, rmax * w), sentinel, np.int32)
        for s, b in enumerate(per):
            if b is None:
                continue
            r = b.rows
            row[s, :r] = b.row_ids
            nbr[s, :r * w] = b.nbr
            eid[s, :r * w] = b.edge_id
        out.append(EllBucket(row_ids=jnp.asarray(row), nbr=jnp.asarray(nbr),
                             edge_id=jnp.asarray(eid), width=w))
    return tuple(out)


def build_seg_ell(g: CSRGraph, seg_rows: int = SEG_ROWS,
                  split: Optional[int] = None) -> SegmentedEll:
    """Column-segmented ELL build: edges grouped by neighbor range,
    neighbor ids reindexed to the local slice.

    The partition is ONE stable counting sort by segment id (native
    O(ne); stability keeps CSR order within each segment) instead of a
    boolean mask + nonzero pass per segment (O(nseg * ne)). At rmat20
    (8 segments) the build is dominated by packing either way; the
    sort's O(ne) partition pays off as nseg grows (products scale: 16+
    segments)."""
    split = split or ELL_SPLIT
    widths = _widths_for_split(split)
    src, dst = g.coo()
    ne = g.ne
    # GAB_SEG_ROWS: column-slice rows override (pow-of-2 sweeps; grouped
    # stacking made finer segments cheap — pad no longer scales with S)
    env_rows = os.environ.get("GAB_SEG_ROWS", "").strip()
    if env_rows and seg_rows == SEG_ROWS:
        seg_rows = int(env_rows)
    bounds = seg_bounds(g.nv, dst, seg_rows)
    nseg = len(bounds)

    from graphaibench_tpu import native

    # segment id per edge from the (static, small) boundary list
    los = np.asarray([lo for lo, _ in bounds], np.int64)
    perm = None
    if ne:
        keys = (np.searchsorted(los, np.asarray(dst, np.int64),
                                side="right") - 1).astype(np.int32)
        perm = native.stable_key_sort(keys, nseg)
    segs = []
    if perm is not None:
        counts = np.bincount(keys, minlength=nseg)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for s, (lo, hi) in enumerate(bounds):
            eid = perm[starts[s]:starts[s + 1]].astype(np.int64)
            if len(eid) == 0:
                segs.append(())
                continue
            segs.append(_pack_segment(src[eid], dst[eid] - lo, eid, ne,
                                      split, widths))
    else:  # no native toolchain: per-segment mask passes
        for lo, hi in bounds:
            sel = (dst >= lo) & (dst < hi)
            eid = np.nonzero(sel)[0]
            if len(eid) == 0:
                segs.append(())
                continue
            # CSR order is preserved by the mask, so src stays grouped
            segs.append(_pack_segment(src[eid], dst[eid] - lo, eid, ne,
                                      split, widths))
    # GAB_SEG_GROUPS: max groups per width (default 4 — more groups pad
    # less but grow the scan-body count and the program); 1 = one group
    # per width (the uniform-stack ablation, minus dropped empties)
    max_groups = int(os.environ.get("GAB_SEG_GROUPS", "4") or 4)
    group_segs, buckets = _group_segments(segs, ne,
                                          max_groups=max(max_groups, 1))
    return SegmentedEll(bounds=bounds, nv=g.nv, buckets=buckets,
                        group_segs=group_segs)


def build_segorder_ell(g: CSRGraph, seg_rows: int = SEG_ROWS,
                       split: Optional[int] = None) -> tuple:
    """PROBE layout: plain ELL buckets whose (virtual) rows are grouped
    by destination-column segment — GLOBAL neighbor ids, zero stacking
    pad, no slicing. Distinguishes whether a segmenting win comes
    from the sliced gather table or merely from the index stream
    being CLUSTERED within a 64 MB window at a time (in which case this
    layout gets the locality for free). Consumed as DeviceGraph.ell."""
    split = split or ELL_SPLIT
    widths = _widths_for_split(split)
    src, dst = g.coo()
    ne = g.ne
    bounds = seg_bounds(g.nv, dst, seg_rows)

    from graphaibench_tpu import native

    los = np.asarray([lo for lo, _ in bounds], np.int64)
    keys = (np.searchsorted(los, np.asarray(dst, np.int64),
                            side="right") - 1).astype(np.int32)
    perm = native.stable_key_sort(keys, len(bounds))
    if perm is None:
        perm = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=len(bounds))
    starts = np.concatenate([[0], np.cumsum(counts)])
    per_width: dict = {}
    for s in range(len(bounds)):
        eid = perm[starts[s]:starts[s + 1]].astype(np.int64)
        if len(eid) == 0:
            continue
        uniq, st, cnt = _run_lengths(src[eid])
        for b in _pack_rows(uniq.astype(np.int32), st, cnt, dst[eid],
                            eid, ne, widths, split, as_numpy=True):
            per_width.setdefault(b.width, []).append(b)
    return tuple(
        EllBucket(
            row_ids=jnp.asarray(np.concatenate([b.row_ids for b in bl])),
            nbr=jnp.asarray(np.concatenate([b.nbr for b in bl])),
            edge_id=jnp.asarray(np.concatenate([b.edge_id for b in bl])),
            width=w)
        for w, bl in sorted(per_width.items()))


def seg_bounds(nv: int, dst: np.ndarray, seg_rows: int = SEG_ROWS) -> tuple:
    """EQUAL-EDGE column ranges, width-capped at ``seg_rows``.

    Power-law graphs concentrate edges in the low-id columns: with
    equal-VERTEX ranges the per-width bucket row counts varied ~10x
    across segments and padding to the stacked max blew the slot count
    to 3.2x ne at rmat20. Greedy equal-edge cuts (each range also
    <= seg_rows columns, keeping every gather window inside the
    SEG_ROWS slice) balance the
    stacks to ~the per-segment-exact slot count."""
    if nv == 0:
        return ()
    if len(dst) == 0:
        return tuple((lo, min(lo + seg_rows, nv))
                     for lo in range(0, nv, seg_rows))
    cum = np.concatenate(
        [[0], np.cumsum(np.bincount(np.asarray(dst, np.int64),
                                    minlength=nv))])
    n_min = -(-nv // seg_rows)
    target = len(dst) / n_min
    bounds = []
    lo = 0
    while lo < nv:
        cap = min(lo + seg_rows, nv)
        hi = int(np.searchsorted(cum, cum[lo] + target, side="left"))
        hi = max(lo + 1, min(hi, cap))
        bounds.append((lo, hi))
        lo = hi
    return tuple(bounds)


def slim_for_packed(g: DeviceGraph) -> DeviceGraph:
    """Drop the device arrays the packed static-weight SpMM path never
    reads: the COO edge arrays, the transpose permutation (the packed
    adjoint pre-gathers transposed weights), and the bucket edge ids
    (packed kernels gather weights from the pre-packed tables). At
    products shape these were ~1.8 GB of dead device memory. Consumers
    that need
    them (GAT, runtime per-edge weights, analytics) must keep the full
    graph."""
    def strip(b):
        return dataclasses.replace(b, edge_id=None)

    seg = g.seg_ell
    if seg is not None:
        seg = dataclasses.replace(
            seg, buckets=tuple(strip(b) for b in seg.buckets))
    one = jnp.zeros((1,), jnp.int32)
    return dataclasses.replace(
        g, col_idx=one, edge_src=one, trans_perm=None,
        ell=tuple(strip(b) for b in g.ell), seg_ell=seg)


def to_device_graph(
    g: CSRGraph,
    *,
    with_transpose: bool = True,
    with_ell: bool = True,
    ell_split: Optional[int] = None,
    seg_ell: Optional[bool] = None,
) -> DeviceGraph:
    """One-time host -> device transfer (the analog of the reference's
    single copy_to_gpu crossing, net.cpp:186-187).

    ``seg_ell=None`` enables the column-segmented layout automatically
    for graphs above SEG_ELL_MIN_NV vertices (where whole-table gathers
    fall off the fast window). When the segmented layout is built, the
    plain ELL layout is NOT: every vertex-gathering op prefers seg-ELL
    (``iter_buckets_sliced``) and row reductions flatten the segment
    buckets (``all_buckets``), so a second copy of the slot arrays would
    only burn device memory — ~1 GB of (nbr, edge_id) int32 pairs at the
    products-shaped scale (2M v / 103M e, 1.2x pad)."""
    assert g.ne < 2**31, "per-shard edge count must fit int32; partition first"
    src, dst = g.coo()
    trans = (
        jnp.asarray(T.transpose_edge_permutation(g)) if with_transpose else None
    )
    if seg_ell is None:
        # GAB_SEG_ELL=0|1 overrides the size heuristic (ablations).
        env = os.environ.get("GAB_SEG_ELL", "").strip().lower()
        if env:
            seg_ell = with_ell and env not in ("0", "false", "off", "no")
        else:
            seg_ell = with_ell and g.nv >= SEG_ELL_MIN_NV
    seg = build_seg_ell(g, split=ell_split) if (seg_ell and with_ell and
                                                g.ne > 0) else None
    ell = tuple(build_ell_buckets(g, ell_split)) if (with_ell and
                                                     seg is None) else ()
    return DeviceGraph(
        row_ptr=jnp.asarray(g.row_ptr.astype(np.int32)),
        col_idx=jnp.asarray(dst),
        edge_src=jnp.asarray(src),
        deg=jnp.asarray(g.degrees()),
        trans_perm=trans,
        ell=ell,
        nv=g.nv,
        ne=g.ne,
        seg_ell=seg,
    )
