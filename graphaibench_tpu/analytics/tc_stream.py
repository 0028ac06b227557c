"""Streaming triangle counting DIRECTLY on a CGR-compressed graph.

The reference iterates compressed neighborhoods on the fly without
materializing the full CSR (`N_cgr` accessors graph.h:213-238,
src/structure/tc_omp_compressed.cc, bfs_gcgt_cta.cuh) — compression's
whole point at memory limits. The device translation here:

  * the compressed stream stays device-resident; vertex-BLOCK subsets
    decode on device through the CGR residual scans (cgr_device's
    bucketed lane machinery restricted to a contiguous vertex range —
    per-vertex offsets give random access, so a block's decode cost is
    proportional to ITS edges, not the graph's);
  * each decoded block is DAG-filtered (degree-then-id rank, the
    orientation of graph.cc:615-700 — any total order counts each
    triangle once) and packed into a padded row matrix ON DEVICE;
  * triangles accumulate over block PAIRS (I source rows, J destination
    rows) with the fused compare-all kernel of analytics.tc, the source
    side grouped by pow2 DAG-out-degree exactly like the uncompressed
    solver.

Peak device memory is (compressed stream) + two block matrices + one
block's edge buffers — never the (ne,) col_idx of the whole graph. The
full CSR is likewise never materialized on host. Plain (non-interval)
CGR streams only; callers fall back to decode-then-count otherwise.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.compress.cgr import CompressedGraph
from graphaibench_tpu.compress.cgr_device import (
    _counts,
    _gamma_len_np,
    _headers,
    _pairs,
    _pow2_pad,
    _quads,
    _residual_pass,
)


def _pow2(n: int, lo: int = 1) -> int:
    t = lo
    while t < n:
        t *= 2
    return t


@dataclasses.dataclass
class CgrStream:
    """Device-resident compressed stream + host lane tables (built once
    from the header/count passes — O(segments), never O(edges))."""

    nv: int
    ne: int
    zeta_k: int
    quads: jnp.ndarray          # device stream view
    deg: np.ndarray             # (nv,) int64, derived from counts
    deg_d: jnp.ndarray          # (nv,) int32 device (rank compares)
    lane_start: np.ndarray      # (nv+1,) first lane of each vertex
    lane_v: np.ndarray          # (L,) owning vertex
    data_p: np.ndarray          # (L,) int32 bit position after the count
    counts: np.ndarray          # (L,) int64 residuals in the lane


def open_cgr_stream(cg: CompressedGraph) -> CgrStream:
    cfg = cg.cfg
    if cfg.use_interval:
        raise ValueError("streaming TC: interval CGR streams unsupported "
                         "(decode-then-count handles them)")
    if cfg.res_seg_len == 0:
        raise ValueError("streaming TC: unsegmented (unary) stream")
    nv, ne = cg.nv, cg.ne
    pad = (-len(cg.data)) % 4 + 16
    words = jnp.asarray(np.frombuffer(
        cg.data + b"\x00" * pad, dtype=">u4").astype(np.uint32))
    pairs = _pairs(words)
    quads = _quads(words)
    bits = np.asarray(cg.offsets, dtype=np.int64) * cfg.unit_bits
    assert bits[-1] < 2**31, "stream too large for int32 bit positions"
    bit_off = jnp.asarray(bits[:nv].astype(np.int32))
    nsegs_d, segs_base_d = _headers(pairs, bit_off, cfg.add_degree)
    nsegs = np.asarray(nsegs_d).astype(np.int64)
    segs_base = np.asarray(segs_base_d)
    lane_v = np.repeat(np.arange(nv, dtype=np.int32), nsegs)
    starts = np.concatenate([[0], np.cumsum(nsegs)[:-1]])
    lane_k = (np.arange(len(lane_v), dtype=np.int64)
              - starts[lane_v]).astype(np.int64)
    seg_start = segs_base[lane_v] + lane_k * cfg.res_seg_len
    if len(lane_v):
        counts_d, _ = _counts(pairs, jnp.asarray(seg_start),
                              jnp.ones(len(lane_v), bool))
        counts = np.asarray(counts_d).astype(np.int64)
    else:
        counts = np.zeros(0, np.int64)
    data_p = (seg_start + _gamma_len_np(counts)).astype(np.int32)
    deg = np.zeros(nv, np.int64)
    np.add.at(deg, lane_v, counts)
    if int(deg.sum()) != ne:
        raise ValueError("streaming TC: stream parse mismatch "
                         f"({int(deg.sum())} != {ne})")
    lane_start = np.concatenate([[0], np.cumsum(nsegs)]).astype(np.int64)
    del pairs, words
    return CgrStream(nv=nv, ne=ne, zeta_k=cfg.zeta_k, quads=quads,
                     deg=deg, deg_d=jnp.asarray(deg.astype(np.int32)),
                     lane_start=lane_start, lane_v=lane_v,
                     data_p=data_p, counts=counts)


def _decode_block(st: CgrStream, vlo: int, vhi: int):
    """Decode vertices [vlo, vhi) on device. Returns (col device
    (ne_pad,) with absolute neighbor ids, rp_local host (n+1,), ne_blk).
    Work and memory are proportional to the block."""
    sl = slice(st.lane_start[vlo], st.lane_start[vhi])
    lane_v = st.lane_v[sl]
    counts = st.counts[sl]
    data_p = st.data_p[sl]
    deg_blk = st.deg[vlo:vhi]
    rp_local = np.concatenate([[0], np.cumsum(deg_blk)]).astype(np.int64)
    ne_blk = int(rp_local[-1])
    ne_pad = _pow2(max(ne_blk, 1), lo=4096)
    # compact base: the block is a contiguous id range, so local slot =
    # global CSR slot - row_ptr[vlo]
    res_start = np.zeros(vhi - vlo, np.int64)
    np.add.at(res_start, lane_v - vlo, counts)
    # per-lane within-vertex offset (CSR lane order)
    gidx = np.cumsum(counts) - counts
    v_first = np.zeros(vhi - vlo, np.int64)
    sel_first = np.unique(lane_v - vlo, return_index=True)
    v_first[sel_first[0]] = gidx[sel_first[1]]
    base = (rp_local[lane_v - vlo] + (gidx - v_first[lane_v - vlo])
            ).astype(np.int32)

    order = np.argsort(counts, kind="stable")
    sc = counts[order]
    col = jnp.zeros((ne_pad,), jnp.int32)
    lo = 0
    for trip in (8, 32, 128, 512, 2048, 8192):
        hi = np.searchsorted(sc, trip, side="right")
        sel = order[lo:hi]
        sel = sel[counts[sel] > 0]
        lo = hi
        if len(sel) == 0:
            continue
        n_pad = _pow2_pad(len(sel))
        pd = np.zeros(n_pad - len(sel), np.int32)
        col, _ = _residual_pass(
            st.quads,
            jnp.asarray(np.concatenate([data_p[sel], pd])),
            jnp.asarray(np.concatenate([counts[sel].astype(np.int32), pd])),
            jnp.asarray(np.concatenate([lane_v[sel], pd])),
            jnp.asarray(np.concatenate([base[sel], pd])),
            col, st.zeta_k, trip, ne_pad)
    if lo != len(order) and len(order):
        raise ValueError("streaming TC: count exceeds the trip grid")
    return col, rp_local, ne_blk


@functools.partial(jax.jit, static_argnames=("n_rows", "w_pad", "ne_pad"))
def _dag_pack(col, rp_starts, deg_d, vlo: int, n_rows: int, w_pad: int,
              ne_pad: int):
    """DAG-filter a decoded block and pack its kept neighbors into a
    (n_rows * w_pad,) padded matrix (sentinel = nv+1 > any id), plus the
    per-slot (u_local, keep) arrays for edge-driving. Rank order:
    (degree, id) lexicographic — edge u->v kept iff rank(u) < rank(v)."""
    nv = deg_d.shape[0]
    e = jnp.arange(ne_pad, dtype=jnp.int32)
    bump = jnp.zeros(ne_pad, jnp.int32).at[rp_starts[1:]].add(
        1, mode="drop", indices_are_sorted=True)
    u_loc = jnp.cumsum(bump, dtype=jnp.int32)            # (ne_pad,)
    u = u_loc + vlo
    v = col
    du, dv = deg_d[jnp.minimum(u, nv - 1)], deg_d[jnp.minimum(v, nv - 1)]
    keep = (du < dv) | ((du == dv) & (u < v))
    # in-DAG position within the row: prefix of keep minus the row base
    ck = jnp.cumsum(keep.astype(jnp.int32), dtype=jnp.int32)
    excl = ck - keep
    row_base = excl[jnp.clip(rp_starts[:-1], 0, ne_pad - 1)]
    deltas = jnp.diff(row_base, prepend=row_base[:1])
    deltas = deltas.at[0].set(row_base[0])
    carry = jnp.zeros(ne_pad, jnp.int32).at[
        jnp.clip(rp_starts[:-1], 0, ne_pad - 1)].add(
        deltas, mode="drop", indices_are_sorted=True)
    posk = excl - jnp.cumsum(carry, dtype=jnp.int32)
    # validity: slots beyond the block's real edges are junk
    valid = e < rp_starts[-1]
    keep = keep & valid
    slots = jnp.where(keep & (posk < w_pad), u_loc * w_pad + posk,
                      n_rows * w_pad)
    packed = jnp.full((n_rows * w_pad + 1,), nv + 1, jnp.int32)
    packed = packed.at[slots].set(jnp.where(keep, v, nv + 1), mode="drop")
    dagdeg = jnp.zeros((n_rows,), jnp.int32).at[u_loc].add(
        keep.astype(jnp.int32), mode="drop")
    return packed[:-1].reshape(n_rows, w_pad), u, v, keep, dagdeg


def triangle_count_streaming(cg: CompressedGraph, *,
                             block_bytes: int = 32 << 20) -> tuple:
    """Exact triangle count without ever materializing the full CSR.
    Returns (count, stats dict with peak block sizes).

    ``block_bytes`` trades peak footprint against block-PAIR count and
    jit-shape diversity: every (wa-class, wJ, chunk-length) combination
    is a distinct compile, so small blocks multiply compiles (peak block
    423 MB vs the 65 MB uncompressed CSR at rmat19; memory-over-speed is
    the
    reference's own trade, tc_omp_compressed.cc)."""
    st = open_cgr_stream(cg)
    nv, ne = st.nv, st.ne
    # contiguous equal-edge blocks sized to the byte budget (col buffer
    # ne_blk*4 and packed matrix both bounded by it)
    cum = np.concatenate([[0], np.cumsum(st.deg)])
    target_edges = max(block_bytes // 8, 1 << 12)
    slot_budget = max(block_bytes // 4, 1 << 14)

    def initial_bounds():
        out, lo = [], 0
        while lo < nv:
            hi = int(np.searchsorted(cum, cum[lo] + target_edges, "left"))
            hi = max(lo + 1, min(hi, nv))
            out.append((lo, hi))
            lo = hi
        return out

    # refinement pre-pass: the packed matrix is (n_rows, w_pad) DENSE,
    # and w (the block's max DAG out-degree) is only known after a
    # decode — blocks whose matrix would exceed the slot budget split
    # at their edge midpoint until every block fits (memory over speed:
    # re-decodes are the price of the bounded footprint)
    work = initial_bounds()
    bounds = []
    while work:
        ilo, ihi = work.pop()
        colI, rpI, _ = _decode_block(st, ilo, ihi)
        rpI_d = jnp.asarray(np.clip(rpI, 0, int(colI.shape[0]))
                            .astype(np.int32))
        _, _, _, _, dd = _dag_pack(colI, rpI_d, st.deg_d, ilo,
                                   ihi - ilo, 1, int(colI.shape[0]))
        wI = _pow2(max(int(jnp.max(dd)), 1))
        if (ihi - ilo) * wI > slot_budget and ihi - ilo > 1:
            mid = int(np.searchsorted(cum, (cum[ilo] + cum[ihi]) // 2,
                                      "left"))
            mid = min(max(mid, ilo + 1), ihi - 1)
            work.extend([(ilo, mid), (mid, ihi)])
        else:
            bounds.append((ilo, ihi))
    bounds.sort()
    stats = {"blocks": len(bounds), "ne": ne, "nv": nv,
             "peak_block_slots": 0}

    total = 0
    for (ilo, ihi) in bounds:
        colI, rpI, neI = _decode_block(st, ilo, ihi)
        nI = ihi - ilo
        ne_padI = int(colI.shape[0])
        rpI_d = jnp.asarray(np.clip(rpI, 0, ne_padI).astype(np.int32))
        # first pass to learn the block's DAG width (one host sync)
        w_probe = 1
        packedI, uI, vI, keepI, dagdegI = _dag_pack(
            colI, rpI_d, st.deg_d, ilo, nI, w_probe, ne_padI)
        wI = _pow2(max(int(jnp.max(dagdegI)), 1))
        packedI, uI, vI, keepI, dagdegI = _dag_pack(
            colI, rpI_d, st.deg_d, ilo, nI, wI, ne_padI)
        stats["peak_block_slots"] = max(stats["peak_block_slots"],
                                        nI * wI + ne_padI)
        # group this block's DAG edges by the pow2 DAG-out-degree of
        # their source (host: one (ne_pad,) fetch of compact data)
        keep_h = np.asarray(keepI)
        u_h = np.asarray(uI)[keep_h]
        v_h = np.asarray(vI)[keep_h]
        dd_h = np.asarray(dagdegI)
        wa_of = np.maximum(dd_h[u_h - ilo], 8)
        wa_cls = np.minimum(2 ** np.ceil(np.log2(wa_of)).astype(np.int64),
                            wI)
        for (jlo, jhi) in bounds:
            sel = (v_h >= jlo) & (v_h < jhi)
            if not sel.any():
                continue
            if (jlo, jhi) == (ilo, ihi):
                packedJ, wJ, nJ = packedI, wI, nI
            else:
                colJ, rpJ, neJ = _decode_block(st, jlo, jhi)
                nJ = jhi - jlo
                ne_padJ = int(colJ.shape[0])
                rpJ_d = jnp.asarray(np.clip(rpJ, 0, ne_padJ)
                                    .astype(np.int32))
                pj, _, _, _, ddJ = _dag_pack(colJ, rpJ_d, st.deg_d, jlo,
                                             nJ, 1, ne_padJ)
                wJ = _pow2(max(int(jnp.max(ddJ)), 1))
                packedJ, _, _, _, _ = _dag_pack(colJ, rpJ_d, st.deg_d,
                                                jlo, nJ, wJ, ne_padJ)
                stats["peak_block_slots"] = max(
                    stats["peak_block_slots"],
                    nI * wI + nJ * wJ + ne_padJ)
            for wa in np.unique(wa_cls[sel]):
                m = sel & (wa_cls == wa)
                us, vs = u_h[m] - ilo, v_h[m] - jlo
                C = _pow2(len(us), lo=1024)
                us_d = jnp.asarray(np.pad(us, (0, C - len(us)))
                                   .astype(np.int32))
                vs_d = jnp.asarray(np.pad(vs, (0, C - len(vs)))
                                   .astype(np.int32))
                valid = jnp.arange(C, dtype=jnp.int32) < len(us)
                total += int(_count_edges(packedI, packedJ, us_d, vs_d,
                                          valid, int(wa), nv))
    return total, stats


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _bfs_block_sweep(col, rp_starts, dist, new_dist, vlo: int,
                     n_rows: int, level):
    """One BFS level restricted to a decoded block: rows [vlo, vlo+n)
    pull over their decoded neighbors — unreached rows with any
    neighbor at ``level`` get level+1."""
    ne_pad = col.shape[0]
    bump = jnp.zeros(ne_pad, jnp.int32).at[rp_starts[1:]].add(
        1, mode="drop", indices_are_sorted=True)
    u_loc = jnp.cumsum(bump, dtype=jnp.int32)
    valid = jnp.arange(ne_pad, dtype=jnp.int32) < rp_starts[-1]
    hit = valid & (dist[jnp.clip(col, 0, dist.shape[0] - 1)] == level)
    reached = jnp.zeros((n_rows,), jnp.bool_).at[u_loc].max(
        hit, mode="drop")
    seg = jax.lax.dynamic_slice_in_dim(dist, vlo, n_rows)
    upd = reached & (seg < 0)
    return jax.lax.dynamic_update_slice_in_dim(
        new_dist, jnp.where(upd, level + 1, seg), vlo, axis=0), jnp.any(upd)


def bfs_streaming(cg: CompressedGraph, source: int, *,
                  block_bytes: int = 32 << 20) -> np.ndarray:
    """Level-synchronous BFS pulling DIRECTLY off the compressed stream
    (the bfs_gcgt compressed-BFS analog): each level decodes the graph
    block-by-block on device — peak device memory = stream + one block + the
    (nv,) dist vector; the (ne,) CSR never exists. Structurally
    symmetric graphs (pull == push reachability). Cost: one full
    stream decode per level — memory bought with decode work, the same
    trade the reference's compressed kernels make."""
    st = open_cgr_stream(cg)
    nv = st.nv
    cum = np.concatenate([[0], np.cumsum(st.deg)])
    target_edges = max(block_bytes // 8, 1 << 12)
    bounds = []
    lo = 0
    while lo < nv:
        hi = int(np.searchsorted(cum, cum[lo] + target_edges, "left"))
        hi = max(lo + 1, min(hi, nv))
        bounds.append((lo, hi))
        lo = hi
    dist = jnp.full((nv,), -1, jnp.int32).at[source].set(0)
    level = 0
    while True:
        new_dist = dist
        any_upd = False
        for (vlo, vhi) in bounds:
            col, rp, _ne_blk = _decode_block(st, vlo, vhi)
            rp_d = jnp.asarray(np.clip(rp, 0, int(col.shape[0]))
                               .astype(np.int32))
            new_dist, upd = _bfs_block_sweep(
                col, rp_d, dist, new_dist, vlo, vhi - vlo,
                jnp.int32(level))
            any_upd = any_upd or bool(upd)
        if not any_upd:
            return np.asarray(dist)
        dist = new_dist
        level += 1


@functools.partial(jax.jit, static_argnames=("wa", "sent"))
def _count_edges(packedI, packedJ, us, vs, valid, wa: int, sent: int):
    """|N+(u) ∩ N+(v)| summed over an edge chunk: compare-all between
    the two packed block tables (sentinel nv+1 never equals a real id,
    and sentinel-vs-sentinel is masked on the a side)."""
    a = packedI[us][:, :wa]
    b = packedJ[vs]
    eq = (a[:, :, None] == b[:, None, :]) & (a <= sent)[:, :, None]
    return jnp.sum(eq & valid[:, None, None], dtype=jnp.int32)
