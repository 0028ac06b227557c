"""On-device CGR adjacency decoding.

CGR is a bit-granular stream of Elias gamma / zeta_k codes — every code's
position depends on all previous codes, so a flat vectorization like the
StreamVByte decoder's (device_decode.py) is impossible. What makes device
decode viable is the format's own RESIDUAL SEGMENTATION (cgr_encoder.cc
append_segment semantics, reproduced in compress/cgr.py): every closed
segment is padded to exactly ``res_seg_len`` bits, so segment k of
vertex v starts at the statically computable bit position
``segs_base(v) + k * res_seg_len`` and is decodable INDEPENDENTLY
(each segment's first residual is coded against v, continuations against
the in-segment predecessor).

The decoder therefore runs in vectorized phases:

  1. header pass, one lane per VERTEX (sequential gamma codes: optional
     degree, then the first section's num_segments-1),
  2. count pass, one lane per (vertex, segment) (1 gamma code),
  3. residual pass: a lax.scan of at most ``trip`` zeta_k codes where
     every (vertex, segment) lane decodes one code per step — the
     segment length bounds the trip count by ~res_seg_len/3 REGARDLESS
     of degree skew (a hub's 20k-edge list is just 20k/res_cnt lanes).

Interval-coded streams (use_interval=True, the reference's headline CGR
mode) add two phases in front: the interval segments decode with the
same (count pass + bucketed scan) machinery — two gamma codes per
interval (left delta, length) — and, because the LAST interval segment
is unpadded, the scan's final bit position IS each vertex's residual
section base. Interval expansion to edge ids happens on device with the
exact integer scatter-delta + cumsum trick (exact for ints only), and
the per-row merge of sorted residuals with sorted interval runs is one
lexicographic (row, value) ``lax.sort`` over the whole edge array.

All bit reads are 32-bit windows from a word-pair gather (bytes packed
MSB-first -> big-endian word view), leading-zero counts via lax.clz.

Reference analog: include/cgr_decoder.cuh:269 (interval+residual device
decode) + the segmented GPU TC kernels (src/structure/tc_gpu_compressed
.cu) which assign segments to warps the same way. Unary (res_seg_len=0)
streams fall back to the host decoder, as does any stream whose parse
turns out inconsistent — oversized multi-slot segments are detected
EXACTLY from each scan's final bit position (see
_check_closed_segments_fit), and the derived edge total must match ne.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph


def _pairs(words: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([words[:-1], words[1:]], axis=1)      # (W-1, 2)


def _quads(words: jnp.ndarray) -> jnp.ndarray:
    """(W-3, 4) sliding word windows: one 16-byte row gather yields a
    96+ bit bit-window — enough for any whole zeta/gamma code (max ~48
    bits), halving the gathers per decoded code."""
    return jnp.stack([words[:-3], words[1:-2], words[2:-1], words[3:]],
                     axis=1)


def _read32(pairs: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Bits [p, p+32) of the MSB-first stream, MSB-aligned in a uint32."""
    pw = pairs[p >> 5]                                      # (L, 2)
    w0 = pw[..., 0].astype(jnp.uint32)
    w1 = pw[..., 1].astype(jnp.uint32)
    s = (p & 31).astype(jnp.uint32)
    return jnp.where(s == 0, w0, (w0 << s) | (w1 >> (32 - s)))


def _clz(win: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.clz(jax.lax.bitcast_convert_type(win, jnp.int32))


def _read_gamma(pairs, p):
    """(value, nbits) of the gamma code at bit position p."""
    win = _read32(pairs, p)
    l = _clz(win)                                           # len bits
    low = _read32(pairs, p + l + 1)
    l_u = l.astype(jnp.uint32)
    frac = jnp.where(l == 0, jnp.uint32(0), low >> (32 - l_u))
    y = (jnp.uint32(1) << l_u) | frac
    return (y - 1).astype(jnp.int32), 2 * l + 1


def _read_zeta(pairs, p, k: int):
    """(value, nbits) of the zeta_k code at bit position p."""
    if k == 1:
        return _read_gamma(pairs, p)
    win = _read32(pairs, p)
    h = _clz(win)
    nb = (h + 1) * k                                        # y bits
    yw = _read32(pairs, p + h + 1)
    nb_u = jnp.minimum(nb, 32).astype(jnp.uint32)
    y = jnp.where(nb >= 32, yw, yw >> (32 - nb_u))
    return (y - 1).astype(jnp.int32), h + 1 + nb


def _read_code_quad(quads, p, k: int):
    """(value, nbits) of one whole zeta_k (gamma if k==1) code from a
    SINGLE quad gather: 64 bits of window reach past any valid code."""
    q = quads[p >> 5]                                       # (L, 4)
    q0 = q[..., 0].astype(jnp.uint32)
    q1 = q[..., 1].astype(jnp.uint32)
    q2 = q[..., 2].astype(jnp.uint32)
    sv = (p & 31).astype(jnp.uint32)
    hi = jnp.where(sv == 0, q0, (q0 << sv) | (q1 >> (32 - sv)))
    lo = jnp.where(sv == 0, q1, (q1 << sv) | (q2 >> (32 - sv)))
    h = _clz(hi)
    if k == 1:
        # gamma: y = 1<<h | next h bits after the leading one
        off = (h + 1).astype(jnp.uint32)
        yw = jnp.where(off == 32, lo, (hi << off) | (lo >> (32 - off)))
        h_u = h.astype(jnp.uint32)
        frac = jnp.where(h == 0, jnp.uint32(0), yw >> (32 - h_u))
        y = (jnp.uint32(1) << h_u) | frac
        return (y - 1).astype(jnp.int32), 2 * h + 1
    nb = (h + 1) * k
    off = (h + 1).astype(jnp.uint32)
    yw = jnp.where(off == 32, lo, (hi << off) | (lo >> (32 - off)))
    nb_u = jnp.minimum(nb, 32).astype(jnp.uint32)
    y = jnp.where(nb >= 32, yw, yw >> (32 - nb_u))
    return (y - 1).astype(jnp.int32), h + 1 + nb


def _nat2int(x: jnp.ndarray) -> jnp.ndarray:
    """int_2_nat inverse: even -> n/2, odd -> -((n+1)/2)."""
    return jnp.where(x & 1, -((x + 1) >> 1), x >> 1)


@functools.partial(jax.jit, static_argnames=("add_degree",))
def _headers(pairs, bit_off, add_degree: bool):
    """Per-vertex header decode -> (nsegs, segs_base)."""
    p = bit_off
    if add_degree:
        d, nb = _read_gamma(pairs, p)
        p = p + nb
        ns, nb2 = _read_gamma(pairs, p)
        nsegs = jnp.where(d == 0, 0, ns + 1)
        base = jnp.where(d == 0, p, p + nb2)
    else:
        ns, nb2 = _read_gamma(pairs, p)
        nsegs = ns + 1
        base = p + nb2
    return nsegs, base


@jax.jit
def _counts(pairs, seg_start, active):
    c, nb = _read_gamma(pairs, seg_start)
    return jnp.where(active, c, 0), seg_start + nb


@functools.partial(jax.jit, static_argnames=("min_itv_len", "trip", "n_itv"),
                   donate_argnames=("left_all", "len_all"))
def _interval_pass(quads, data_p, counts, lane_v, base, left_all, len_all,
                   min_itv_len: int, trip: int, n_itv: int):
    """Decode up to ``trip`` (left, len) interval pairs per lane — two
    gamma codes each (cgr_encoder.cc interval semantics: the segment's
    first left is int2nat(left - v), continuations are gap-coded against
    prev_left + prev_len + 1; lengths are biased by min_itv_len). Also
    returns each lane's final bit position: for a vertex's LAST segment
    that is exactly where its residual section starts."""
    zeros = jnp.zeros_like(data_p)

    def step(carry, _):
        p, prev_left, prev_len, i = carry
        x1, nb1 = _read_code_quad(quads, p, 1)
        x2, nb2 = _read_code_quad(quads, p + nb1, 1)
        left = jnp.where(i == 0, lane_v + _nat2int(x1),
                         prev_left + prev_len + 1 + x1)
        ln = x2 + min_itv_len
        active = i < counts
        p = jnp.where(active, p + nb1 + nb2, p)
        prev_left = jnp.where(active, left, prev_left)
        prev_len = jnp.where(active, ln, prev_len)
        return (p, prev_left, prev_len, i + 1), (
            jnp.where(active, left, 0), jnp.where(active, ln, 0))

    (p_fin, _, _, _), (lefts, lens) = jax.lax.scan(
        step, (data_p, zeros, zeros, jnp.int32(0)), None,
        length=trip, unroll=min(8, trip))
    i = jnp.arange(trip, dtype=jnp.int32)[:, None]
    slots = jnp.where(i < counts[None, :], base[None, :] + i, n_itv)
    left_all = left_all.at[slots].set(lefts, mode="drop")
    len_all = len_all.at[slots].set(lens, mode="drop")
    return left_all, len_all, p_fin


@functools.partial(jax.jit, static_argnames=("n_total",), donate_argnames=("col",))
def _expand_intervals(col, left_all, id_base, slot_base, n_total: int):
    """Expand decoded (left, len) intervals into edge ids ON DEVICE and
    scatter them into their final col slots. Both the id stream and the
    slot stream are affine in the flat position s (value = const_j + s
    within interval j), so each is one scatter of per-interval constant
    deltas + an int32 cumsum (exact for ints) — no (ne,)-sized host
    uploads."""
    s = jnp.arange(n_total, dtype=jnp.int32)
    val_const = left_all - id_base          # value at s = val_const_j + s
    slot_const = slot_base - id_base        # slot  at s = slot_const_j + s
    dval = val_const - jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), val_const[:-1]])
    dslot = slot_const - jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), slot_const[:-1]])
    ids = jnp.zeros((n_total,), jnp.int32).at[id_base].add(
        dval, mode="drop").cumsum() + s
    slots = jnp.zeros((n_total,), jnp.int32).at[id_base].add(
        dslot, mode="drop").cumsum() + s
    return col.at[slots].set(ids, mode="drop")


@functools.partial(jax.jit, static_argnames=("k", "trip", "ne"),
                   donate_argnames=("col",))
def _residual_pass(quads, data_p, counts, lane_v, base, col, k: int,
                   trip: int, ne: int):
    """Decode up to ``trip`` codes for every lane and scatter into the
    shared col buffer. Called once per count-bucket so the scan length
    tracks each lane's actual work instead of the global max."""
    zeros = jnp.zeros_like(data_p)

    def step(carry, _):
        p, prev, i = carry
        x, nb = _read_code_quad(quads, p, k)
        val = jnp.where(i == 0, lane_v + _nat2int(x), prev + x + 1)
        active = i < counts
        p = jnp.where(active, p + nb, p)
        prev = jnp.where(active, val, prev)
        return (p, prev, i + 1), jnp.where(active, val, 0)

    # unroll: the per-step fixed cost (one small dependent kernel per
    # code) dominates; unrolling fuses 8 codes per loop iteration
    (p_fin, _, _), vals = jax.lax.scan(
        step, (data_p, zeros, jnp.int32(0)), None,
        length=trip, unroll=min(8, trip))                     # (trip, L)
    i = jnp.arange(trip, dtype=jnp.int32)[:, None]
    slots = jnp.where(i < counts[None, :], base[None, :] + i, ne)
    return col.at[slots].set(vals, mode="drop"), p_fin


def _gamma_len_np(x: np.ndarray) -> np.ndarray:
    """Host gamma bit length: 2*floor(log2(x+1)) + 1."""
    return 2 * (np.floor(np.log2(x + 1)).astype(np.int64)) + 1


def _check_closed_segments_fit(pfin, seg_start, lane_k, nsegs, lane_v,
                               seg_len: int, what: str):
    """EXACT mis-parse detector: the device path assumes every closed
    segment occupies one seg_len slot (static stride). The encoder
    closes segments before overflow, so the only violation is a single
    item whose codes alone exceed seg_len (the reference encoder's
    multi-slot append_segment case). The first such segment of a vertex
    still decodes at a correct start, so its decoded content length
    (final scan position - segment start) exceeding seg_len is a
    precise witness — raise and let the caller fall back to host."""
    closed = lane_k < (nsegs[lane_v] - 1)
    if np.any((pfin - seg_start)[closed] > seg_len):
        raise ValueError(
            f"device CGR decode: oversized multi-slot {what} segment "
            f"(static {seg_len}-bit stride mis-parses this stream)")


def _pow2_pad(n: int, lo: int = 1024) -> int:
    t = lo
    while t < n:
        t *= 2
    return t


def cgr_device_prep(cg) -> dict:
    """Metadata phase of the device CGR decode: stream upload, header
    and count passes (with their two small host syncs), and every
    host-derived lane/bucket table, device-put once. The returned dict
    feeds ``cgr_device_run`` repeatedly with no further host work, so
    the decode-proper can be timed device-resident
    (tools/decode_bench.py --device-resident) — the analog of the
    reference decoding a RESIDENT compressed graph inside its analytics
    kernels (src/structure/tc_gpu_compressed.cu)."""
    cfg = cg.cfg
    if cfg.res_seg_len == 0:
        raise ValueError("device CGR decode: unsegmented (unary) stream")
    nv, ne = cg.nv, cg.ne
    unit = cfg.unit_bits
    seg_len = cfg.res_seg_len

    data = cg.data
    pad = (-len(data)) % 4 + 16
    words = jnp.asarray(np.frombuffer(
        data + b"\x00" * pad, dtype=">u4").astype(np.uint32))
    pairs = _pairs(words)
    quads = _quads(words)

    off = np.asarray(cg.offsets, dtype=np.int64)
    bits = off * unit
    assert bits[-1] < 2**31, "stream too large for int32 bit positions"
    bit_off = jnp.asarray(bits[:nv].astype(np.int32))

    if cfg.use_interval:
        (nsegs, segs_base, itv_vertex, left_all, itv_lens,
         n_itv) = _decode_interval_sections(cg, pairs, quads, bit_off)
    else:
        nsegs_d, segs_base_d = _headers(pairs, bit_off, cfg.add_degree)
        nsegs = np.asarray(nsegs_d).astype(np.int64)
        segs_base = np.asarray(segs_base_d)
        itv_vertex = np.zeros(0, np.int32)
        left_all = jnp.zeros((0,), jnp.int32)
        itv_lens = np.zeros(0, np.int64)
        n_itv = 0

    # exact (vertex, segment) lanes, in CSR order
    lane_v = np.repeat(np.arange(nv, dtype=np.int32), nsegs)
    starts = np.concatenate([[0], np.cumsum(nsegs)[:-1]])
    lane_k = (np.arange(len(lane_v), dtype=np.int64)
              - starts[lane_v]).astype(np.int32)
    seg_start = segs_base[lane_v] + lane_k * seg_len
    L = len(lane_v)
    if (L == 0 and n_itv == 0) or ne == 0:
        if ne != 0:
            raise ValueError("device CGR decode: parsed zero segments "
                             "for a non-empty graph")
        return {"empty": True, "nv": nv}

    if L:
        counts_d, _ = _counts(pairs, jnp.asarray(seg_start),
                              jnp.ones(L, bool))
        counts = np.asarray(counts_d).astype(np.int64)
    else:
        counts = np.zeros(0, np.int64)

    data_p = (seg_start + _gamma_len_np(counts)).astype(np.int32)
    nres = np.zeros(nv, np.int64)
    np.add.at(nres, lane_v, counts)
    deg = nres.copy()
    np.add.at(deg, itv_vertex, itv_lens)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    if row_ptr[-1] != ne:
        # a mis-parse (e.g. an oversized segment spilling over its
        # statically-strided slot) surfaces here; host decode handles it
        raise ValueError(
            f"device CGR decode: stream parse mismatch "
            f"({row_ptr[-1]} != {ne} edges — oversized segment?)")
    # residual slots interleave with interval ids per row: each row is
    # [residuals (sorted)][interval ids (sorted)], merged by the final
    # lexicographic sort in cgr_device_run
    res_start = np.concatenate([[0], np.cumsum(nres)[:-1]])
    gidx = np.cumsum(counts) - counts       # global residual index
    base = (row_ptr[lane_v] + (gidx - res_start[lane_v])).astype(np.int32)

    # count-bucketed residual scans (pow2 trip grid; lane counts padded
    # to a pow2 so compile shapes stay bounded across graphs). The
    # merged last segment can hold up to ~2*seg_len/3 codes, so the
    # grid must reach past seg_len/3 — cap at 2*seg_len.
    order = np.argsort(counts, kind="stable")
    sorted_counts = counts[order]
    trips = [t for t in (8, 32, 128, 512, 2048, 8192) if t <= 2 * seg_len]
    if not trips:
        raise ValueError("device CGR decode: res_seg_len too small for "
                         "the trip grid")
    buckets = []
    lo = 0
    for trip in trips:
        hi = np.searchsorted(sorted_counts, trip, side="right")
        sel = order[lo:hi]
        sel = sel[counts[sel] > 0]
        lo = hi
        if len(sel) == 0:
            continue
        n_pad = _pow2_pad(len(sel))
        padder = np.zeros(n_pad - len(sel), np.int32)
        buckets.append({
            "trip": trip, "sel": sel,
            "data_p": jnp.asarray(np.concatenate([data_p[sel], padder])),
            "counts": jnp.asarray(np.concatenate(
                [counts[sel].astype(np.int32), padder])),
            "lane_v": jnp.asarray(np.concatenate([lane_v[sel], padder])),
            "base": jnp.asarray(np.concatenate([base[sel], padder])),
        })
    if not (lo == L or sorted_counts[lo] <= trips[-1]):
        raise ValueError("device CGR decode: count exceeds trip grid")

    prep = {"empty": False, "cfg": cfg, "nv": nv, "ne": ne,
            "quads": quads, "buckets": buckets, "row_ptr": row_ptr,
            "data_p": data_p, "seg_start": seg_start, "lane_k": lane_k,
            "nsegs": nsegs, "lane_v": lane_v, "seg_len": seg_len,
            "n_itv": n_itv}
    if n_itv:
        # per-interval id/slot bases (host, small: one entry per
        # interval, not per edge)
        id_base = (np.cumsum(itv_lens) - itv_lens)      # global id index
        itv_start_of_v = np.zeros(nv, np.int64)         # first id index
        np.add.at(itv_start_of_v, itv_vertex, itv_lens)
        itv_start_of_v = np.concatenate(
            [[0], np.cumsum(itv_start_of_v)[:-1]])
        slot_base = (row_ptr[itv_vertex] + nres[itv_vertex]
                     + (id_base - itv_start_of_v[itv_vertex]))
        prep.update({
            "left_all": left_all,
            "id_base": jnp.asarray(id_base.astype(np.int32)),
            "slot_base": jnp.asarray(slot_base.astype(np.int32)),
            "n_total": int(itv_lens.sum()),
            "row_starts": jnp.asarray(row_ptr[1:-1].astype(np.int32)),
        })
    return prep


def cgr_device_run(prep: dict, validate: bool = True):
    """Decode-proper given a prep dict: the bucketed residual scans +
    interval expansion + per-row merge — pure device work (plus the
    parse-validation fetches when ``validate``). Returns (row_ptr host
    int64 array, col_idx DEVICE array)."""
    if prep["empty"]:
        return np.zeros(prep["nv"] + 1, np.int64), jnp.zeros((0,), jnp.int32)
    cfg, ne = prep["cfg"], prep["ne"]
    quads = prep["quads"]
    col = jnp.zeros((ne,), jnp.int32)
    pfin = prep["data_p"].copy() if validate else None
    for bk in prep["buckets"]:
        col, pf = _residual_pass(quads, bk["data_p"], bk["counts"],
                                 bk["lane_v"], bk["base"], col,
                                 cfg.zeta_k, bk["trip"], ne)
        if validate:
            # zero-count lanes end after gamma(0): pfin starts as data_p
            pfin[bk["sel"]] = np.asarray(pf)[:len(bk["sel"])]
    if validate:
        _check_closed_segments_fit(pfin, prep["seg_start"], prep["lane_k"],
                                   prep["nsegs"], prep["lane_v"],
                                   prep["seg_len"], "residual")
    if prep["n_itv"]:
        col = _expand_intervals(col, prep["left_all"], prep["id_base"],
                                prep["slot_base"], prep["n_total"])
        # merge sorted residuals with sorted interval runs per row:
        # one lexicographic (row, value) sort over the edge array
        src = jnp.zeros((ne,), jnp.int32).at[prep["row_starts"]].add(
            1, mode="drop").cumsum()
        _, col = jax.lax.sort((src, col), num_keys=2)
    return prep["row_ptr"], col


def cgr_decode_device(cg) -> CSRGraph:
    """Decode a CompressedGraph (CGR scheme) on device.

    Degrees are DERIVED from the per-segment counts — no side file
    needed. Two small host syncs happen at load time (per-vertex segment
    counts, then per-segment residual counts) so the residual scans can
    be BUCKETED by count like the ELL SpMM: without bucketing the scan
    length is the global max count and >10x of the work is padding
    Raises ValueError
    for stream shapes the device path cannot address (interval coding,
    tiny segments); callers fall back to the host decoder, mirroring the
    reference's CPU decode path. Split as prep (metadata, host syncs) +
    run (device decode) so the decode-proper is separately timeable."""
    prep = cgr_device_prep(cg)
    row_ptr, col = cgr_device_run(prep)
    return CSRGraph(row_ptr=row_ptr,
                    col_idx=np.asarray(col, dtype=np.int32))


def _decode_interval_sections(cg, pairs, quads, bit_off):
    """Phases 1-2 for interval streams: per-vertex interval headers,
    then (count pass + bucketed 2-gamma scans) over (vertex, interval-
    segment) lanes. Returns the residual-section header-derived
    (nsegs, segs_base) — read at each vertex's post-interval bit
    position — plus the decoded intervals (vertex, left, len)."""
    cfg = cg.cfg
    nv = cg.nv
    # the interval-section header has the same (optional degree gamma,
    # gamma(nsegs-1)) shape as the residual header, so _headers serves
    # both; vertices with nsegs==0 never contribute lanes, so their
    # base is never read
    itv_nsegs_d, itv_base_d = _headers(pairs, bit_off, cfg.add_degree)
    itv_nsegs = np.asarray(itv_nsegs_d).astype(np.int64)
    itv_base = np.asarray(itv_base_d)

    ilane_v = np.repeat(np.arange(nv, dtype=np.int32), itv_nsegs)
    istarts = np.concatenate([[0], np.cumsum(itv_nsegs)[:-1]])
    ilane_k = (np.arange(len(ilane_v), dtype=np.int64)
               - istarts[ilane_v]).astype(np.int32)
    iseg_start = itv_base[ilane_v] + ilane_k * cfg.itv_seg_len
    Li = len(ilane_v)
    if Li == 0:
        # no vertex has any section (add_degree stream, all degrees 0)
        return (np.zeros(nv, np.int64), np.zeros(nv, np.int64),
                np.zeros(0, np.int32), jnp.zeros((0,), jnp.int32),
                np.zeros(0, np.int64), 0)
    icnt_d, _ = _counts(pairs, jnp.asarray(iseg_start),
                        jnp.ones(Li, bool))
    icnt = np.asarray(icnt_d).astype(np.int64)
    n_itv = int(icnt.sum())

    idata_p = (iseg_start + _gamma_len_np(icnt)).astype(np.int32)
    ibase = (np.cumsum(icnt) - icnt).astype(np.int32)
    left_all = jnp.zeros((n_itv,), jnp.int32)
    len_all = jnp.zeros((n_itv,), jnp.int32)
    # lanes with zero intervals end right after their gamma(0) count
    pfin = idata_p.copy()

    order = np.argsort(icnt, kind="stable")
    sorted_icnt = icnt[order]
    itrips = [t for t in (2, 8, 32, 128, 512, 2048)
              if t <= 2 * cfg.itv_seg_len]
    if not itrips:
        raise ValueError("device CGR decode: itv_seg_len too small for "
                         "the trip grid")
    lo = 0
    for trip in itrips:
        hi = np.searchsorted(sorted_icnt, trip, side="right")
        sel = order[lo:hi]
        sel = sel[icnt[sel] > 0]
        lo = hi
        if len(sel) == 0:
            continue
        n_pad = _pow2_pad(len(sel))
        padder = np.zeros(n_pad - len(sel), np.int32)
        left_all, len_all, pf = _interval_pass(
            quads,
            jnp.asarray(np.concatenate([idata_p[sel], padder])),
            jnp.asarray(np.concatenate([icnt[sel].astype(np.int32), padder])),
            jnp.asarray(np.concatenate([ilane_v[sel], padder])),
            jnp.asarray(np.concatenate([ibase[sel], padder])),
            left_all, len_all, cfg.min_itv_len, trip, n_itv)
        pfin[sel] = np.asarray(pf)[:len(sel)]
    if not (lo == Li or sorted_icnt[lo] <= itrips[-1]):
        raise ValueError("device CGR decode: interval count exceeds grid")
    _check_closed_segments_fit(pfin, iseg_start, ilane_k, itv_nsegs,
                               ilane_v, cfg.itv_seg_len, "interval")

    # the residual-section header sits where the LAST (unpadded)
    # interval segment ended; vertices with no interval section
    # (add_degree streams with degree 0) have no residual section either
    last_lane = np.clip(istarts + itv_nsegs - 1, 0, None)
    res_pos = np.where(itv_nsegs > 0, pfin[last_lane], 0).astype(np.int32)
    ns_d, sb_d = _headers(pairs, jnp.asarray(res_pos), False)
    nsegs = np.where(itv_nsegs > 0,
                     np.asarray(ns_d).astype(np.int64), 0)
    segs_base = np.asarray(sb_d)

    itv_vertex = np.repeat(ilane_v, icnt)
    itv_lens = np.asarray(len_all).astype(np.int64)
    return nsegs, segs_base, itv_vertex, left_all, itv_lens, n_itv
