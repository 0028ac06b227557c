"""On-device StreamVByte adjacency decoding.

The reference decodes compressed adjacency *inside* GPU kernels
(src/structure/vbyte_decoder.cuh, cgr_decoder.cuh, used by
tc_gpu_compressed.cu / bfs_main.cu) so traversal runs straight off the
compressed graph. The equivalent here decodes the whole compressed
edge stream to CSR **on device** with pure vectorized ops — every step is
a gather or a (segmented) cumulative sum over static shapes, so XLA
compiles it to a handful of streaming kernels with no scalar loop:

  1. per-edge slot -> owning vertex: searchsorted over row_ptr
  2. 2-bit length code: one byte gather from the key region
  3. per-value byte offset: global cumsum of lengths minus the segment
     base (int32 wraparound-safe: only in-segment differences are used)
  4. value: gather 4 bytes, mask by length, little-endian combine
  5. delta-1 undo: segmented inclusive cumsum of the decoded gaps

StreamVByte's split key/data streams make step 2 addressable without
decoding prior values, so it decodes flat (above). VarintGB interleaves
tag bytes with data (tag position depends on all previous group
lengths), so it decodes with the CGR decoder's lane-per-vertex scan
architecture instead (``varintgb_decode_device`` below); CGR itself is
bit-granular and lives in compress/cgr_device.py. Hybrid streams
compose the two (``decode_hybrid_device``). Host/native codecs
(compress/vbyte.py, compress/cgr.py) remain the fallback past the
device decoders' size limits.

Degrees come from ``.degree.bin`` (written by the compressor, as in the
reference's Compressor::write_degrees), so the in-stream count word is
skipped rather than parsed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.compress.cgr_device import _pow2_pad
from graphaibench_tpu.compress.vbyte import VbyteGraph
from graphaibench_tpu.graph.csr import CSRGraph


@functools.partial(jax.jit, static_argnames=("nv", "ne", "count_word"))
def streamvbyte_decode_device(words: jnp.ndarray, word_offsets: jnp.ndarray,
                              degrees: jnp.ndarray, *, nv: int, ne: int,
                              count_word: bool = True):
    """Decode all adjacency lists of a StreamVByte-compressed graph.

    words: (W+2,) uint32 packed stream (little-endian word view, padded
    with 2 guard words); word_offsets: (nv+1,) int32 per-vertex word
    offsets; degrees: (nv,) int32. Returns (row_ptr (nv+1,), col_idx
    (ne,)) int32 device arrays.

    Design notes (chosen on another chip; not yet measured on the
    H100): segment ids and all per-vertex->per-edge broadcasts use
    scatter+cumsum, never gathers or a searchsorted; per-vertex fields
    travel in ONE packed row gather instead of one gather per field;
    stream reads are word/word-pair gathers + shifts, not byte-granular
    gathers.
    """
    degrees = degrees.astype(jnp.int32)
    row_ptr = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(degrees, dtype=jnp.int32)])
    if ne == 0:
        return row_ptr, jnp.zeros(0, jnp.int32)
    # per-vertex byte base: word offsets (x4) for whole-graph streams,
    # raw BYTE offsets for hybrid sub-streams (count_word=False there —
    # hybrid vbyte chunks carry no leading count word, hybrid.py:56)
    scale = 4 if count_word else 1
    base = word_offsets[:nv].astype(jnp.int32) * scale

    e = jnp.arange(ne, dtype=jnp.int32)
    # segment ids: +1 at each vertex's first edge slot, then prefix-sum
    # (duplicate row_ptr values from empty vertices accumulate correctly)
    bump = jnp.zeros(ne, jnp.int32).at[row_ptr[1:nv]].add(
        1, mode="drop", indices_are_sorted=True)
    v = jnp.cumsum(bump, dtype=jnp.int32)

    # per-vertex values are packed into one matrix and fetched with a
    # single row gather per edge instead of one gather per field
    key0 = base + (4 if count_word else 0)
    pervertex = jnp.stack(
        [row_ptr[:nv],                             # first edge slot
         key0,                                     # key region start
         key0 + ((degrees + 3) >> 2)],             # data region start
        axis=1)
    pv = pervertex[v]                              # (ne, 3)
    seg_first, key_start, data_start = pv[:, 0], pv[:, 1], pv[:, 2]
    i = e - seg_first

    # 2-bit byte-length codes from the key region (word read + shift,
    # not a byte-granular gather)
    ka = key_start + (i >> 2)
    kw = words[ka >> 2].astype(jnp.uint32)
    key_byte = ((kw >> ((ka & 3) * 8).astype(jnp.uint32)) & 0xFF).astype(jnp.int32)
    code = (key_byte >> ((i & 3) * 2)) & 3
    length = code + 1

    # byte offset of each value: data region start + in-segment exclusive
    # prefix of lengths (int32 cumsum; differences are wraparound-exact).
    # The per-segment base comes from an nv-sized gather, re-broadcast
    # through the same row-gather trick via cumsum bookkeeping.
    cl = jnp.cumsum(length, dtype=jnp.int32)
    excl = cl - length

    def broadcast_segment_value(vals_at_starts):
        """Per-vertex scalar -> per-edge broadcast WITHOUT a (ne,) gather:
        scatter the per-segment deltas at the segment-start slots and
        prefix-sum (a cumsum is ~3x cheaper than a gather here)."""
        deltas = jnp.diff(vals_at_starts, prepend=vals_at_starts[:1])
        deltas = deltas.at[0].set(vals_at_starts[0])
        carry = jnp.zeros(ne, jnp.int32).at[row_ptr[:nv]].add(
            deltas, mode="drop", indices_are_sorted=True)
        return jnp.cumsum(carry, dtype=jnp.int32)

    start_slots = jnp.clip(row_ptr[:nv], 0, max(ne - 1, 0))
    o = data_start + excl - broadcast_segment_value(excl[start_slots])

    # unaligned 4-byte read: one row gather from the word-pair view,
    # then shift/mask down to `length` bytes
    pairs = jnp.stack([words[:-1], words[1:]], axis=1)  # (W+1, 2)
    pw = pairs[o >> 2]                                  # (ne, 2)
    w0, w1 = pw[:, 0].astype(jnp.uint32), pw[:, 1].astype(jnp.uint32)
    sh = ((o & 3) * 8).astype(jnp.uint32)
    raw = jnp.where(sh == 0, w0, (w0 >> sh) | (w1 << (32 - sh)))
    keep_bits = (code.astype(jnp.uint32) + 1) * 8
    mask = jnp.where(code == 3, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << keep_bits) - 1)
    gaps = (raw & mask).astype(jnp.int32)

    # delta-1 undo: in-segment inclusive cumsum of gaps
    cv = jnp.cumsum(gaps, dtype=jnp.int32)
    col_idx = cv - broadcast_segment_value((cv - gaps)[start_slots])
    return row_ptr, col_idx


def decode_graph_device(vg: VbyteGraph) -> CSRGraph:
    """Host wrapper: ship the compressed stream to the device, decode
    there, return a CSRGraph (for feeding the analytics solvers)."""
    if vg.scheme == "varintgb":
        return varintgb_decode_device(vg)
    if vg.scheme != "streamvbyte":
        raise ValueError(
            f"device decode supports streamvbyte/varintgb, not "
            f"{vg.scheme!r} (CGR goes through compress.cgr_device)")
    pad = (-len(vg.data)) % 4 + 8  # word-align + 2 guard words
    words = jnp.asarray(
        np.frombuffer(vg.data + b"\x00" * pad, dtype=np.uint32))
    woff = jnp.asarray(vg.offsets.astype(np.int32))
    deg = jnp.asarray(vg.degrees.astype(np.int32))
    row_ptr, col_idx = streamvbyte_decode_device(
        words, woff, deg, nv=vg.nv, ne=vg.ne)
    return CSRGraph(row_ptr=np.asarray(row_ptr, dtype=np.int64),
                    col_idx=np.asarray(col_idx, dtype=np.int32))


# ---------------------------------------------------------------------------
# VarintGB: two-phase decode — tag-position chain, then FLAT values.
# ---------------------------------------------------------------------------
#
# Unlike StreamVByte's split key/data regions, a VarintGB group's tag
# byte sits at a position that depends on every previous group's size
# (vbyte_encoder.cc group layout), so the VALUE decode cannot be flat
# until every group's tag position is known. Running the whole decode
# as a one-group-per-step lane scan was far behind StreamVByte on a
# near-identical byte format, because each scan step paid 5 dependent
# in-window reads for 4 values.
#
# This formulation: only the POSITION CHAIN is serial, and a group's
# byte length is a pure function of its tag byte (glen = 5 + sum of the
# four 2-bit codes), so phase 1 walks tags only: one 2x128-byte block
# row gather per step covers >= 7 worst-case groups, each advanced by a
# 256-entry LUT lookup — ~7 groups per gather instead of 1 group per
# 5 reads. Phase 2 then decodes all values FLAT over groups (the
# SVB-style word-pair gather + shift/mask), with the per-vertex delta
# bases broadcast by scatter-delta + cumsum exactly like
# streamvbyte_decode_device.


# groups materially advanced per 512-byte double-block window: the
# window guarantees >= 257 usable bytes from any in-block start and a
# worst-case group is 17 bytes; a 128-word row still gathers at the
# full row rate (the 512 B fast-window limit)
_VGB_SUBS = 15

# outer-trip bucket grid; max decodable degree is
# 4 * _VGB_SUBS * _VGB_TRIP_GRID[-1]
_VGB_TRIP_GRID = (1, 4, 16, 64, 256, 1024, 4096)

# glen LUT: a group's byte length from its tag alone — 1 tag byte +
# sum of the four (code+1) value lengths
_VGB_GLEN = np.array(
    [5 + sum((t >> (2 * k)) & 3 for k in range(4)) for t in range(256)],
    dtype=np.int32)


@functools.partial(jax.jit, static_argnames=("trip",),
                   donate_argnames=("tagpos",))
def _vgb_tag_chain(blocks, lut, pos, n_groups, gbase, tagpos, trip: int):
    """Phase 1: walk each lane's group chain, recording every group's
    absolute tag-byte position into the flat (G+1,) buffer. One
    (L, 64)-word double-block row gather advances _VGB_SUBS groups —
    each sub-step is one in-row byte pick + one 256-entry LUT lookup.
    Positions accumulate as scan OUTPUTS and scatter once at the end,
    not once per sub-step (7 scatters/step)."""
    g_cap = tagpos.shape[0] - 1

    def step(carry, _):
        p, gi = carry
        blk = p >> 8                                   # 256-byte blocks
        row = jnp.concatenate([blocks[blk], blocks[blk + 1]],
                              axis=1)                  # (L, 128) words
        rel = p & 255
        out = []
        for s in range(_VGB_SUBS):
            active = gi + s < n_groups
            out.append(p)
            j = (rel >> 2).astype(jnp.int32)
            w = jnp.take_along_axis(row, j[:, None], axis=1)[:, 0]
            tag = ((w.astype(jnp.uint32)
                    >> ((rel & 3) * 8).astype(jnp.uint32))
                   & 0xFF).astype(jnp.int32)
            glen = lut[tag]
            p = jnp.where(active, p + glen, p)
            rel = jnp.where(active, rel + glen, rel)
        return (p, gi + _VGB_SUBS), jnp.stack(out, axis=1)  # (L, SUBS)

    (_, _), ps = jax.lax.scan(
        step, (pos, jnp.zeros_like(pos)), None, length=trip)
    # ps: (trip, L, SUBS) -> group index t*SUBS + s for lane l
    t = jnp.arange(trip, dtype=jnp.int32)[:, None, None]
    s = jnp.arange(_VGB_SUBS, dtype=jnp.int32)[None, None, :]
    gi = t * _VGB_SUBS + s
    slots = jnp.where(gi < n_groups[None, :, None],
                      gbase[None, :, None] + gi, g_cap)
    return tagpos.at[slots].set(ps, mode="drop")


@functools.partial(jax.jit, static_argnames=("nv", "ne", "n_g"))
def _vgb_flat_values(words, tagpos, group_ptr, row_ptr, degrees, *,
                     nv: int, ne: int, n_g: int):
    """Phase 2: decode all groups FLAT given their tag positions —
    the SVB formulation over groups instead of single values."""
    e1 = max(n_g, 1)
    gidx = jnp.arange(e1, dtype=jnp.int32)
    # group -> owning vertex (bump + prefix sum, never a searchsorted)
    bump = jnp.zeros(e1, jnp.int32).at[group_ptr[1:nv]].add(
        1, mode="drop", indices_are_sorted=True)
    v = jnp.cumsum(bump, dtype=jnp.int32)
    # per-vertex fields in ONE packed row gather
    pervertex = jnp.stack(
        [group_ptr[:nv], row_ptr[:nv], degrees.astype(jnp.int32)], axis=1)
    pv = pervertex[v]                                  # (G, 3)
    g_first, slot_base, degv = pv[:, 0], pv[:, 1], pv[:, 2]

    pairs = jnp.stack([words[:-1], words[1:]], axis=1)  # (W+1, 2)

    def read32(o):
        pw = pairs[o >> 2]
        w0 = pw[:, 0].astype(jnp.uint32)
        w1 = pw[:, 1].astype(jnp.uint32)
        sh = ((o & 3) * 8).astype(jnp.uint32)
        return jnp.where(sh == 0, w0, (w0 >> sh) | (w1 << (32 - sh)))

    tp = tagpos[:e1]
    tag = (read32(tp) & 0xFF).astype(jnp.int32)
    gaps, o = [], tp + 1
    for lane in range(4):
        code = (tag >> (2 * lane)) & 3
        raw = read32(o)
        keep = ((code + 1) * 8).astype(jnp.uint32)
        mask = jnp.where(code == 3, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << keep) - 1)
        gaps.append((raw & mask).astype(jnp.int32))
        o = o + code + 1
    gmat = jnp.stack(gaps, axis=1)                     # (G, 4)
    within = jnp.cumsum(gmat, axis=1)                  # in-group prefix
    # cross-group prefix within each vertex: cumsum of group sums minus
    # the segment base, broadcast via scatter-delta + cumsum
    # (int32 wraparound-exact; the SVB kernel's trick)
    gsum = within[:, 3]
    cg = jnp.cumsum(gsum, dtype=jnp.int32)
    excl = cg - gsum
    start_slots = jnp.clip(group_ptr[:nv], 0, max(n_g - 1, 0))
    seg_excl = excl[start_slots]
    deltas = jnp.diff(seg_excl, prepend=seg_excl[:1])
    deltas = deltas.at[0].set(seg_excl[0])
    carry = jnp.zeros(e1, jnp.int32).at[group_ptr[:nv]].add(
        deltas, mode="drop", indices_are_sorted=True)
    base = excl - jnp.cumsum(carry, dtype=jnp.int32)
    abs_vals = base[:, None] + within                  # (G, 4)
    # scatter into CSR slots; lanes past the degree drop
    k = ((gidx - g_first)[:, None] * 4
         + jnp.arange(4, dtype=jnp.int32)[None, :])
    slots = jnp.where(k < degv[:, None], slot_base[:, None] + k, ne)
    col = jnp.zeros((max(ne, 1) + 1,), jnp.int32)
    col = col.at[slots].set(abs_vals, mode="drop")
    return col[:ne]


def varintgb_device_prep(vg: VbyteGraph) -> dict:
    """Metadata phase of the device VarintGB decode (stream upload +
    host-derived lane/bucket tables, device-put once); feeds
    ``varintgb_device_run`` with no further host work so the
    decode-proper is separately timeable (decode_bench
    --device-resident). Raises ValueError when a vertex's group count
    exceeds the trip grid (callers fall back to the host decoder)."""
    if vg.scheme != "varintgb":
        raise ValueError(f"expected varintgb, got {vg.scheme!r}")
    nv, ne = vg.nv, vg.ne
    deg = np.asarray(vg.degrees, dtype=np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    assert row_ptr[-1] == ne, (row_ptr[-1], ne)

    # pad to whole 256-byte blocks + two guard blocks (the tag chain's
    # double-block window and the flat pass's word-pair reads)
    pad = (-len(vg.data)) % 256 + 512
    if len(vg.data) + pad >= 2**31:
        # byte positions are int32 inside the jitted pass (cgr_device
        # asserts the same bound for bit positions); raise ValueError so
        # analytics falls back to the host decoder instead of wrapping
        raise ValueError("device varintgb decode: stream too large for "
                         "int32 byte positions")
    raw = vg.data + b"\x00" * pad
    words = jnp.asarray(np.frombuffer(raw, dtype=np.uint32))
    blocks = words.reshape(-1, 64)                 # 256-byte rows

    n_groups = -(-deg // 4)
    group_ptr = np.concatenate([[0], np.cumsum(n_groups)])
    n_g = int(group_ptr[-1])
    # outer trips advance _VGB_SUBS groups each
    trips_needed = -(-n_groups // _VGB_SUBS)
    grid = _VGB_TRIP_GRID
    if trips_needed.max(initial=0) > grid[-1]:
        raise ValueError("device varintgb decode: degree exceeds the "
                         f"trip grid ({4 * _VGB_SUBS * grid[-1]})")
    lanes = np.nonzero(deg > 0)[0]
    buckets = []
    if len(lanes):
        # +4 skips the per-vertex count word (offsets count words)
        pos = (np.asarray(vg.offsets, dtype=np.int64)[lanes] * 4 + 4)
        if not pos.max(initial=0) + 20 < len(vg.data) + pad:
            raise ValueError("device varintgb decode: offsets point past "
                             "the padded stream")
        pos = pos.astype(np.int32)
        ngl = n_groups[lanes].astype(np.int32)
        gbase = group_ptr[lanes].astype(np.int32)
        order = np.argsort(trips_needed[lanes], kind="stable")
        sg = trips_needed[lanes][order]
        lo = 0
        for trip in grid:
            hi = np.searchsorted(sg, trip, side="right")
            sel = order[lo:hi]
            lo = hi
            if len(sel) == 0:
                continue
            n_pad = _pow2_pad(len(sel))
            pd = np.zeros(n_pad - len(sel), np.int32)
            buckets.append({
                "trip": trip,
                "pos": jnp.asarray(np.concatenate([pos[sel], pd])),
                "ngl": jnp.asarray(np.concatenate([ngl[sel], pd])),
                "gbase": jnp.asarray(np.concatenate([gbase[sel], pd])),
            })
        if lo != len(lanes):
            raise ValueError("device varintgb decode: lanes exceed the "
                             "trip grid")
    return {"blocks": blocks, "words": words, "buckets": buckets,
            "row_ptr": row_ptr, "ne": ne, "nv": nv, "n_g": n_g,
            "lut": jnp.asarray(_VGB_GLEN),
            "group_ptr_d": jnp.asarray(group_ptr.astype(np.int32)),
            "row_ptr_d": jnp.asarray(row_ptr.astype(np.int32)),
            "deg_d": jnp.asarray(deg.astype(np.int32))}


def varintgb_device_run(prep: dict) -> jnp.ndarray:
    """Decode-proper given a prep dict: the tag-position chain passes
    then one flat value pass, pure device work. Returns the (ne,)
    col_idx DEVICE array."""
    ne, nv, n_g = prep["ne"], prep["nv"], prep["n_g"]
    tagpos = jnp.zeros((max(n_g, 1) + 1,), jnp.int32)
    for bk in prep["buckets"]:
        tagpos = _vgb_tag_chain(prep["blocks"], prep["lut"], bk["pos"],
                                bk["ngl"], bk["gbase"], tagpos, bk["trip"])
    return _vgb_flat_values(prep["words"], tagpos, prep["group_ptr_d"],
                            prep["row_ptr_d"], prep["deg_d"],
                            nv=nv, ne=ne, n_g=n_g)


def varintgb_decode_device(vg: VbyteGraph) -> CSRGraph:
    """Decode a VarintGB-compressed graph on device (prep + run)."""
    prep = varintgb_device_prep(vg)
    col = varintgb_device_run(prep)
    return CSRGraph(row_ptr=prep["row_ptr"],
                    col_idx=np.asarray(col, dtype=np.int32))


def decode_hybrid_device(hg) -> CSRGraph:
    """Device decode of a hybrid-compressed graph (hybrid.py layout):
    low-degree vertices are unsegmented zeta streams with a gamma degree
    prefix (decoded by the CGR residual scans, one lane per vertex —
    degree < threshold bounds the trip count), high-degree vertices are
    count-word-free StreamVByte chunks (decoded by the vectorized SVB
    kernel over the subset). Composes the two device decoders over two
    word views of the same byte stream."""
    import jax

    from graphaibench_tpu.compress import cgr_device as CD

    if hg.vbyte_scheme != "streamvbyte":
        raise ValueError("device hybrid decode supports streamvbyte "
                         f"chunks only, not {hg.vbyte_scheme!r}")
    nv, ne = hg.nv, hg.ne
    deg = np.asarray(hg.degrees, dtype=np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    assert row_ptr[-1] == ne, (row_ptr[-1], ne)
    off = np.asarray(hg.offsets, dtype=np.int64)  # BYTE offsets
    if not off[-1] * 8 < 2**31:
        raise ValueError("device hybrid decode: stream too large for "
                         "int32 bit positions")

    pad = (-len(hg.data)) % 4 + 16
    raw = hg.data + b"\x00" * pad
    words_be = jnp.asarray(np.frombuffer(raw, dtype=">u4").astype(np.uint32))
    quads = CD._quads(words_be)
    col = jnp.zeros((max(ne, 1),), jnp.int32)

    low = np.nonzero((deg > 0) & (deg < hg.threshold))[0]
    if len(low):
        counts = deg[low]
        data_p = (off[low] * 8 + CD._gamma_len_np(counts)).astype(np.int32)
        base = row_ptr[low].astype(np.int32)
        lane_v = low.astype(np.int32)
        order = np.argsort(counts, kind="stable")
        sc = counts[order]
        grid = (8, 32, 128, 512, 2048)
        trips = [t for t in grid if t < 4 * max(hg.threshold, 2)]
        # the 4x-threshold cap is a compile-size heuristic; it must never
        # leave max low degree (threshold-1) uncovered — e.g. threshold=2
        # used to yield an empty grid and fail the lane-coverage assert
        while len(trips) < len(grid) and (
                not trips or trips[-1] < hg.threshold - 1):
            trips.append(grid[len(trips)])
        lo = 0
        for trip in trips:
            hi = np.searchsorted(sc, trip, side="right")
            sel = order[lo:hi]
            lo = hi
            if len(sel) == 0:
                continue
            n_pad = CD._pow2_pad(len(sel))
            pd = np.zeros(n_pad - len(sel), np.int32)
            col, _ = CD._residual_pass(
                quads,
                jnp.asarray(np.concatenate([data_p[sel], pd])),
                jnp.asarray(np.concatenate([counts[sel].astype(np.int32),
                                            pd])),
                jnp.asarray(np.concatenate([lane_v[sel], pd])),
                jnp.asarray(np.concatenate([base[sel], pd])),
                col, hg.zeta_k, trip, max(ne, 1))
        if lo != len(low):
            raise ValueError("device hybrid decode: degree exceeds the "
                             "hybrid trip grid")

    high = np.nonzero(deg >= hg.threshold)[0]
    if len(high):
        words_le = jnp.asarray(np.frombuffer(raw, dtype=np.uint32))
        ne_h = int(deg[high].sum())
        _rp, sub_col = streamvbyte_decode_device(
            words_le, jnp.asarray(off[high].astype(np.int32)),
            jnp.asarray(deg[high].astype(np.int32)),
            nv=len(high), ne=ne_h, count_word=False)
        lengths = deg[high]
        sub_starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        slots = (np.repeat(row_ptr[high] - sub_starts, lengths)
                 + np.arange(ne_h)).astype(np.int32)
        col = col.at[jnp.asarray(slots)].set(sub_col)

    return CSRGraph(row_ptr=row_ptr,
                    col_idx=np.asarray(col[:ne], dtype=np.int32))
