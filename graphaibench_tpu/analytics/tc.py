"""Triangle counting: DAG orientation + per-edge sorted intersection.

The reference counts sum over DAG edges (u, v) of |N(u) ∩ N(v)| with
AVX/warp merge or galloping intersections (src/triangle/omp_base.cc:5-26,
intersect.cc, bs_warp_edge.cuh). This formulation packs the oriented
adjacency into a padded (nv, W) matrix and answers each edge's
intersection with a fused broadcast-compare-and-reduce — no
data-dependent control flow, no random access beyond the two row
gathers.

Performance structure (load balancing without warps):
  * degree-ordered DAG orientation bounds out-degree (~sqrt(m) on
    power-law graphs), so the packed matrix stays small;
  * edges are GROUPED BY the pow2 out-degree of their source, so each
    group's compare volume is W_src*W per edge instead of W*W — the dense
    analog of the reference's hybrid merge/galloping dispatch on degree
    skew (intersect.cc:6-80);
  * the packed matrix is passed as a jit argument (a closed-over
    constant would be embedded in every compiled program);
  * per-group totals are reduced on device, summed in Python ints to
    survive the billion-triangle goldens (src/triangle/README.md:50-63).

Considered and rejected on the chip this was tuned on (the reference's
skew-handling variants; not yet measured on the H100):
  * hashed/c-map probing (gpu_hindex.cu, include/cmap.cuh): one probe
    per dst-neighbor slot is a scalar random gather, which lost to fused
    compares even at the most skewed pairs, before hash-collision
    control flow is paid.
  * two-sided degree grouping (bounding the dst side to its own pow2
    class instead of the global W): compare volume shrinks only 1.62x
    (rmat17) / 1.37x (rmat19) — dst degrees are edge-weighted, so hubs
    dominate anyway — while distinct compiled shapes grow 5-7x (25-36
    vs 5-6), each its own compile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph import transforms as T
from graphaibench_tpu.graph.csr import CSRGraph


def _pack_padded(g: CSRGraph, sentinel: int):
    """(nv, W) neighbor matrix padded with ``sentinel`` (> any id)."""
    W = max(g.max_degree(), 1)
    deg = g.degrees()
    starts = g.row_ptr[:, None]
    offs = np.arange(W, dtype=np.int64)[None, :]
    in_row = offs < deg[:, None]
    pos = np.where(in_row, starts[: g.nv] + offs, 0)
    nbr = np.where(in_row, g.col_idx[pos], sentinel)
    return nbr.astype(np.int32), deg


@functools.partial(jax.jit, static_argnames=("wa",))
def _count_group(nbr, src_c, dst_c, valid_c, *, wa: int):
    """Sum over a chunk of DAG edges of |N(src) ∩ N(dst)|, where every
    src in the chunk has out-degree <= wa.

    Intersection by COMPARE-ALL: a broadcast equality (C, wa, W) reduced
    on the fly. On the chip this was tuned on, fused compares beat
    binary search by ~200x: take_along_axis random gathers cost ~wa
    scalar gathers per edge per step, while wa*W fused compares stream."""
    a = nbr[src_c][:, :wa]          # (C, wa) sorted, sentinel-padded
    b = nbr[dst_c]                  # (C, W)  sorted, sentinel-padded
    sent = nbr.shape[0]             # real ids are < nv; sentinel is not
    eq = (a[:, :, None] == b[:, None, :]) & (a < sent)[:, :, None]
    # per-chunk count <= C * wa < 2^31; the grand total accumulates in
    # Python ints on host (billion-triangle safe)
    return jnp.sum(eq & valid_c[:, None, None], dtype=jnp.int32)


# device-resident TC state per graph (the reference's analog: the graph
# is uploaded once per process, graph_gpu.h init). One entry only — TC
# is typically called repeatedly on one graph. The cached CSRGraph is
# held strongly and compared by identity: an id()-keyed cache would
# serve stale state when CPython reuses a freed object's address.
_TC_CACHE: dict = {}


def _tc_device_state(g: CSRGraph):
    if _TC_CACHE.get("graph") is g:
        return _TC_CACHE["state"]
    dag = T.orientation(g)
    sentinel = dag.nv + 1
    nbr_np, deg = _pack_padded(dag, sentinel)
    src_np, dst_np = dag.coo()
    W = nbr_np.shape[1]
    # group edges by pow2 out-degree of their source; merge tiny groups
    # up to width 8 (each distinct (P, wa) shape is a compile)
    src_deg = np.maximum(deg[src_np], 8)
    group = np.ceil(np.log2(src_deg)).astype(np.int64)
    order = np.argsort(group, kind="stable")
    gids, counts = np.unique(group, return_counts=True)
    state = (
        jnp.asarray(nbr_np),
        jnp.asarray(src_np[order]),
        jnp.asarray(dst_np[order]),
        gids.tolist(), counts.tolist(), W, dag.ne,
    )
    _TC_CACHE["graph"] = g
    _TC_CACHE["state"] = state
    return state


def triangle_count(g: CSRGraph, *, mem_budget: int = 2 << 30) -> int:
    """Exact triangle count of an undirected graph (golden values in
    src/triangle/README.md:50-63, e.g. citeseer = 1166).

    Edges are sorted by source-out-degree group on host and shipped to
    the device ONCE (cached across calls); per-group work then slices
    device-resident arrays instead of repeating host->device
    transfers. Group
    chunks are sized by a device-memory budget and padded to pow2 shapes
    to bound the number of compiles."""
    if g.ne == 0:
        return 0
    nbr, s_all, d_all, gids, counts, W, ne_dag = _tc_device_state(g)
    if ne_dag == 0:
        return 0
    total = 0
    offset = 0
    for gid, cnt in zip(gids, counts):
        wa = min(1 << int(gid), W)
        # bound both memory ((W+wa) int32 per edge) and the fused
        # compare volume (wa*W per edge) per call
        csize = max(1, min(int(mem_budget // ((W + wa) * 4)),
                           int(4e9 // (wa * W))))
        for lo in range(offset, offset + cnt, csize):
            hi = min(lo + csize, offset + cnt)
            n = hi - lo
            P = 1 << (n - 1).bit_length() if n > 1 else 1
            s_c = jnp.pad(s_all[lo:hi], (0, P - n))
            d_c = jnp.pad(d_all[lo:hi], (0, P - n))
            valid = jnp.arange(P, dtype=jnp.int32) < n
            total += int(_count_group(nbr, s_c, d_c, valid, wa=wa))
        offset += cnt
    return int(total)
