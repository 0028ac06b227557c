"""k-core decomposition.

Two formulations:

* ``k_core_hindex`` (default when the host CSR is available) — the
  h-index fixpoint (Lu et al. 2016): core_0 = deg, core_{t+1}[v] =
  min(core_t[v], H(core_t[N(v)])), which converges to the coreness with
  ALL levels peeling simultaneously: 18 sweeps at rmat14 and 32 at
  rmat17, vs the bulk-peel's ~1300 cascade sweeps at rmat19. Each sweep is one dense O(E)
  neighbor-core gather over a NO-SPLIT ELL layout (pow2 widths up to
  max degree: the h-index of a row is not decomposable over the split
  virtual rows the SpMM layout uses), a per-row descending sort, and
  h = #{i : sorted_i >= i+1}.

* ``k_core_peel`` — bulk peeling, the reference's shape
  (src/coreness/omp_base.cc:11-60): peel ALL deg<=k vertices per sweep,
  host-driven outer level loop (a fully-jitted nested while_loop packed
  hundreds of O(E) sweeps into one device call and tripped the
  runtime's watchdog). Kept for DeviceGraph-
  only callers and as the oracle cross-check.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.ops.device_graph import DeviceGraph, EllBucket
from graphaibench_tpu.ops.segment import neighbor_reduce


# ---------------------------------------------------------------------------
# h-index fixpoint
# ---------------------------------------------------------------------------


def _hindex_layout(g: CSRGraph) -> tuple:
    """NO-SPLIT degree-bucketed ELL: pow2 widths {4..max_degree}. Heavy
    rows stay whole (one row per vertex) because the per-row h-index
    needs the full neighbor multiset — unlike sum/max reductions it does
    not decompose over split virtual rows."""
    from graphaibench_tpu.ops.device_graph import _pack_rows

    deg = g.degrees().astype(np.int64)
    if g.nv == 0 or g.ne == 0:
        return ()
    maxdeg = int(deg.max())
    split = 4
    while split < maxdeg:
        split *= 2
    widths = [4]
    while widths[-1] < split:
        widths.append(widths[-1] * 2)
    return tuple(_pack_rows(np.arange(g.nv, dtype=np.int32),
                            g.row_ptr[:-1], deg, g.col_idx, None, g.ne,
                            widths, split))


def _row_hindex(vals: jnp.ndarray, w: int, dtype) -> jnp.ndarray:
    """Per-row h-index of a (r, W) clamped block.

    Default: in-register binary search on h (h in [0, W]): ~log2(W)+1
    compare+reduce passes over the gathered block, vs the bitonic
    sort's ~log^2(W) compare-exchange stages (GAB_KCORE_SORT=1 keeps
    the sort for A/Bs). cnt(>=t) is non-increasing in t, so
    h = max t with cnt(>=t) >= t binary-searches exactly."""
    import os

    if os.environ.get("GAB_KCORE_SORT", "") == "1":
        ladder = jnp.arange(1, w + 1, dtype=dtype)[None, :]
        sv = -jnp.sort(-vals, axis=1)         # descending
        return jnp.sum((sv >= ladder).astype(dtype), axis=1)
    lo = jnp.zeros((vals.shape[0],), dtype)
    hi = jnp.full((vals.shape[0],), w, dtype)
    steps = max(int(np.ceil(np.log2(w + 1))), 1)
    for _ in range(steps + 1):
        mid = (lo + hi + 1) >> 1
        cnt = jnp.sum((vals >= mid[:, None]).astype(dtype), axis=1)
        ok = cnt >= mid
        lo = jnp.where(ok, mid, lo)
        hi = jnp.where(ok, hi, mid - 1)
    return lo


@functools.partial(jax.jit, static_argnums=(2,))
def _hindex_sweep(core: jnp.ndarray, buckets: tuple, sentinel: int):
    """One fixpoint sweep: new[v] = min(core[v], H(core[N(v)]))."""
    from graphaibench_tpu.ops.spmm import bucket_row_chunks

    c2 = jnp.stack([core, core], axis=1)      # 2-col packed (see neighbor_reduce)
    new = core
    for b in buckets:
        w = b.width
        for clo, chi in bucket_row_chunks(b, 2):
            rows, nbr, eid = b.slot_slice(clo, chi)
            vals = c2[nbr][:, 0].reshape(-1, w)
            vals = jnp.where(eid.reshape(-1, w) == sentinel, 0, vals)
            # h <= row degree <= w: clamping keeps h exact and the
            # search range small
            vals = jnp.minimum(vals, w)
            h = _row_hindex(vals, w, core.dtype)
            # rows are unique (no splitting): min against current core
            new = new.at[rows].min(h)
    changed = jnp.sum((new != core).astype(jnp.int32))
    return new, changed


def k_core_hindex(g: CSRGraph, deg: Optional[jnp.ndarray] = None,
                  buckets: Optional[tuple] = None) -> jnp.ndarray:
    """Coreness via the h-index fixpoint (host CSR input; builds its own
    no-split layout unless ``buckets`` pre-built via _hindex_layout).
    Host-drives the iteration with one scalar sync per sweep."""
    if buckets is None:
        buckets = _hindex_layout(g)
    core = jnp.asarray(g.degrees().astype(np.int32)) if deg is None else deg
    if not buckets:
        return core
    while True:
        core, changed = _hindex_sweep(core, buckets, g.ne)
        if int(changed) == 0:
            return core


# ---------------------------------------------------------------------------
# bulk peeling (legacy / DeviceGraph-only path)
# ---------------------------------------------------------------------------


def _live_degrees(g: DeviceGraph, alive):
    if g.has_ell_layout:
        # deg[i] = alive[i] * sum_{j in N(i)} alive[j] as a dense
        # bucket reduce instead of the (ne,)-scatter-add
        nbr_alive = neighbor_reduce(g, alive.astype(jnp.int32), "sum")
        return jnp.where(alive, nbr_alive, 0)
    contrib = (alive[g.edge_src] & alive[g.col_idx]).astype(jnp.int32)
    return jax.ops.segment_sum(contrib, g.edge_src, num_segments=g.nv)


@functools.partial(jax.jit, static_argnums=())
def _peel_level(g: DeviceGraph, core, alive, deg, k):
    """Fixpoint at level k: repeatedly peel deg<=k vertices until no
    change. Returns (core, alive, deg, min-live-degree-or-intmax)."""

    def cond(s):
        return s[3]

    def body(s):
        core, alive, deg, _ = s
        peel = alive & (deg <= k)
        core = jnp.where(peel, k, core)
        alive2 = alive & ~peel
        deg2 = _live_degrees(g, alive2)
        return core, alive2, deg2, jnp.any(peel)

    core, alive, deg, _ = jax.lax.while_loop(
        cond, body, (core, alive, deg, jnp.bool_(True)))
    imax = jnp.iinfo(jnp.int32).max
    min_live = jnp.min(jnp.where(alive, deg, imax))
    return core, alive, deg, min_live


def k_core_peel(g: DeviceGraph) -> jnp.ndarray:
    """Bulk-peel coreness (matches transforms.k_core_decomposition)."""
    imax = jnp.iinfo(jnp.int32).max
    core = jnp.zeros(g.nv, jnp.int32)
    alive = jnp.ones(g.nv, bool)
    deg = _live_degrees(g, alive)
    k = 0
    while True:
        core, alive, deg, min_live = _peel_level(
            g, core, alive, deg, jnp.int32(k))
        nxt = int(min_live)          # host sync: ends the device call
        if nxt == imax:              # nothing alive
            return core
        k = max(k + 1, nxt)


def k_core(g: DeviceGraph, host: Optional[CSRGraph] = None) -> jnp.ndarray:
    """Coreness of every vertex (matches transforms.k_core_decomposition).
    With the host CSR available the h-index fixpoint runs (tens of
    sweeps); otherwise the bulk-peel host loop."""
    if host is not None:
        return k_core_hindex(host)
    return k_core_peel(g)
