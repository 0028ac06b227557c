"""Lane-packed group reductions over flat ELL slot arrays.

This layout was chosen for a chip whose device memory tiles the two
minor dimensions to (8, 128), where a (R, 4) int32/f32 array occupies
(R, 128) — 32x the logical bytes — and the narrow ELL degree buckets
(width 4..64) ran out of memory stored as (rows, width) matrices. It
has not yet been measured on the H100, whose memory is not tiled that
way (ROADMAP design item 2 decides it from the ledger).

It has two halves:

  * STORAGE: ``EllBucket`` keeps its slot arrays FLAT (rows*width,) —
    a 1-D array needs no padding of a narrow minor dimension. Gathers
    index with the flat array and produce (rows*width, F) outputs
    whose minor dim is the feature chunk.
  * REDUCTION: collapsing each row's ``width`` consecutive slots back
    to one value happens here, via shapes whose minor dims stay wide:

      - ``group_reduce``: (R*W,) -> (R,) scalar reduction. The flat
        array is viewed as (n/128, 128) and log2(W) strided-lane
        halvings combine each W consecutive lanes. No (R, W) array
        ever materializes.
      - ``group_sum_cols``: (R*W, F) -> (R, F) weighted-sum collapse
        via a (R, W, F) view (free for W >= 8; one 2x-padded copy for
        W=4) and a tree of 3-D slice adds — slices, not a reduce op,
        because XLA materialized middle-dim reduces as a transposed
        copy with the W dim minormost, padded to the (8, 128) tile.

All widths the ELL packer emits are powers of two <= 128; other widths
take a fallback path (still correct, narrower guarantees).
"""

from __future__ import annotations

import jax.numpy as jnp

LANES = 128

_COMBINE = {
    "sum": lambda a, b: a + b,
    "max": jnp.maximum,
    "min": jnp.minimum,
}


def reduce_ident(kind: str, dtype):
    """Identity element of a reduction kind for ``dtype``."""
    if jnp.issubdtype(dtype, jnp.floating):
        return {"max": -jnp.inf, "min": jnp.inf, "sum": 0.0}[kind]
    info = jnp.iinfo(dtype)
    return {"max": info.min, "min": info.max, "sum": 0}[kind]


def _is_pow2(w: int) -> bool:
    return w > 0 and (w & (w - 1)) == 0


def group_reduce(flat: jnp.ndarray, width: int, kind: str) -> jnp.ndarray:
    """Reduce consecutive groups of ``width`` slots of a flat (R*W,)
    array to (R,) without materializing any narrow-minor-dim shape."""
    if width == 1:
        return flat
    n = flat.shape[0]
    rows = n // width
    assert rows * width == n, (n, width)
    op = _COMBINE[kind]
    if not _is_pow2(width) or width > LANES:
        # rare non-pow2 widths: unrolled 2-D column slices (no reduce op,
        # so no transposed W-minor copy; the (R, W) view pads W->128)
        v = flat.reshape(rows, width)
        out = v[:, 0]
        for k in range(1, width):
            out = op(out, v[:, k])
        return out
    ident = reduce_ident(kind, flat.dtype)
    pad = (-n) % LANES
    if pad:
        flat = jnp.concatenate(
            [flat, jnp.full((pad,), ident, flat.dtype)])
    a = flat.reshape(-1, LANES)
    w = width
    while w > 1:
        a = op(a[:, 0::2], a[:, 1::2])
        w //= 2
    return a.reshape(-1)[:rows]


def group_sum_cols(prod: jnp.ndarray, width: int) -> jnp.ndarray:
    """Sum consecutive groups of ``width`` rows of a (R*W, F) array to
    (R, F) via tree-halving slice adds on a (R, W, F) view."""
    if width == 1:
        return prod
    rw, f = prod.shape
    rows = rw // width
    a = prod.reshape(rows, width, f)
    w = width
    if not _is_pow2(w):
        out = a[:, 0, :]
        for k in range(1, w):
            out = out + a[:, k, :]
        return out
    while w > 1:
        half = w // 2
        a = a[:, :half, :] + a[:, half:w, :]
        w = half
    return a[:, 0, :]
