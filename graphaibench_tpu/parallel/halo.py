"""shard_map building blocks: halo exchange + sharded aggregation.

The communication pattern replacing NVSHMEM mid-kernel remote fetches
(bs_warp_vertex_nvshmem.cuh:30-34): between GNN layers each shard ships
its boundary vertex features to the peers that need them with ONE
``all_to_all`` over the mesh axis, then aggregates entirely
locally. Gradients of the exchange transpose automatically (all_to_all
is its own transpose up to permutation), so the same code path trains.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

AXIS = "graph"  # mesh axis name for graph (vertex) sharding


def halo_exchange(
    x_own: jnp.ndarray,      # (nv_pad, F) this shard's owned rows
    send_idx: jnp.ndarray,   # (P, s_max)
    halo_map: jnp.ndarray,   # (h_max,)
    *,
    axis: str = AXIS,
) -> jnp.ndarray:
    """Returns x_halo (h_max, F): the remote rows this shard reads."""
    send_buf = x_own[send_idx]                      # (P, s_max, F)
    recv = jax.lax.all_to_all(send_buf, axis, 0, 0)  # (P, s_max, F)
    flat = recv.reshape(-1, x_own.shape[1])          # (P*s_max, F)
    return flat[halo_map]


def sharded_spmm_local(
    edge_src: jnp.ndarray,   # (e_max,)
    col_idx: jnp.ndarray,    # (e_max,) extended-local
    w: jnp.ndarray,          # (e_max,)
    x_ext: jnp.ndarray,      # (nv_pad + h_max, F)
    nv_pad: int,
) -> jnp.ndarray:
    msgs = x_ext[col_idx] * w[:, None]
    return jax.ops.segment_sum(msgs, edge_src, num_segments=nv_pad)


def make_sharded_spmm(mesh: Mesh, sg, *, axis: str = AXIS,
                      use_ell: bool = True, overlap: bool = True):
    """Returns a jittable f(x_padded_global) -> aggregated rows, where
    x is row-sharded over the mesh axis. ``sg`` is a host ShardedGraph.
    Used directly for distributed analytics (e.g. PageRank) and the
    weak-scaling bench; the sharded GNN layers follow the same shape.

    By default aggregation runs on the pre-packed degree-bucketed ELL
    kernels with the own/halo overlap split (interior edges aggregate
    concurrently with the all_to_all — see shard_ell.build_shard_ell);
    ``use_ell=False`` keeps the gather+segment_sum formulation as the
    oracle, ``overlap=False`` the unified extended-table
    layout."""
    import numpy as np

    from graphaibench_tpu.parallel.shard_ell import (
        ShardEll,
        ShardPackedW,
        build_shard_ell,
        pack_shard_values,
        shard_specs,
        slot_spmm_packed,
        strip_shard,
    )

    nv_pad = sg.nv_pad
    empty_se, empty_wp = ShardEll((), ()), ShardPackedW((), ())
    ell = {"se": empty_se, "wp": empty_wp, "se_own": empty_se,
           "wp_own": empty_wp, "se_halo": empty_se, "wp_halo": empty_wp}
    if use_ell and overlap:
        se_own = build_shard_ell(sg, part="own", with_trans=False)
        se_halo = build_shard_ell(sg, part="halo", with_trans=False)
        ell.update(se_own=se_own,
                   wp_own=pack_shard_values(se_own, sg.edge_w),
                   se_halo=se_halo,
                   wp_halo=pack_shard_values(se_halo, sg.edge_w))
    elif use_ell:
        se = build_shard_ell(sg, with_trans=False)
        ell.update(se=se, wp=pack_shard_values(se, sg.edge_w))

    def local(x_own, ell, edge_src, col_idx, w, send_idx, halo_map):
        # shard_map gives per-shard blocks with a leading axis of 1
        x_own = x_own.reshape(nv_pad, -1)
        el = strip_shard(ell)
        x_halo = halo_exchange(x_own, send_idx[0], halo_map[0], axis=axis)
        if el["se_own"].fwd or el["se_halo"].fwd:
            out = slot_spmm_packed(nv_pad, el["se_own"], el["wp_own"], x_own)
            if el["se_halo"].fwd:
                out = out + slot_spmm_packed(nv_pad, el["se_halo"],
                                             el["wp_halo"], x_halo)
            return out
        x_ext = jnp.concatenate([x_own, x_halo], axis=0)
        if el["se"].fwd:
            return slot_spmm_packed(nv_pad, el["se"], el["wp"], x_ext)
        return sharded_spmm_local(edge_src[0], col_idx[0], w[0], x_ext,
                                  nv_pad)

    spec_v = P(axis, None)       # vertex-sharded rows
    spec_e = P(axis, None)       # per-shard edge arrays
    spec_s = P(axis, None, None)
    ell_spec = shard_specs(ell, axis)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_v, ell_spec, spec_e, spec_e, spec_e, spec_s, spec_e),
        out_specs=spec_v,
        check_vma=False,
    )

    # device-resident graph arrays are passed as jit ARGUMENTS, not
    # captured constants (which would be embedded in the program).
    # On the ELL paths the raw (P, e_max) edge arrays are never read by
    # the traced fn — ship 1-slot placeholders instead of edge-scale
    # arrays.
    ell_dev = jax.tree.map(jnp.asarray, ell)
    P_ = sg.num_shards
    if use_ell and (ell["se"].fwd or ell["se_own"].fwd
                    or ell["se_halo"].fwd):
        edge_src = jnp.zeros((P_, 1), jnp.int32)
        col_idx = jnp.zeros((P_, 1), jnp.int32)
        w = jnp.zeros((P_, 1), jnp.float32)
    else:
        edge_src = jnp.asarray(sg.edge_src)
        col_idx = jnp.asarray(sg.col_idx)
        w = jnp.asarray(sg.edge_w)
    send_idx = jnp.asarray(sg.send_idx)
    halo_map = jnp.asarray(sg.halo_map)
    fn_jit = jax.jit(fn)

    def spmm_fn(x_padded):
        return fn_jit(x_padded, ell_dev, edge_src, col_idx, w, send_idx,
                      halo_map)

    return spmm_fn
