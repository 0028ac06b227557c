"""Data-parallel GraphSAINT: P sampled subgraphs per optimizer step.

The reference pre-samples ``num_subgraphs = num_threads`` subgraphs in
an OMP-parallel loop and consumes them one epoch each
(src/gnn/net.cpp:159, 288-358). The idiomatic device
mapping is replica data parallelism over a 1-D device mesh: every
device trains on its own padded subgraph and the gradients are pmean'd
over the ``data`` axis — one step is a GraphSAINT minibatch of P
subgraphs (larger effective batch than the reference's sequential
consumption; documented, standard large-batch semantics).

Host sampling runs in a thread pool and is double-buffered behind the
device step, exactly like Model.train_sampled's single-replica path.
All subgraphs of a step share one (n_pad, e_pad) shape so the jitted
shard_map step compiles once; e_pad grows monotonically (rare
recompile) when a sample overflows it.
"""

from __future__ import annotations

import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphaibench_tpu.nn.layers import ModelConfig, apply_model
from graphaibench_tpu.ops import math as gmath
from graphaibench_tpu.ops.device_graph import DeviceGraph

DATA_AXIS = "data"


def make_dp_saint_step(cfg: ModelConfig, opt, mesh: Mesh, n_pad: int,
                       axis: str = DATA_AXIS):
    """The jitted DP step: each replica computes loss+grads on its own
    COO subgraph block (leading axis 1 under shard_map), gradients are
    pmean'd, and every replica applies the identical optimizer update,
    so parameters stay replicated. Loss is the pmean of per-subgraph
    losses (each scaled by its own 1/n_real — the reference's
    1/(end-begin) quirk, softmax_loss_layer.cpp:31); accuracy is the
    psum-weighted masked accuracy over all P subgraphs."""

    def replica_step(params, opt_state, es, cd, ww, tp, deg, x, lab,
                     valid, denom):
        dg = DeviceGraph(
            row_ptr=jnp.zeros(n_pad + 1, jnp.int32),  # unused (coo path)
            col_idx=cd[0], edge_src=es[0], deg=deg[0], trans_perm=tp[0],
            ell=(), nv=n_pad, ne=es.shape[1],
        )

        def loss_fn(p):
            logits = apply_model(cfg, p, dg, ww[0], x[0], train=True)
            probs = jax.nn.softmax(logits, axis=-1)
            onehot = jax.nn.one_hot(lab[0], logits.shape[-1],
                                    dtype=logits.dtype)
            ce = jnp.where(valid[0], gmath.cross_entropy(onehot, probs), 0.0)
            return jnp.sum(ce) / denom[0], logits

        (loss, logits), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        grads = jax.lax.pmean(grads, axis)
        new_params, new_opt = opt.update(grads, opt_state, params)
        pred = jnp.argmax(logits, axis=-1)
        hit = jnp.where(valid[0], (pred == lab[0]).astype(jnp.float32), 0.0)
        correct = jax.lax.psum(jnp.sum(hit), axis)
        total = jax.lax.psum(jnp.sum(valid[0].astype(jnp.float32)), axis)
        acc = correct / jnp.maximum(total, 1.0)
        return new_params, new_opt, jax.lax.pmean(loss, axis), acc

    ev = P(axis, None)
    step = jax.shard_map(
        replica_step,
        mesh=mesh,
        in_specs=(P(), P(), ev, ev, ev, ev, P(axis, None),
                  P(axis, None, None), P(axis, None), P(axis, None),
                  P(axis)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(step)


def _grow_pad(d: dict, e_pad: int, n_pad: int) -> dict:
    """Extend one replica's padded edge arrays to a larger shared e_pad
    (same pad values pad_subgraph uses)."""
    cur = d["es"].shape[0]
    if cur == e_pad:
        return d
    extra = e_pad - cur
    d = dict(d)
    d["es"] = np.concatenate(
        [d["es"], np.full(extra, n_pad - 1, dtype=np.int32)])
    d["cd"] = np.concatenate([d["cd"], np.zeros(extra, dtype=np.int32)])
    d["ww"] = np.concatenate([d["ww"], np.zeros(extra, dtype=np.float32)])
    d["tp"] = np.concatenate(
        [d["tp"], np.arange(cur, e_pad, dtype=np.int32)])
    d["e_pad"] = e_pad
    return d


def _stack_batch(batch: list[dict], n_pad: int):
    """Align a step's P replica dicts to one shared e_pad and stack each
    field along a new leading axis."""
    e_pad = max(d["e_pad"] for d in batch)
    batch = [_grow_pad(d, e_pad, n_pad) for d in batch]
    out = {k: np.stack([d[k] for d in batch])
           for k in ("es", "cd", "ww", "tp", "deg", "x", "lab", "valid")}
    out["denom"] = np.asarray([float(d["n_real"]) for d in batch],
                              dtype=np.float32)
    out["subg_nv"] = [d["n_real"] for d in batch]
    return out, e_pad


def train_sampled_dp(
    model,
    num_steps: int,
    subg_size: int,
    *,
    mesh: Mesh | None = None,
    val_interval: int = 50,
    verbose: bool = True,
    seed: int = 0,
):
    """Run ``num_steps`` data-parallel GraphSAINT steps on ``model``
    (an nn.model.Model). Each step samples P = mesh-size fresh
    subgraphs, one per device, and applies one pmean'd update.
    Parameters and optimizer state are written back to the model so
    ``model.evaluate`` works unchanged. Returns total wall time."""
    from graphaibench_tpu.nn.model import pad_subgraph
    from graphaibench_tpu.nn.sampler import SaintSampler

    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (DATA_AXIS,))
    (axis,) = mesh.axis_names
    n_rep = mesh.devices.size

    sampler = SaintSampler(
        model.data.graph, model.training.host, model.data.train_mask)
    n_pad = -(-subg_size // 8) * 8
    host = model.training.host
    avg_deg = max(host.ne // max(host.nv, 1), 1)
    e_pad = -(-(n_pad * (avg_deg + 2)) // 64) * 64

    feats_np = np.asarray(model.data.feats)
    labels_np = np.asarray(model.data.labels)

    step = make_dp_saint_step(model.cfg, model.opt, mesh, n_pad, axis=axis)
    rep_sh = NamedSharding(mesh, P())

    def put_rep(t):
        return jax.device_put(t, rep_sh)

    params = jax.tree.map(put_rep, model.params)
    opt_state = jax.tree.map(put_rep, model.opt_state)

    specs = dict(es=P(axis, None), cd=P(axis, None), ww=P(axis, None),
                 tp=P(axis, None), deg=P(axis, None),
                 x=P(axis, None, None), lab=P(axis, None),
                 valid=P(axis, None), denom=P(axis))

    pool = concurrent.futures.ThreadPoolExecutor(min(n_rep, 8))

    def prepare_batch(step_idx, e_pad):
        futs = [
            pool.submit(pad_subgraph, sampler, model.cfg.arch, subg_size,
                        seed + step_idx * n_rep + r, n_pad, e_pad,
                        feats_np, labels_np)
            for r in range(n_rep)
        ]
        return _stack_batch([f.result() for f in futs], n_pad)

    def sync_back():
        model.params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                    params)
        model.opt_state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                       opt_state)

    try:
        fut = pool.submit(prepare_batch, 0, e_pad)
        total = 0.0
        for it in range(num_steps):
            t0 = time.perf_counter()
            d, e_pad = fut.result()
            if it + 1 < num_steps:   # double-buffer the samplers
                fut = pool.submit(prepare_batch, it + 1, e_pad)
            args = {k: jax.device_put(d[k], NamedSharding(mesh, specs[k]))
                    for k in specs}
            params, opt_state, loss, acc = step(
                params, opt_state, args["es"], args["cd"], args["ww"],
                args["tp"], args["deg"], args["x"], args["lab"],
                args["valid"], args["denom"])
            loss, acc = float(loss), float(acc)   # device sync
            dt = time.perf_counter() - t0
            total += dt
            if verbose:
                line = (f"Step {it:3d} subg_nv {d['subg_nv']} "
                        f"train_loss {loss:.3f} train_acc {acc:.3f}")
                if it % val_interval == 0 and it != 0:
                    sync_back()
                    line += f" val_acc {model.evaluate('val'):.3f}"
                print(f"{line} time {dt:.4f} s")
    finally:
        pool.shutdown(wait=False)
    sync_back()
    if verbose and num_steps:
        print(f"Average time per DP step ({n_rep} subgraphs): "
              f"{total / num_steps:.5f} seconds.")
    return total
