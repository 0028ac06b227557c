"""Sharded-trainer stage profile at products scale (P=1).

Attributes the sharded epoch's time against the single-device one.
Stages, each median-of-3 fetch-forced calls on fresh inputs:

  single_spmm_*   — the single-chip seg-ELL SpMM on the SAME graph
                    (ops.spmm packed path), the reference point.
  spmm_*          — the unified sharded layout (part="all") under
                    shard_map at P=1.
  own_*           — the trainer's REAL aggregation: halo_exchange +
                    own-split + halo-split packed SpMMs.
  step_s          — one full sharded train_step (fwd+bwd+Adam).

  python tools/shard_profile.py [--scale 21] [--ef 26] [--feat 100]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--ef", type=int, default=26)
    ap.add_argument("--feat", type=int, default=100)
    ap.add_argument("--skip-single", action="store_true")
    ap.add_argument("--skip-step", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.nn.model import aggregation_weights, prepare_graph
    from graphaibench_tpu.parallel import AXIS, build_sharded_graph
    from graphaibench_tpu.parallel.halo import halo_exchange
    from graphaibench_tpu.parallel.shard_ell import (
        build_shard_ell,
        drop_edge_ids,
        pack_shard_values,
        shard_specs,
        slot_spmm_packed,
        strip_shard,
    )

    def tick(tag, t0):
        t1 = time.perf_counter()
        print(f"[prof] host {tag}: {t1 - t0:.1f} s", file=sys.stderr,
              flush=True)
        return t1

    t = time.perf_counter()
    g = rmat(args.scale, args.ef, seed=0, cache=True)
    t = tick("rmat", t)
    prepped = prepare_graph(g, "gcn")
    t = tick("prepare_graph", t)
    w = aggregation_weights(prepped, "gcn")
    t = tick("aggregation_weights", t)
    out = {"graph": f"rmat{args.scale} ne={prepped.ne}"}
    print(json.dumps(out), flush=True)

    rng = np.random.default_rng(0)

    def median3(run, mk_input, fetch):
        _ = fetch(run(mk_input(0)))       # compile + warm
        ts = []
        for k in range(1, 4):
            xk = mk_input(k)
            t0 = time.perf_counter()
            y = run(xk)
            fetch(y)
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[1]

    def record(tag, val):
        out[tag] = val
        print(f"[prof] {tag}: {val*1e3:.0f} ms", file=sys.stderr, flush=True)
        print(json.dumps(out), flush=True)

    nv = prepped.nv
    x_host = rng.standard_normal((nv, args.feat)).astype(np.float32)

    # ---- single-chip reference point ------------------------------------
    if not args.skip_single:
        from graphaibench_tpu.ops.device_graph import (
            pack_edge_values,
            to_device_graph,
        )
        from graphaibench_tpu.ops.spmm import spmm

        dg = to_device_graph(prepped)
        pw = pack_edge_values(dg, jnp.asarray(w))
        t = tick("to_device_graph+pack", t)

        # graph pytrees enter as jit ARGUMENTS — a closed-over device
        # array becomes a constant embedded in the program
        fwd1_jit = jax.jit(lambda d, p, x: spmm(d, p, x))

        def fwd_bwd1(d, p, x):
            y, vjp = jax.vjp(lambda xx: spmm(d, p, xx), x)
            (dx,) = vjp(y)
            return dx

        fb1_jit = jax.jit(fwd_bwd1)
        fwd1 = lambda x: fwd1_jit(dg, pw, x)     # noqa: E731
        fb1 = lambda x: fb1_jit(dg, pw, x)       # noqa: E731

        def mk1(k):
            xa = jax.device_put(x_host + np.float32(1e-6) * k)
            _ = np.asarray(xa[0, :1])
            return xa

        record("single_spmm_fwd_s",
               median3(fwd1, mk1, lambda y: np.asarray(y[0, :1])))
        record("single_spmm_fwd_bwd_s",
               median3(fb1, mk1, lambda y: np.asarray(y[0, :1])))
        del dg, pw, fwd1, fb1
        gc.collect()

    # ---- sharded layouts --------------------------------------------------
    sg = build_sharded_graph(prepped, w, 1)
    t = tick("build_sharded_graph", t)
    se = build_shard_ell(sg)
    t = tick("build_shard_ell(all)", t)
    wp = pack_shard_values(se, sg.edge_w)
    t = tick("pack_shard_values", t)
    se = drop_edge_ids(se)
    t = tick("drop_edge_ids", t)
    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    nv_pad, nv_ext = sg.nv_pad, sg.nv_pad + sg.h_max
    out["graph"] += f" nv_pad={nv_pad} h_max={sg.h_max}"

    sh = NamedSharding(mesh, P(AXIS))
    sh2 = NamedSharding(mesh, P(AXIS, None))
    se_d = jax.device_put(se, jax.tree.map(lambda _: sh, se))
    wp_d = jax.device_put(wp, jax.tree.map(lambda _: sh, wp))
    del se, wp
    gc.collect()

    x0 = rng.standard_normal((1, nv_ext, args.feat)).astype(np.float32)

    def mk_sh(k):
        xk = jax.device_put(x0 + np.float32(1e-6) * k, sh)
        _ = np.asarray(xk[0, 0, :1])
        return xk

    def fwd(se_l, wp_l, x):
        return slot_spmm_packed(
            nv_pad, strip_shard(se_l), strip_shard(wp_l), x[0])[None]

    def fwd_bwd(se_l, wp_l, x):
        y, vjp = jax.vjp(lambda xx: slot_spmm_packed(
            nv_pad, strip_shard(se_l), strip_shard(wp_l), xx[0])[None], x)
        (dx,) = vjp(y)
        return dx

    def shard_run(f):
        return jax.jit(jax.shard_map(
            f, mesh=mesh,
            in_specs=(shard_specs(se_d, AXIS), shard_specs(wp_d, AXIS),
                      P(AXIS)),
            out_specs=P(AXIS), check_vma=False))

    run_f, run_fb = shard_run(fwd), shard_run(fwd_bwd)
    record("spmm_fwd_s", median3(
        lambda x: run_f(se_d, wp_d, x), mk_sh,
        lambda y: np.asarray(y[0, 0, :1])))
    record("spmm_fwd_bwd_s", median3(
        lambda x: run_fb(se_d, wp_d, x), mk_sh,
        lambda y: np.asarray(y[0, 0, :1])))
    del se_d, wp_d, run_f, run_fb
    gc.collect()

    # ---- the trainer's real own/halo overlap path ------------------------
    se_own = build_shard_ell(sg, part="own")
    t = tick("build_shard_ell(own)", t)
    se_halo = build_shard_ell(sg, part="halo")
    t = tick("build_shard_ell(halo)", t)
    wp_own = pack_shard_values(se_own, sg.edge_w)
    wp_halo = pack_shard_values(se_halo, sg.edge_w)
    t = tick("pack(own+halo)", t)
    se_own, se_halo = drop_edge_ids(se_own), drop_edge_ids(se_halo)
    eo = {"se_own": se_own, "wp_own": wp_own,
          "se_halo": se_halo, "wp_halo": wp_halo}
    eo_d = jax.device_put(eo, jax.tree.map(
        lambda a: NamedSharding(mesh, P(AXIS, *([None] * (np.asarray(a).ndim - 1)))), eo))
    send_d = jax.device_put(sg.send_idx, NamedSharding(mesh, P(AXIS, None, None)))
    hmap_d = jax.device_put(sg.halo_map, sh2)
    del eo, se_own, se_halo, wp_own, wp_halo
    gc.collect()

    x1 = rng.standard_normal((1, nv_pad, args.feat)).astype(np.float32)

    def mk_own(k):
        xk = jax.device_put(x1 + np.float32(1e-6) * k, sh)
        _ = np.asarray(xk[0, 0, :1])
        return xk

    def own_agg(x, eo_l, send, hmap):
        el = strip_shard(eo_l)
        h = x[0]
        halo = halo_exchange(h, send[0], hmap[0], axis=AXIS)
        y = slot_spmm_packed(nv_pad, el["se_own"], el["wp_own"], h)
        if el["se_halo"].fwd:
            y = y + slot_spmm_packed(nv_pad, el["se_halo"], el["wp_halo"],
                                     halo)
        return y[None]

    def own_fwd_bwd(x, eo_l, send, hmap):
        y, vjp = jax.vjp(lambda xx: own_agg(xx, eo_l, send, hmap), x)
        (dx,) = vjp(y)
        return dx

    eo_spec = jax.tree.map(
        lambda a: P(AXIS, *([None] * (a.ndim - 1))), eo_d)
    specs = (P(AXIS), eo_spec, P(AXIS, None, None), P(AXIS, None))
    run_of = jax.jit(jax.shard_map(own_agg, mesh=mesh, in_specs=specs,
                                   out_specs=P(AXIS), check_vma=False))
    run_ofb = jax.jit(jax.shard_map(own_fwd_bwd, mesh=mesh, in_specs=specs,
                                    out_specs=P(AXIS), check_vma=False))
    record("own_fwd_s", median3(
        lambda x: run_of(x, eo_d, send_d, hmap_d), mk_own,
        lambda y: np.asarray(y[0, 0, :1])))
    record("own_fwd_bwd_s", median3(
        lambda x: run_ofb(x, eo_d, send_d, hmap_d), mk_own,
        lambda y: np.asarray(y[0, 0, :1])))
    del eo_d, run_of, run_ofb
    gc.collect()

    # ---- one full sharded train step --------------------------------------
    if not args.skip_step:
        from graphaibench_tpu.nn.layers import ModelConfig, init_params
        from graphaibench_tpu.nn.optim import Adam
        from graphaibench_tpu.parallel import make_sharded_trainer

        classes = 47
        cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=args.feat,
                          dim_hid=128, num_cls=classes, lr=0.01)
        labels = rng.integers(0, classes, nv).astype(np.int32)
        mask = np.ones(nv, dtype=np.uint8)
        trainer = make_sharded_trainer(mesh, cfg, sg, x_host, labels,
                                       (0, nv, nv), mask)
        t = tick("make_sharded_trainer", t)
        params = init_params(cfg)
        opt_state = Adam(lr=cfg.lr).init(params)
        params, opt_state, loss = trainer.train_step(params, opt_state)
        _ = float(loss)
        ts = []
        for _k in range(3):
            t0 = time.perf_counter()
            params, opt_state, loss = trainer.train_step(params, opt_state)
            _ = float(loss)
            ts.append(time.perf_counter() - t0)
        record("step_s", sorted(ts)[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
