"""Command-line entry points.

``python -m graphaibench_tpu.cli train <arch> <dataset> [epochs threads
loss hidden score_drop feat_drop lr layers subg_size val_interval
inductive]`` mirrors the reference trainer argv (train.cpp:9-14,
net.cpp:40-64) with one difference: the architecture is a runtime
argument instead of a compile-time #define (the reference builds
cpu_train_{gcn,sage,gat,ggnn} binaries).

Dataset resolution: an absolute/existing path is used directly; otherwise
``$DATASET_PATH/<name>`` (configs.h:5) and finally the bundled reference
fixtures are tried.

``GAB_SHARDS=<n|auto>`` routes full-batch training onto the
vertex-sharded halo-exchange trainer over a mesh of n devices
(parallel/train.py — the production multi-chip path), keeping the same
argv. Loss trajectory and test accuracy match the single-chip Model to
f32 summation-order tolerance. ``GAB_TP=<m>`` additionally shards the
feature dimension over an m-wide model axis (2-D graph x model mesh,
GCN/SAGE). ``GAB_DP=<p>`` makes GraphSAINT training (subg_size > 0)
data-parallel: p devices each train on their own sampled subgraph per
step with pmean'd gradients (parallel/dp_saint.py).
"""

from __future__ import annotations

import os
import sys


def resolve_dataset(name: str) -> str:
    if os.path.isdir(name):
        return name
    if os.path.exists(name + ".meta.json"):  # compressed-graph prefix
        return name
    root = os.environ.get("DATASET_PATH")
    if root and os.path.isdir(os.path.join(root, name)):
        return os.path.join(root, name)
    bundled = os.path.join("/root/reference/inputs", name)
    if os.path.isdir(bundled):
        return bundled
    raise SystemExit(f"dataset '{name}' not found (set DATASET_PATH)")


def cmd_train(argv: list[str]) -> int:
    # optional flags (may appear anywhere): --timers prints the stage
    # time breakdown after training (the reference prints its per-op
    # table on every run, train.cpp:60-76; under jit the honest
    # granularity is per device-synced stage); --profile=DIR captures a
    # jax.profiler trace of the whole run (nvprof/VTune analog).
    use_timers = "--timers" in argv
    profile_dir = None
    argv = [a for a in argv if a != "--timers"]
    for a in list(argv):
        if a.startswith("--profile="):
            profile_dir = a.split("=", 1)[1]
            argv.remove(a)
    if len(argv) < 2:
        print(
            "usage: train <arch> <dataset> [epochs=10] [threads=0] "
            "[loss=softmax] [hidden=16] [score_drop=0] [feat_drop=0] "
            "[lr=0.02] [layers=2] [subg_size=0] [val_interval=50] "
            "[inductive=0] [--timers] [--profile=DIR]"
        )
        return 2
    from graphaibench_tpu.graph.io import load_gnn_dataset
    from graphaibench_tpu.nn import Model, make_config

    arch = argv[0]
    path = resolve_dataset(argv[1])

    def arg(i, default, cast):
        return cast(argv[i]) if len(argv) > i else default

    epochs = arg(2, 10, int)
    _threads = arg(3, 0, int)  # accepted for CLI parity; XLA manages threads
    loss = arg(4, "softmax", str)
    hidden = arg(5, 16, int)
    score_drop = arg(6, 0.0, float)
    feat_drop = arg(7, 0.0, float)
    lr = arg(8, 0.02, float)
    layers = arg(9, 2, int)
    subg_size = arg(10, 0, int)
    val_interval = arg(11, 50, int)
    inductive = bool(arg(12, 0, int)) or subg_size > 0

    is_sigmoid = loss == "sigmoid"
    if os.path.exists(path + ".meta.json"):
        print("train does not accept compressed-graph prefixes; "
              "decompress first (cli compress decompress <prefix> <dir>)")
        return 2
    import glob as _glob

    if _glob.glob(os.path.join(path, "*.csgr")):
        from graphaibench_tpu.graph.io import load_gnn_dataset_csgr

        ds = load_gnn_dataset_csgr(path, is_single_class=not is_sigmoid)
    else:
        ds = load_gnn_dataset(path, is_single_class=not is_sigmoid)
    cfg = make_config(
        arch, layers, ds.feat_len, hidden, ds.num_classes,
        subg_size=subg_size, feat_drop=feat_drop, score_drop=score_drop,
        lr=lr, is_sigmoid=is_sigmoid,
    )
    print(
        f"num_vertices = {ds.graph.nv}, num_edges = {ds.graph.ne}, "
        f"num_layers = {cfg.num_layers},\nnum_epochs = {epochs}, "
        f"input_length = {ds.feat_len}, hidden_length = {hidden}, "
        f"num_classes = {ds.num_classes},\nfeat_drop = {feat_drop}, "
        f"score_drop = {score_drop}, subg_size = {subg_size}, "
        f"val_interval = {val_interval}, learning_rate = {lr}"
    )
    import contextlib

    from graphaibench_tpu.utils.timers import TIMERS, profiler_trace

    timers = TIMERS if use_timers else None
    if timers is not None:
        timers.reset()
    prof = profiler_trace(profile_dir) if profile_dir else contextlib.nullcontext()

    shards = os.environ.get("GAB_SHARDS", "")
    with prof:
        if shards and subg_size == 0 and not inductive:
            # the production multi-chip path from the CLI: vertex-sharded
            # halo-exchange trainer over a mesh of N devices (GAB_SHARDS=N,
            # or "auto" for every visible device)
            rc = _train_sharded(cfg, ds, epochs, val_interval, shards,
                                timers=timers)
            if timers is not None:
                timers.print_timers()
            return rc
        if subg_size > 0:
            from graphaibench_tpu.nn.sampler import SaintSampler  # noqa: F401
            model = Model(cfg, ds, inductive=True, timers=timers)
            dp = int(os.environ.get("GAB_DP", "1"))
            if dp > 1:
                # GAB_DP=<p>: data-parallel GraphSAINT — each of p
                # devices trains on its own sampled subgraph per step,
                # gradients pmean'd (the reference's num_subgraphs =
                # num_threads parallel sampler, net.cpp:159, mapped to
                # the device mesh)
                import jax
                import numpy as np
                from jax.sharding import Mesh

                from graphaibench_tpu.parallel.dp_saint import (
                    DATA_AXIS, train_sampled_dp)

                dp = max(1, min(dp, len(jax.devices())))
                mesh = Mesh(np.asarray(jax.devices()[:dp]), (DATA_AXIS,))
                train_sampled_dp(model, epochs, subg_size, mesh=mesh,
                                 val_interval=val_interval)
            else:
                model.train_sampled(epochs, subg_size,
                                    val_interval=val_interval)
        else:
            model = Model(cfg, ds, inductive=inductive, timers=timers)
            model.train(epochs, val_interval=val_interval)
        print(f"Test accuracy: {model.evaluate('test'):.4f}")
    if timers is not None:
        timers.print_timers()
    return 0


def _train_sharded(cfg, ds, epochs: int, val_interval: int,
                   shards: str, timers=None) -> int:
    """Full-batch training on the vertex-sharded halo-exchange trainer
    (parallel/train.py) with reference-style epoch lines and the same
    masked test accuracy as the single-chip Model."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from graphaibench_tpu.nn.layers import init_params
    from graphaibench_tpu.nn.model import aggregation_weights, prepare_graph
    from graphaibench_tpu.nn.optim import OPTIMIZERS
    from graphaibench_tpu.ops import math as gmath
    from graphaibench_tpu.utils import timers as utimers
    from graphaibench_tpu.parallel import (
        AXIS,
        build_sharded_graph,
        make_sharded_trainer,
    )

    n = len(jax.devices()) if shards == "auto" else int(shards)
    n = max(1, min(n, len(jax.devices())))
    # GAB_TP=<m>: also shard the feature dimension over a model axis of
    # size m (2-D graph x model mesh, parallel/train.py TP path)
    tp = int(os.environ.get("GAB_TP", "1"))
    eval_ranges = {"val": (ds.val_range, ds.val_mask),
                   "test": (ds.test_range, ds.test_mask)}
    prepped = prepare_graph(ds.graph, cfg.arch)
    w = aggregation_weights(prepped, cfg.arch)
    if tp > 1:
        from graphaibench_tpu.parallel import MODEL_AXIS, make_tp_trainer
        from graphaibench_tpu.parallel.multihost import hybrid_mesh

        gdim = max(n // tp, 1)
        mesh = hybrid_mesh(AXIS, MODEL_AXIS, model_parallelism=tp,
                           devices=jax.devices()[:gdim * tp])
        print(f"sharded trainer: ({gdim} graph x {tp} model) mesh, "
              "vertex sharding + feature-dim tensor parallelism")
        sg = build_sharded_graph(prepped, w, gdim)
        trainer = make_tp_trainer(mesh, cfg, sg, ds.feats, ds.labels,
                                  ds.train_range, ds.train_mask,
                                  eval_ranges=eval_ranges)
    else:
        mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))
        print(f"sharded trainer: {n} device(s), vertex-sharded halo exchange")
        sg = build_sharded_graph(prepped, w, n)
        trainer = make_sharded_trainer(
            mesh, cfg, sg, ds.feats, ds.labels, ds.train_range,
            ds.train_mask, eval_ranges=eval_ranges)
    params = init_params(cfg)
    opt_state = OPTIMIZERS[cfg.optimizer](lr=cfg.lr).init(params)
    import time as _time

    labels = jnp.asarray(ds.labels)

    def masked_acc(logits, rng_, mask):
        begin, end, _ = rng_
        idx = jnp.arange(logits.shape[0])
        valid = (idx >= begin) & (idx < end) & (jnp.asarray(mask) != 0)
        if cfg.is_sigmoid:
            return float(gmath.masked_f1_micro(jax.nn.sigmoid(logits),
                                               labels, valid))
        return float(gmath.masked_accuracy_single(logits, labels, valid))

    t0 = _time.perf_counter()
    for epoch in range(epochs):
        ts = _time.perf_counter()
        params, opt_state, loss = trainer.train_step(params, opt_state)
        line = f"Epoch {epoch:3d}: train_loss = {float(loss):.4f}"
        if timers is not None:   # float(loss) above synced the device
            timers.add(utimers.OP_STEP, _time.perf_counter() - ts)
        if epoch % val_interval == 0 and epoch != 0:
            # same cadence/format as the single-chip Model.train; the
            # in-mesh psum accuracy works multi-host (no global gather)
            te = _time.perf_counter()
            if cfg.is_sigmoid:
                logits = jnp.asarray(trainer.eval_logits(params))
                va = masked_acc(logits, ds.val_range, ds.val_mask)
            else:
                va = trainer.eval_accuracy(params, "val")
            line += f" val_acc {va:.3f}"
            if timers is not None:
                timers.add(utimers.OP_EVAL, _time.perf_counter() - te)
        print(line)
    dt = _time.perf_counter() - t0
    print(f"time per epoch: {dt / max(epochs, 1):.4f} s")

    te = _time.perf_counter()
    if cfg.is_sigmoid:
        logits = jnp.asarray(trainer.eval_logits(params))
        acc = masked_acc(logits, ds.test_range, ds.test_mask)
    else:
        acc = trainer.eval_accuracy(params, "test")
    if timers is not None:
        timers.add(utimers.OP_EVAL, _time.perf_counter() - te)
        # standalone halo all_to_all cost (overlapped in the real step)
        trainer.halo_probe()   # compile
        timers.add(utimers.OP_HALO, trainer.halo_probe())
    print(f"Test accuracy: {acc:.4f}")
    return 0


def cmd_analytics(argv: list[str]) -> int:
    """<kernel> <dataset> [args...] — analytics solvers with verifiers."""
    if len(argv) < 2:
        print("usage: analytics <tc|bfs|sssp|pr|cc|bc|kcore|color|cf|sample> <dataset> [...]")
        return 2
    from graphaibench_tpu.analytics import run_benchmark

    return run_benchmark(argv[0], resolve_dataset(argv[1]), argv[2:])


def cmd_info(argv: list[str]) -> int:
    """<dataset> — print meta + degree stats (query_graph_info analog)."""
    if not argv:
        print("usage: info <dataset>")
        return 2
    import numpy as np

    from graphaibench_tpu.graph.io import load_graph, read_meta

    path = resolve_dataset(argv[0])
    if os.path.exists(path + ".meta.json"):
        from graphaibench_tpu.compress.cli import decode_any, load_compressed

        g = decode_any(load_compressed(path))
        deg = g.degrees()
        print(f"(compressed prefix, decoded) |V| {g.nv} |E| {g.ne}")
        print(f"max_degree {deg.max()}  avg_degree {deg.mean():.2f}")
        return 0
    meta = read_meta(path)
    g = load_graph(path, with_vlabels=True, mmap=True)
    deg = g.degrees()
    print(f"|V| {g.nv} |E| {g.ne}")
    print(f"max_degree {deg.max()}  avg_degree {deg.mean():.2f}  "
          f"min_degree {deg.min()}")
    if g.is_bipartite():
        print(f"bipartite: {g.n_left} x {g.n_right}")
    if meta.feat_len:
        print(f"feat_len {meta.feat_len}")
    if meta.num_vertex_classes:
        print(f"vertex classes {meta.num_vertex_classes}")
    if g.vlabels is not None:
        print(f"vlabels present ({len(np.unique(np.asarray(g.vlabels)))} "
              f"distinct)")
    for name, rng in (("train", meta.train), ("val", meta.val),
                      ("test", meta.test)):
        if rng:
            print(f"{name}_range [{rng[0]}, {rng[1]}) count {rng[2]}")
    # short degree histogram (pow2 bins, GraphT::degree_histogram)
    bins = np.bincount(np.ceil(np.log2(np.maximum(deg, 1) + 1)).astype(int))
    hist = " ".join(f"2^{i}:{c}" for i, c in enumerate(bins) if c)
    print(f"degree histogram {hist}")
    return 0


def cmd_partition(argv: list[str]) -> int:
    """``partition <dataset> <num_parts> <out-prefix>`` — write induced
    1-hop-halo partitions as ``<prefix>-part<i>`` binary CSR dirs (the
    reference's offline partitioner flow feeding per-PE loads,
    graph_partition.cc:18-35 + multigpu_nvshmem.cu:13-120)."""
    if len(argv) != 3:
        print("usage: partition <dataset> <num_parts> <out-prefix>")
        return 2
    from graphaibench_tpu.graph.io import load_graph
    from graphaibench_tpu.graph.partition import write_partitions

    g = load_graph(resolve_dataset(argv[0]))
    n = int(argv[1])
    parts = write_partitions(g, n, argv[2], verbose=True)
    for i, p in enumerate(parts):
        print(f"subgraph[{i}]: masters {p.num_masters} "
              f"local |V| {p.subgraph.nv} |E| {p.subgraph.ne} "
              f"range [{p.global_range[0]}, {p.global_range[1]})")
    return 0


def main() -> int:
    from graphaibench_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if len(sys.argv) < 2:
        print("usage: graphaibench_tpu.cli "
              "<train|analytics|compress|partition|info> ...")
        return 2
    cmd = sys.argv[1]
    if cmd == "train":
        return cmd_train(sys.argv[2:])
    if cmd == "analytics":
        return cmd_analytics(sys.argv[2:])
    if cmd == "info":
        return cmd_info(sys.argv[2:])
    if cmd == "partition":
        return cmd_partition(sys.argv[2:])
    if cmd == "compress":
        from graphaibench_tpu.compress.cli import main as compress_main

        return compress_main(sys.argv[2:])
    print(f"unknown command {cmd!r}")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
