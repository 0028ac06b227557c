"""Two-process jax.distributed smoke on the CPU — the multi-host path.

Each process runs this script with a distinct process id; together they
bring up the distributed runtime (the reference's MPI bootstrap analog,
include/dist.h:29-42), build the host-major pod mesh spanning BOTH
processes' CPU devices, and run one sharded GNN train step whose
gradient psum crosses the process boundary.

  python tools/multiprocess_smoke.py <pid> <nproc> <port> [shard-prefix]

With a shard prefix (written beforehand via ``--write-shards``), each
process ALSO builds a second trainer by loading only ITS OWN shard
files (parallel/shard_io.py — the per-PE partition-file flow of the
reference's NVSHMEM solver) and asserts its step loss equals the
in-memory trainer's.

  python tools/multiprocess_smoke.py --write-shards <prefix> <num_shards>

Launched by tests/test_multiprocess.py; also runnable by hand.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dataset():
    import numpy as np

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.nn.layers import ModelConfig

    g = rmat(9, 8, seed=0)
    rng = np.random.default_rng(0)
    feat, ncls = 16, 4
    feats = rng.standard_normal((g.nv, feat)).astype(np.float32)
    labels = rng.integers(0, ncls, g.nv).astype(np.int32)
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=feat, dim_hid=16,
                      num_cls=ncls, lr=0.02)
    mask = np.ones(g.nv, dtype=np.uint8)
    tr = (0, g.nv // 2, g.nv // 2)
    return g, feats, labels, cfg, mask, tr


def write_shards(prefix: str, num_shards: int) -> int:
    """Offline partitioner step (single process, no distributed init)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    from graphaibench_tpu.nn.model import aggregation_weights, prepare_graph
    from graphaibench_tpu.parallel import build_sharded_graph
    from graphaibench_tpu.parallel.shard_io import write_trainer_shards

    g, feats, labels, cfg, mask, tr = _dataset()
    prepped = prepare_graph(g, cfg.arch)
    w = aggregation_weights(prepped, cfg.arch)
    sg = build_sharded_graph(prepped, w, num_shards)
    val = ((g.nv // 2, g.nv, g.nv - g.nv // 2), mask)
    write_trainer_shards(prefix, cfg, sg, feats, labels, tr, mask,
                         eval_ranges={"val": val})
    # a second prefix with num_shards/2 GRAPH shards for the
    # tensor-parallel phase ((nproc x 2) graph x model mesh)
    sg2 = build_sharded_graph(prepped, w, num_shards // 2)
    write_trainer_shards(prefix + "-tp", cfg, sg2, feats, labels, tr, mask)
    print(f"wrote {num_shards} shard files at {prefix}", flush=True)
    return 0


def main():
    if sys.argv[1] == "--write-shards":
        return write_shards(sys.argv[2], int(sys.argv[3]))
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    prefix = sys.argv[4] if len(sys.argv) > 4 else None
    # 2 virtual CPU devices per process -> a 4-device pod mesh
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    # CPU multi-process needs a cross-process collectives backend; gloo
    # ships with jaxlib (the MPI analog for the CPU client)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from graphaibench_tpu.parallel import multihost

    assert multihost.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()

    import numpy as np

    from graphaibench_tpu.nn.layers import init_params
    from graphaibench_tpu.nn.model import aggregation_weights, prepare_graph
    from graphaibench_tpu.nn.optim import Adam
    from graphaibench_tpu.parallel import build_sharded_graph, make_sharded_trainer

    mesh = multihost.pod_mesh()
    n = mesh.devices.size
    assert n == 2 * nproc, n  # devices from every process present

    g, feats, labels, cfg, mask, tr = _dataset()
    prepped = prepare_graph(g, cfg.arch)
    w = aggregation_weights(prepped, cfg.arch)
    sg = build_sharded_graph(prepped, w, n)
    trainer = make_sharded_trainer(mesh, cfg, sg, feats, labels, tr, mask)
    params = init_params(cfg)
    opt_state = Adam(lr=cfg.lr).init(params)
    _p, _o, loss = trainer.train_step(params, opt_state)
    # loss is replicated across the mesh; fetching it is process-local
    loss = float(jax.device_get(jax.tree.leaves(loss)[0]))
    assert np.isfinite(loss), loss

    loss_f = ""
    if prefix:
        # per-host shard loading: this process reads ONLY its own files
        from graphaibench_tpu.parallel.shard_io import (
            local_shard_ids,
            make_sharded_trainer_from_files,
        )

        ids = local_shard_ids(mesh)
        assert len(ids) == n // nproc, ids
        trainer2, cfg2 = make_sharded_trainer_from_files(mesh, prefix)
        p2 = init_params(cfg2)
        _p2, _o2, loss2 = trainer2.train_step(p2, Adam(lr=cfg2.lr).init(p2))
        loss2 = float(jax.device_get(jax.tree.leaves(loss2)[0]))
        assert abs(loss2 - loss) < 1e-6, (loss2, loss)
        # in-mesh psum accuracy: the multi-host-safe eval (no global
        # logits gather); replicated scalar, identical on every process
        acc = trainer2.eval_accuracy(p2, "val")
        assert 0.0 <= acc <= 1.0, acc

        # tensor parallelism ACROSS processes: (nproc graph x 2 model)
        # hybrid mesh, each process loading only its graph shard's file
        from graphaibench_tpu.parallel import MODEL_AXIS
        from graphaibench_tpu.parallel.multihost import hybrid_mesh

        mesh_tp = hybrid_mesh(model_parallelism=2)
        trainer3, cfg3 = make_sharded_trainer_from_files(
            mesh_tp, prefix + "-tp", model_axis=MODEL_AXIS)
        p3 = init_params(cfg3)
        _, _, loss3 = trainer3.train_step(p3, Adam(lr=cfg3.lr).init(p3))
        loss3 = float(jax.device_get(jax.tree.leaves(loss3)[0]))
        # same math on a different shard layout: f32 summation-order tol
        assert abs(loss3 - loss) < 1e-4, (loss3, loss)
        loss_f = f" fileloss={loss2:.6f} acc={acc:.6f} tploss={loss3:.6f}"

    print(f"MPSMOKE pid={pid} procs={jax.process_count()} "
          f"devices={n} loss={loss:.6f}{loss_f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
