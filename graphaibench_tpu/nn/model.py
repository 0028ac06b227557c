"""The training Model: the runtime analog of Model<gconv_layer>
(src/gnn/net.cpp / include/gnn/net.h), rebuilt around jitted pure steps.

Responsibilities: graph preparation per architecture (selfloops for
GCN/GAT/GGNN but not SAGE — net.cpp:96; inductive masked training graph
— net.cpp:161-164), per-arch aggregation weights, the jitted
train/eval steps, and the epoch loop with reference-style metrics
(train_loss/train_acc/val_acc lines, epoch/s throughput — net.cpp:361-419).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph import transforms as T
from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.graph.io import GnnDataset
from graphaibench_tpu.nn import optim
from graphaibench_tpu.nn.layers import ModelConfig, apply_model, init_params
from graphaibench_tpu.nn.losses import masked_sigmoid_loss, masked_softmax_loss
from graphaibench_tpu.ops import math as gmath
from graphaibench_tpu.ops.device_graph import DeviceGraph, to_device_graph
from graphaibench_tpu.utils import timers as timers_mod


def prepare_graph(g: CSRGraph, arch: str) -> CSRGraph:
    """Selfloop insertion for all archs except SAGE (net.cpp:96)."""
    return g if arch == "sage" else T.add_selfloop(g)


def aggregation_weights(g: CSRGraph, arch: str) -> np.ndarray:
    """Static per-edge aggregation weights by architecture; GAT computes
    attention scores at runtime so gets ones (unused)."""
    if arch == "gcn":
        return T.gcn_edge_norms(g)
    if arch == "sage":
        return T.sage_edge_norms(g)
    return np.ones(g.ne, dtype=np.float32)  # gat (unused) / ggnn (sum)


@dataclasses.dataclass
class GraphBundle:
    """A prepared graph + its device form + static aggregation weights.

    ``edge_w`` is always the raw (ne,) array (oracle tests compare it).
    ``packed_w`` is the per-bucket pre-gathered form for archs whose
    weights are constant over training (GCN/SAGE/GGNN): it saves the
    runtime w[edge_id] scalar gather on every SpMM (see
    ops.device_graph.PackedEdgeW)."""

    host: CSRGraph
    device: DeviceGraph
    edge_w: jnp.ndarray
    packed_w: object = None

    @property
    def edge_w_agg(self):
        """What aggregation call sites should pass as per-edge weights:
        packed when available, else the raw array."""
        return self.packed_w if self.packed_w is not None else self.edge_w

    @classmethod
    def build(cls, g: CSRGraph, arch: str, *, with_ell: bool = True,
              spmm_impl: str = "auto") -> "GraphBundle":
        from graphaibench_tpu.ops.spmm import _pick_impl

        import os

        prepped = prepare_graph(g, arch)
        # GAT keeps the plain/unified layout even above the seg-ELL
        # size threshold: column segmenting fragments its fused
        # multi-pass attention kernels (chosen on another chip; not yet
        # measured on the H100). GAB_SEG_ELL still overrides.
        seg = (False if arch == "gat"
               and not os.environ.get("GAB_SEG_ELL", "").strip()
               else None)
        device = to_device_graph(prepped, with_ell=with_ell, seg_ell=seg)
        edge_w = jnp.asarray(aggregation_weights(prepped, arch))
        packed = None
        # GAT re-derives scores per step (packed weights don't apply);
        # small graphs dispatch to the dense strategy instead. An
        # explicitly requested non-ELL spmm_impl also skips packing —
        # packed weights only feed the ELL path.
        if (arch != "gat" and (device.ell or device.seg_ell is not None)
                and prepped.nv > 4096
                and _pick_impl(device, spmm_impl) == "ell"):
            from graphaibench_tpu.ops.device_graph import (
                SEG_ELL_MIN_NV,
                pack_edge_values,
                slim_for_packed,
            )

            packed = pack_edge_values(device, edge_w)
            if prepped.nv >= SEG_ELL_MIN_NV:
                # the packed static-weight path never reads the COO
                # arrays, trans_perm, the bucket edge ids, or the raw
                # (ne,) weight copies — at products shape ~2.6 GB of
                # dead device memory; the sharded trainer drops the same
                # arrays
                import dataclasses as _dc

                device = slim_for_packed(device)
                packed = _dc.replace(
                    packed, raw=jnp.zeros((1,), packed.raw.dtype))
                edge_w = jnp.zeros((1,), jnp.float32)
        if arch == "gat" and prepped.nv >= (1 << 19) and (
                device.ell or device.seg_ell is not None):
            # the fused v2 GAT path reads only the buckets (with edge
            # ids, for pad masking) — the COO arrays and trans_perm are
            # v1-only and cost ~1.2 GB at products shape
            import dataclasses as _dc

            one = jnp.zeros((1,), jnp.int32)
            device = _dc.replace(device, col_idx=one, edge_src=one,
                                 trans_perm=None)
        return cls(host=prepped, device=device, edge_w=edge_w,
                   packed_w=packed)


def pad_subgraph(sampler, arch: str, subg_size: int, seed: int,
                 n_pad: int, e_pad: int, feats_np: np.ndarray,
                 labels_np: np.ndarray) -> dict:
    """Host work of one sampled step: sample + induce + pad to fixed
    shapes (n_pad, e_pad) so the device step compiles once. Mirrors the
    reference's construct_subg_feats/labels + graph swap
    (net.cpp:288-358). Returns padded numpy arrays; ``e_pad`` in the
    result may have grown (rounded up to 64) when the sample's edge
    count exceeded the requested pad — callers recompile once."""
    sub, l2g, _mask = sampler.generate_subgraph(subg_size, seed)
    sub = prepare_graph(sub, arch)
    n_real, e_real = sub.nv, sub.ne
    if e_real > e_pad:  # grow the pad (recompiles once)
        e_pad = -(-e_real // 64) * 64
    w = aggregation_weights(sub, arch)
    src, dst = sub.coo()
    es = np.full(e_pad, n_pad - 1, dtype=np.int32)
    cd = np.zeros(e_pad, dtype=np.int32)
    ww = np.zeros(e_pad, dtype=np.float32)
    es[:e_real], cd[:e_real] = src, dst
    # for GAT edge_w is the validity mask; others carry norms
    ww[:e_real] = 1.0 if arch == "gat" else w
    tp = np.arange(e_pad, dtype=np.int32)
    tp[:e_real] = T.transpose_edge_permutation(sub)
    deg = np.zeros(n_pad, dtype=np.int32)
    deg[:n_real] = sub.degrees()
    x = np.zeros((n_pad, feats_np.shape[1]), dtype=np.float32)
    x[:n_real] = feats_np[l2g]
    lab = np.zeros(n_pad, dtype=np.int32)
    lab[:n_real] = labels_np[l2g]
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n_real] = True
    return dict(e_pad=e_pad, n_real=n_real, es=es, cd=cd, ww=ww,
                tp=tp, deg=deg, x=x, lab=lab, valid=valid)


class Model:
    """End-to-end trainer. Usage:

        model = Model(cfg, dataset)
        model.train(num_epochs)
        acc = model.evaluate("test")
    """

    def __init__(
        self,
        cfg: ModelConfig,
        data: GnnDataset,
        *,
        inductive: bool = False,
        optimizer: str | None = None,   # overrides cfg.optimizer
        seed: int = 0,
        with_ell: bool = True,
        timers=None,   # utils.timers.OpTimers: stage breakdown (train.cpp:60-76)
    ):
        self.timers = timers
        self.cfg = cfg
        self.data = data
        self.inductive = inductive
        self.full = GraphBundle.build(data.graph, cfg.arch, with_ell=with_ell,
                                      spmm_impl=cfg.spmm_impl)
        if inductive:
            masked = T.masked_subgraph(data.graph, data.train_mask)
            self.training = GraphBundle.build(masked, cfg.arch, with_ell=with_ell,
                                              spmm_impl=cfg.spmm_impl)
        else:
            self.training = self.full

        self.params = init_params(cfg)
        self.opt = optim.OPTIMIZERS[optimizer or cfg.optimizer](lr=cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.key = jax.random.PRNGKey(seed)

        self.feats = jnp.asarray(data.feats)
        if cfg.is_sigmoid:
            self.labels = jnp.asarray(data.labels.astype(np.float32))
        else:
            self.labels = jnp.asarray(data.labels.astype(np.int32))
        self.masks = {
            "train": jnp.asarray(data.train_mask),
            "val": jnp.asarray(data.val_mask),
            "test": jnp.asarray(data.test_mask),
        }
        self.ranges = {
            "train": data.train_range,
            "val": data.val_range,
            "test": data.test_range,
        }
        self._train_step = jax.jit(self._train_step_fn)
        self._train_scan = jax.jit(self._train_scan_fn)
        self._eval_logits = jax.jit(self._eval_logits_fn)

    # -- pure step functions ----------------------------------------------
    # graph/feature/label arrays are jit ARGUMENTS, not closure captures:
    # a closed-over array becomes a constant embedded in the compiled
    # program (a 1M-vertex graph + features is over 1 GB).
    def _loss(self, params, dg, edge_w, feats, labels, mask, key):
        begin, end, _ = self.ranges["train"]
        logits = apply_model(
            self.cfg, params, dg, edge_w, feats, train=True, key=key,
            trivial_w=True,
        )
        if self.cfg.is_sigmoid:
            lg, rep, probs = masked_sigmoid_loss(
                logits, labels, begin, end, mask
            )
        else:
            lg, rep, probs = masked_softmax_loss(
                logits, labels, begin, end, mask
            )
        return lg, (rep, logits, probs)

    def _train_step_fn(self, params, opt_state, key, dg, edge_w, feats,
                       labels, mask):
        grads, (rep_loss, logits, probs) = jax.grad(self._loss, has_aux=True)(
            params, dg, edge_w, feats, labels, mask, key
        )
        new_params, new_opt_state = self.opt.update(grads, opt_state, params)
        begin, end, _ = self.ranges["train"]
        valid = (jnp.arange(logits.shape[0]) >= begin) & (
            jnp.arange(logits.shape[0]) < end
        ) & (mask != 0)
        if self.cfg.is_sigmoid:
            acc = gmath.masked_f1_micro(probs, labels, valid)
        else:
            acc = gmath.masked_accuracy_single(logits, labels, valid)
        return new_params, new_opt_state, rep_loss, acc

    def _eval_logits_fn(self, params, dg, edge_w, feats):
        return apply_model(
            self.cfg, params, dg, edge_w, feats, train=False, trivial_w=True,
        )

    def _train_scan_fn(self, params, opt_state, keys, dg, edge_w, feats,
                       labels, mask):
        """`keys.shape[0]` train steps in ONE dispatch (lax.scan)."""

        def body(carry, key):
            p, o = carry
            p, o, loss, acc = self._train_step_fn(
                p, o, key, dg, edge_w, feats, labels, mask)
            return (p, o), (loss, acc)

        (params, opt_state), (losses, accs) = jax.lax.scan(
            body, (params, opt_state), keys)
        return params, opt_state, losses, accs

    # -- public API --------------------------------------------------------
    def save(self, path: str, *, step: int = 0) -> str:
        """Checkpoint params + optimizer state (one ``.npz`` per step).
        The reference has NO training checkpointing (SURVEY.md §5 — the
        model lives and dies in one process)."""
        from graphaibench_tpu.utils.checkpoint import save_checkpoint

        return save_checkpoint(path, {"params": self.params,
                                      "opt_state": self.opt_state},
                               step=step)

    def restore(self, path: str, *, step: int = 0) -> None:
        """Resume training from a checkpoint written by :meth:`save`."""
        from graphaibench_tpu.utils.checkpoint import restore_checkpoint

        state = restore_checkpoint(
            path, {"params": self.params, "opt_state": self.opt_state},
            step=step)
        self.params = state["params"]
        self.opt_state = state["opt_state"]

    def train_epochs(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Run n training epochs in one device dispatch; returns
        per-epoch (loss, acc) arrays."""
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, n)
        self.params, self.opt_state, losses, accs = self._train_scan(
            self.params, self.opt_state, keys, self.training.device,
            self.training.edge_w_agg, self.feats, self.labels,
            self.masks["train"],
        )
        return np.asarray(losses), np.asarray(accs)

    def train_epoch(self) -> tuple[float, float]:
        self.key, sub = jax.random.split(self.key)
        self.params, self.opt_state, loss, acc = self._train_step(
            self.params, self.opt_state, sub, self.training.device,
            self.training.edge_w_agg, self.feats, self.labels,
            self.masks["train"],
        )
        return float(loss), float(acc)

    def train(self, num_epochs: int, *, val_interval: int = 50, verbose: bool = True):
        total = 0.0
        for epoch in range(num_epochs):
            t0 = time.perf_counter()
            loss, acc = self.train_epoch()   # float() inside = device sync
            dt = time.perf_counter() - t0
            total += dt
            if self.timers is not None:
                self.timers.add(timers_mod.OP_STEP, dt)
            if verbose:
                line = f"Epoch {epoch:3d} train_loss {loss:.3f} train_acc {acc:.3f}"
                if epoch % val_interval == 0 and epoch != 0:
                    line += f" val_acc {self.evaluate('val'):.3f}"
                print(f"{line} time {dt:.4f} s")
        if verbose and num_epochs:
            print(
                f"Average training time per epoch: {total / num_epochs:.5f} "
                f"seconds. Throughput {num_epochs / max(total, 1e-12):.2f} epoch/s"
            )
        return total

    def train_sampled(
        self,
        num_epochs: int,
        subg_size: int,
        *,
        val_interval: int = 50,
        verbose: bool = True,
        seed: int = 0,
    ):
        """GraphSAINT subgraph-sampled training (Model::subgraph_sampling,
        net.cpp:288-358): each epoch trains on a fresh frontier-sampled
        subgraph of ~subg_size vertices; evaluation uses the full graph.
        Subgraph arrays are padded to fixed shapes so the step compiles
        once."""
        from graphaibench_tpu.nn.sampler import SaintSampler
        from graphaibench_tpu.nn.losses import masked_softmax_loss  # noqa: F401
        from graphaibench_tpu.ops.device_graph import DeviceGraph
        import jax.numpy as jnp

        sampler = SaintSampler(
            self.data.graph, self.training.host, self.data.train_mask
        )
        n_pad = -(-subg_size // 8) * 8
        avg_deg = max(self.training.host.ne // max(self.training.host.nv, 1), 1)
        e_pad = -(-(n_pad * (avg_deg + 2)) // 64) * 64

        feats_np = np.asarray(self.data.feats)
        labels_np = np.asarray(self.data.labels)

        def sampled_step(params, opt_state, dg, edge_w, x, lab, valid, denom):
            def loss_fn(params):
                logits = apply_model(self.cfg, params, dg, edge_w, x, train=True)
                probs = jax.nn.softmax(logits, axis=-1)
                onehot = jax.nn.one_hot(lab, logits.shape[-1], dtype=logits.dtype)
                ce = jnp.where(valid, gmath.cross_entropy(onehot, probs), 0.0)
                return jnp.sum(ce) / denom, logits

            grads, logits = jax.grad(loss_fn, has_aux=True)(params)
            new_params, new_opt = self.opt.update(grads, opt_state, params)
            acc = gmath.masked_accuracy_single(logits, lab, valid)
            loss_rep = loss_fn(params)[0]
            return new_params, new_opt, loss_rep, acc

        step = jax.jit(sampled_step)

        def prepare(epoch, e_pad):
            """Host work of one epoch (pad_subgraph). Runs in a
            background thread so epoch k+1's sampling overlaps epoch k's
            device step (the reference pre-samples num_threads subgraphs
            per round for the same reason, net.cpp:288-358)."""
            return pad_subgraph(sampler, self.cfg.arch, subg_size,
                                seed + epoch, n_pad, e_pad, feats_np,
                                labels_np)

        import concurrent.futures

        pool = concurrent.futures.ThreadPoolExecutor(1)
        try:
            fut = pool.submit(prepare, 0, e_pad)
            total = 0.0
            for epoch in range(num_epochs):
                t0 = time.perf_counter()
                d = fut.result()
                if self.timers is not None:
                    # sampler wait NOT hidden by the device step overlap
                    self.timers.add(timers_mod.OP_SAMPLE,
                                    time.perf_counter() - t0)
                e_pad = d["e_pad"]
                if epoch + 1 < num_epochs:   # double-buffer the sampler
                    fut = pool.submit(prepare, epoch + 1, e_pad)
                dg = DeviceGraph(
                    row_ptr=jnp.zeros(n_pad + 1, jnp.int32),  # unused (coo)
                    col_idx=jnp.asarray(d["cd"]), edge_src=jnp.asarray(d["es"]),
                    deg=jnp.asarray(d["deg"]), trans_perm=jnp.asarray(d["tp"]),
                    ell=(), nv=n_pad, ne=e_pad,
                )
                t_step = time.perf_counter()
                self.params, self.opt_state, loss, acc = step(
                    self.params, self.opt_state, dg, jnp.asarray(d["ww"]),
                    jnp.asarray(d["x"]), jnp.asarray(d["lab"]),
                    jnp.asarray(d["valid"]), jnp.float32(d["n_real"]),
                )
                if self.timers is not None:
                    float(loss)   # device sync so `step` is honest
                    self.timers.add(timers_mod.OP_STEP,
                                    time.perf_counter() - t_step)
                dt = time.perf_counter() - t0
                total += dt
                if verbose:
                    line = (f"Epoch {epoch:3d} subg_nv {d['n_real']} train_loss "
                            f"{float(loss):.3f} train_acc {float(acc):.3f}")
                    if epoch % val_interval == 0 and epoch != 0:
                        line += f" val_acc {self.evaluate('val'):.3f}"
                    print(f"{line} time {dt:.4f} s")
        finally:
            pool.shutdown(wait=False)
        return total

    def evaluate(self, split: str = "test") -> float:
        t0 = time.perf_counter()
        logits = self._eval_logits(self.params, self.full.device,
                                   self.full.edge_w_agg, self.feats)
        begin, end, _ = self.ranges[split]
        idx = jnp.arange(logits.shape[0])
        valid = (idx >= begin) & (idx < end) & (self.masks[split] != 0)
        if self.cfg.is_sigmoid:
            acc = float(
                gmath.masked_f1_micro(jax.nn.sigmoid(logits), self.labels, valid)
            )
        else:
            acc = float(gmath.masked_accuracy_single(logits, self.labels, valid))
        if self.timers is not None:   # float() above synced the device
            self.timers.add(timers_mod.OP_EVAL, time.perf_counter() - t0)
        return acc
