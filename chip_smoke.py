"""On-card smoke test: GNN training end to end on one NVIDIA GPU.

    python chip_smoke.py                # one GPU: device, kernels, train, analytics
    python chip_smoke.py --four-cards   # four GPUs: sharded paths vs single device

Phases, in order (each prints its own lines; every number is read beside
the card name and power limit printed by ``device``):

  device     refuses anything but a GPU; prints the card, JAX's device,
             which native host library ran and where the compile cache is.
  kernels    the aggregation ops (spmm forward and its custom-VJP adjoint,
             sddmm_add and its VJP, sddmm_dot, fused GAT v2 forward and
             VJP) against float64 scipy/numpy references at F=128, on one
             seeded rmat graph per size regime: 2^11 vertices (dense
             strategy), 2^16 (plain ELL, f32) and 2^20 with edge factor 16
             (seg-ELL, packed static weights, slim device graph, bf16 GAT
             gathers). At 2^20 it also times the seg-ELL, plain-ELL and COO
             SpMM as a finding; no path is switched on it.
  train      ``cli train`` on a dataset this script writes: the reference's
             products recipe (SAGE, 3 layers, hidden 256, lr 0.01; 100
             features, 47 classes) plus GCN and GAT at 2x128, on a seeded
             rmat(20, 16), 5 epochs each. Losses must be finite and fall.
  analytics  ``cli analytics tc|bfs|pr`` on a seeded rmat(16, 16); each
             must print the serial verifier's ``Correct``.

``--four-cards`` runs only: ``__graft_entry__.dryrun_multichip(4)`` and GCN
2x128 on rmat(20, 16) through ``GAB_SHARDS=4`` compared with the
single-device Model over 3 epochs.

The last line of stdout is one JSON object, printed only when every phase
passed; any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO, ".smoke_data")   # listed in .gitignore
FEAT = 128
SEED = 0

# one graph per regime the size rules choose: (scale, edge factor, what)
KERNEL_SIZES = (
    (11, 16, "dense strategy (nv <= 4096)"),
    (16, 16, "plain ELL, packed weights, f32 gathers"),
    (20, 16, "seg-ELL, packed weights, slim device graph, bf16 GAT gathers"),
)

# tolerance per numeric regime: (metric, bound, reason). "max" is
# max|got - ref| / max|ref|, "l2" is |got - ref|_2 / |ref|_2.
TOLS = {
    "f32": ("max", 1e-5, "f32 operands; summation and atomic scatter-add "
                         "order differ from the float64 host sum"),
    "f32-adj": ("max", 1e-4, "f32; the softmax adjoint subtracts <ct, out> "
                             "from per-edge dots"),
    "bf16": ("max", 2e-2, "GAT v2 gathers h and sr in bf16 from 2^17 "
                          "vertices (8-bit mantissa)"),
    "bf16-adj": ("l2", 1e-1, "bf16 gathers, and d_sl, d_sr are small "
                             "differences of attention-weighted dots, so "
                             "their worst element is off by ~0.2 of "
                             "max|ref| on rmat(16, 16)"),
}

# cli train argv after "<arch> <dataset>": epochs threads loss hidden
# score_drop feat_drop lr layers (the reference's products recipe is
# `cpu_train_sage <ds> <epochs> 0 softmax 256 0 0 0.01 3`)
TRAIN_RUNS = (
    ("sage", "256", "3"),
    ("gcn", "128", "2"),
    ("gat", "128", "2"),
)
TRAIN_FEATS, TRAIN_CLASSES, TRAIN_EPOCHS = 100, 47, 5
TRAIN_SCALE, ANALYTICS_SCALE = 20, 16   # rmat scales, edge factor 16


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------- checks

@dataclasses.dataclass
class Check:
    name: str
    err: float
    tol: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.err) and self.err <= self.tol)


def rel_err(got, ref, metric: str = "max") -> float:
    """Error of ``got`` relative to the size of ``ref`` (see TOLS); inf on
    a shape mismatch or a non-finite result."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return float("inf")
    if got.size == 0:
        return 0.0
    if metric == "l2":
        return float(np.linalg.norm(got - ref) /
                     max(float(np.linalg.norm(ref)), 1e-30))
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    return float(np.max(np.abs(got - ref)) / scale)


def compare(name: str, got, ref, regime: str) -> Check:
    metric, tol, _ = TOLS[regime]
    c = Check(name, rel_err(got, ref, metric), tol)
    say(f"    {name:26s} {str(np.shape(got)):14s} {metric} err "
        f"{c.err:.3e} <= {tol:.0e} [{regime}]: {'ok' if c.ok else 'FAIL'}")
    return c


def require_gpu(devices) -> None:
    """Refuse a device list whose first device is not a GPU: this script
    never carries on on the CPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX's first device is {platform!r}")


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def time_call(fn, *args, reps: int = 5) -> tuple[float, float]:
    """(first call incl. compile, median of ``reps`` warm calls) in
    seconds, each ended by block_until_ready."""
    import jax

    t = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return first, float(np.median(times))


# ----------------------------------------------------- float64 references

def csr_matrix(rp, ci, data):
    import scipy.sparse as sp

    nv = len(rp) - 1
    return sp.csr_matrix((np.asarray(data, np.float64), ci, rp),
                         shape=(nv, nv))


def edge_dot(a, b, src, dst, chunk: int = 1 << 18) -> np.ndarray:
    """Per-edge <a[src_e], b[dst_e]> in float64, in chunks."""
    out = np.empty(len(src))
    for lo in range(0, len(src), chunk):
        s = slice(lo, lo + chunk)
        out[s] = np.einsum("ef,ef->e", a[src[s]], b[dst[s]])
    return out


def gat_reference(rp, ci, sl, sr, h, ct, dsw):
    """Unfused GAT attention in float64: logits leaky_relu(sl[src] +
    sr[dst], 0.2), softmax over each row, then aggregation; and the VJP
    for cotangent ``ct``. ``dsw`` is the per-edge <ct[src], h[dst]>.
    Returns (out, d_sl, d_sr, d_h)."""
    nv = len(rp) - 1
    deg = np.diff(rp)
    src = np.repeat(np.arange(nv), deg)
    raw = sl[src] + sr[ci]
    logit = np.where(raw > 0, raw, 0.2 * raw)
    m = np.full(nv, -np.inf)
    m[deg > 0] = np.maximum.reduceat(logit, rp[:-1][deg > 0])
    e = np.exp(logit - m[src])
    p = e / np.bincount(src, e, nv)[src]
    pm = csr_matrix(rp, ci, p)
    out = pm @ h
    inner = np.einsum("vf,vf->v", ct, out)
    dl = p * (dsw - inner[src]) * np.where(raw > 0, 1.0, 0.2)
    return (out, np.bincount(src, dl, nv), np.bincount(ci, dl, nv),
            pm.T @ ct)


# ------------------------------------------------------------ phases

def phase_device(count: int, cache_dir: str) -> dict:
    import jax

    from graphaibench_tpu import native

    devs = jax.devices()
    require_gpu(devs)
    if len(devs) < count:
        raise RuntimeError(f"needs {count} GPUs; JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    for line in smi.strip().splitlines():
        say(f"card: {line.strip()}")
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
        f"(platform {devs[0].platform})")
    say("native host library: " + ("built with g++" if native.available()
                                   else "not built; Python fallback ran"))
    say(f"compile cache: {cache_dir}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def kernel_checks(g, rng, *, time_paths: bool = False) -> list[Check]:
    """Every aggregation-op comparison on graph ``g`` (selfloops added,
    as the GNN layers aggregate)."""
    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.nn.model import GraphBundle
    from graphaibench_tpu.ops.device_graph import to_device_graph
    from graphaibench_tpu.ops.fused_gat import (V2_BF16_MIN_NV,
                                                gat_attention_spmm_v2)
    from graphaibench_tpu.ops.spmm import (_pick_impl, sddmm_add, sddmm_dot,
                                           spmm, spmm_coo, spmm_ell)

    prepped = T.add_selfloop(g)
    nv, ne = prepped.nv, prepped.ne
    rp, ci = prepped.row_ptr, prepped.col_idx
    src = np.repeat(np.arange(nv), np.diff(rp))
    w = T.gcn_edge_norms(prepped)
    x = rng.standard_normal((nv, FEAT), dtype=np.float32)
    ct = rng.standard_normal((nv, FEAT), dtype=np.float32)
    x64, ct64 = x.astype(np.float64), ct.astype(np.float64)

    t = time.perf_counter()
    gb = GraphBundle.build(g, "gcn")          # the training SpMM path
    dg = to_device_graph(prepped, seg_ell=False)   # COO + plain ELL (GAT)
    jax.block_until_ready((gb.device, gb.edge_w_agg, dg))
    impl = _pick_impl(gb.device, "auto")
    layout = ("dense" if impl == "dense" else
              "seg-ELL" if gb.device.seg_ell is not None else "plain ELL")
    say(f"  nv {nv} ne {ne} F {FEAT}: spmm path {layout}"
        f"{', packed weights' if gb.packed_w is not None else ''}; "
        f"bundles built and uploaded in {time.perf_counter() - t:.2f} s")

    checks = []
    xd, ctd, wd = jnp.asarray(x), jnp.asarray(ct), jnp.asarray(w)

    @jax.jit
    def spmm_fwd_bwd(dev, wv, xv, cv):
        out, vjp = jax.vjp(lambda z: spmm(dev, wv, z), xv)
        return out, vjp(cv)[0]

    first, _ = time_call(spmm_fwd_bwd, gb.device, gb.edge_w_agg, xd, ctd,
                         reps=1)
    out, dx = spmm_fwd_bwd(gb.device, gb.edge_w_agg, xd, ctd)
    a = csr_matrix(rp, ci, w)
    ref_out = a @ x64
    say(f"    spmm fwd+vjp first call {first:.2f} s")
    checks.append(compare("spmm forward", out, ref_out, "f32"))
    checks.append(compare("spmm vjp (A^T ct)", dx, a.T @ ct64, "f32"))
    del out, dx

    sa = rng.standard_normal(nv, dtype=np.float32)
    sb = rng.standard_normal(nv, dtype=np.float32)
    ce = rng.standard_normal(ne, dtype=np.float32)

    @jax.jit
    def sddmm_add_fwd_bwd(dev, av, bv, cv):
        out, vjp = jax.vjp(lambda p, q: sddmm_add(dev, p, q), av, bv)
        return out, vjp(cv)

    out, (dsa, dsb) = sddmm_add_fwd_bwd(dg, jnp.asarray(sa), jnp.asarray(sb),
                                        jnp.asarray(ce))
    checks.append(compare("sddmm_add forward", out,
                          sa[src].astype(np.float64) + sb[ci], "f32"))
    checks.append(compare("sddmm_add vjp (src rows)", dsa,
                          np.bincount(src, ce, nv), "f32"))
    checks.append(compare("sddmm_add vjp (dst rows)", dsb,
                          np.bincount(ci, ce, nv), "f32"))
    del out, dsa, dsb

    dsw = edge_dot(ct64, x64, src, ci)
    got = jax.jit(sddmm_dot)(dg, ctd, xd)
    checks.append(compare("sddmm_dot", got, dsw, "f32"))
    del got

    sl = rng.standard_normal(nv, dtype=np.float32)
    sr = rng.standard_normal(nv, dtype=np.float32)

    @jax.jit
    def gat_fwd_bwd(dev, p, q, h, cv):
        out, vjp = jax.vjp(
            lambda a_, b_, h_: gat_attention_spmm_v2(dev, a_, b_, h_), p, q, h)
        return out, vjp(cv)

    first, _ = time_call(gat_fwd_bwd, dg, jnp.asarray(sl), jnp.asarray(sr),
                         xd, ctd, reps=1)
    out, (dsl, dsr, dh) = gat_fwd_bwd(dg, jnp.asarray(sl), jnp.asarray(sr),
                                      xd, ctd)
    bf16 = nv >= V2_BF16_MIN_NV
    say(f"    gat v2 fwd+vjp first call {first:.2f} s; gathers in "
        f"{'bf16' if bf16 else 'f32'}")
    r_out, r_dsl, r_dsr, r_dh = gat_reference(
        rp, ci, sl.astype(np.float64), sr.astype(np.float64), x64, ct64, dsw)
    regime = "bf16" if bf16 else "f32"
    checks.append(compare("gat v2 forward", out, r_out, regime))
    checks.append(compare("gat v2 vjp d_sl", dsl, r_dsl, regime + "-adj"))
    checks.append(compare("gat v2 vjp d_sr", dsr, r_dsr, regime + "-adj"))
    checks.append(compare("gat v2 vjp d_h", dh, r_dh, regime))
    del out, dsl, dsr, dh

    if time_paths:
        paths = (
            ("training path", f"{layout}, packed weights", spmm, gb.device,
             gb.edge_w_agg),
            ("plain ELL", "plain ELL, per-edge weights", spmm_ell, dg, wd),
            ("COO", "COO gather + segment_sum", spmm_coo, dg, wd),
        )
        for short, name, fn, dev, wv in paths:
            f = jax.jit(fn)
            first, med = time_call(f, dev, wv, xd)
            checks.append(compare(f"spmm {short} forward", f(dev, wv, xd),
                                  ref_out, "f32"))
            say(f"    spmm timing, {name}: {med * 1e3:.2f} ms "
                f"({ne / med / 1e9:.3f} G edges/s; first call "
                f"{first:.2f} s)")
    return checks


def phase_kernels() -> bool:
    from graphaibench_tpu.graph.generators import rmat

    for regime, (metric, tol, why) in TOLS.items():
        say(f"  tolerance [{regime}]: {metric} err <= {tol:.0e}: {why}")
    ok = True
    for scale, ef, what in KERNEL_SIZES:
        say(f"  rmat({scale}, {ef}): {what}")
        t = time.perf_counter()
        g = rmat(scale, ef, seed=SEED)
        say(f"    generated in {time.perf_counter() - t:.2f} s")
        checks = kernel_checks(g, np.random.default_rng(SEED),
                               time_paths=scale == 20)
        ok &= all(c.ok for c in checks)
        say(f"    peak device memory so far: {peak_bytes() / 2**30:.2f} GiB")
        gc.collect()
    return ok


class _StampedStdout:
    """Tee for stdout that records when each line was written."""

    def __init__(self, sink):
        self.sink, self.buf, self.lines = sink, "", []

    def write(self, s):
        self.sink.write(s)
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)

    def flush(self):
        self.sink.flush()


def run_cli(fn, argv):
    """Run a cli command, echoing its output; returns (rc, t0, lines)."""
    out = _StampedStdout(sys.stdout)
    saved, sys.stdout = sys.stdout, out
    t0 = time.perf_counter()
    try:
        rc = fn(argv)
    finally:
        sys.stdout = saved
    return rc, t0, out.lines


def write_dataset(g, path: str, *, feat_len: int, num_classes: int,
                  seed: int = SEED) -> None:
    """A GNN dataset directory in the reference layout: random normal
    features, labels from a random linear teacher on the features (so
    there is something to learn), 60/20/20 train/val/test ranges."""
    from graphaibench_tpu.graph.csr import CSRGraph
    from graphaibench_tpu.graph.io import Meta, save_graph

    rng = np.random.default_rng(seed)
    nv = g.nv
    # features of std 0.1, about the size of normalised bag-of-words
    # features: at std 1 the recipe's lr 0.01 overshoots on the first
    # Adam step and the 5-epoch loss check reads noise
    feats = 0.1 * rng.standard_normal((nv, feat_len), dtype=np.float32)
    teacher = rng.standard_normal((feat_len, num_classes)).astype(np.float32)
    labels = np.argmax(feats @ teacher, axis=1).astype(np.uint8)
    a, b = int(nv * 0.6), int(nv * 0.8)
    meta = Meta(nv=nv, ne=g.ne, feat_len=feat_len,
                num_vertex_classes=num_classes, train=(0, a, a),
                val=(a, b, b - a), test=(b, nv, nv - b))
    save_graph(CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx,
                        vlabels=labels), path, meta=meta)
    feats.tofile(os.path.join(path, "graph.feats.bin"))


_EPOCH = re.compile(r"Epoch\s+(\d+) train_loss (\S+) train_acc \S+ "
                    r"time (\S+) s")


def train_summary(t0: float, lines) -> dict:
    """Set-up, compile and epoch times and the losses, read from the
    timestamped lines of ``cli train``: set-up runs from the call until
    epoch 0 starts (load, prepare, pack, upload); compile is epoch 0's
    time above the median later epoch."""
    t_first = None
    losses, times = [], []
    for t, line in lines:
        m = _EPOCH.match(line.strip())
        if m:
            losses.append(float(m.group(2)))
            times.append(float(m.group(3)))
            if t_first is None:
                t_first = t - times[0]
    steady = float(np.median(times[1:])) if len(times) > 1 else float("nan")
    return {
        "losses": losses,
        "setup_s": (t_first - t0) if t_first is not None else float("nan"),
        "compile_s": times[0] - steady if times else float("nan"),
        "epoch_s": steady,
    }


def phase_train() -> bool:
    from graphaibench_tpu import cli
    from graphaibench_tpu.graph.generators import rmat

    t = time.perf_counter()
    g = rmat(TRAIN_SCALE, 16, seed=SEED)
    path = os.path.join(DATA_DIR, f"rmat{TRAIN_SCALE}")
    write_dataset(g, path, feat_len=TRAIN_FEATS, num_classes=TRAIN_CLASSES)
    say(f"  dataset rmat({TRAIN_SCALE}, 16): nv {g.nv} ne {g.ne}, {TRAIN_FEATS} "
        f"features, {TRAIN_CLASSES} classes; generated and written in "
        f"{time.perf_counter() - t:.2f} s")
    del g
    ok = True
    for arch, hidden, layers in TRAIN_RUNS:
        argv = [arch, path, str(TRAIN_EPOCHS), "0", "softmax", hidden, "0",
                "0", "0.01", layers]
        say(f"  cli train {' '.join(argv)}")
        rc, t0, lines = run_cli(cli.cmd_train, argv)
        s = train_summary(t0, lines)
        losses = s["losses"]
        good = (rc == 0 and len(losses) == TRAIN_EPOCHS
                and all(np.isfinite(losses)) and losses[-1] < losses[0])
        say(f"  {arch} {layers}x{hidden}: set-up {s['setup_s']:.2f} s, "
            f"compile {s['compile_s']:.2f} s, epoch {s['epoch_s']:.4f} s, "
            f"loss {losses[0] if losses else None} -> "
            f"{losses[-1] if losses else None}, peak device memory so far "
            f"{peak_bytes() / 2**30:.2f} GiB: {'ok' if good else 'FAIL'}")
        ok &= good
        gc.collect()
    return ok


def phase_analytics() -> bool:
    from graphaibench_tpu import cli
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import save_graph

    g = rmat(ANALYTICS_SCALE, 16, seed=SEED)
    path = os.path.join(DATA_DIR, f"rmat{ANALYTICS_SCALE}")
    save_graph(g, path)
    ok = True
    for kernel in ("tc", "bfs", "pr"):
        rc, t0, lines = run_cli(cli.cmd_analytics, [kernel, path])
        good = rc == 0 and any(ln.strip() == "Correct" for _, ln in lines)
        say(f"  analytics {kernel} rmat({ANALYTICS_SCALE}, 16): "
            f"{time.perf_counter() - t0:.2f} s wall: "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def phase_four_cards() -> bool:
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__

    from graphaibench_tpu import cli
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import load_gnn_dataset
    from graphaibench_tpu.nn import Model, make_config

    t = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    say(f"  dryrun_multichip(4) passed in {time.perf_counter() - t:.2f} s")

    g = rmat(TRAIN_SCALE, 16, seed=SEED)
    path = os.path.join(DATA_DIR, f"rmat{TRAIN_SCALE}")
    write_dataset(g, path, feat_len=TRAIN_FEATS, num_classes=TRAIN_CLASSES)
    del g
    epochs = 3
    argv = ["gcn", path, str(epochs), "0", "softmax", "128", "0", "0",
            "0.01", "2"]
    os.environ["GAB_SHARDS"] = "4"
    try:
        rc, t0, lines = run_cli(cli.cmd_train, argv)
    finally:
        del os.environ["GAB_SHARDS"]
    sharded = [float(m.group(1)) for _, ln in lines
               if (m := re.match(r"Epoch\s+\d+: train_loss = (\S+)",
                                 ln.strip()))]
    say(f"  sharded gcn 2x128 over {len(jax.devices())} cards: "
        f"{time.perf_counter() - t0:.2f} s wall, losses {sharded}")

    ds = load_gnn_dataset(path)
    cfg = make_config("gcn", 2, ds.feat_len, 128, ds.num_classes, lr=0.01)
    model = Model(cfg, ds)
    single = [model.train_epoch()[0] for _ in range(epochs)]
    say(f"  single-device Model losses {single}")
    # the sharded losses print with 4 decimals: 5e-5 of rounding plus
    # f32 summation order across shards
    tol = 2e-4
    good = (rc == 0 and len(sharded) == epochs
            and all(abs(a - b) <= tol for a, b in zip(sharded, single)))
    say(f"  |sharded - single| <= {tol:.0e} per epoch: "
        f"{'ok' if good else 'FAIL'}")
    return good


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU sharded equality checks")
    args = ap.parse_args(argv)

    from graphaibench_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    count = 4 if args.four_cards else 1
    say("== device")
    try:
        device = phase_device(count, cache_dir)
    except Exception as e:  # noqa: BLE001 - report and fail the run
        say(f"chip_smoke: device phase failed: {type(e).__name__}: {e}")
        return 1
    os.makedirs(DATA_DIR, exist_ok=True)
    phases = ((("four_cards", phase_four_cards),) if args.four_cards else
              (("kernels", phase_kernels), ("train", phase_train),
               ("analytics", phase_analytics)))
    failed = []
    for name, fn in phases:
        say(f"== {name}")
        t = time.perf_counter()
        try:
            ok = fn()
        except Exception:  # noqa: BLE001 - record, run the next phase
            traceback.print_exc()
            ok = False
        say(f"== {name}: {'ok' if ok else 'FAILED'} in "
            f"{time.perf_counter() - t:.2f} s")
        if not ok:
            failed.append(name)
    if failed:
        say(f"chip_smoke: failed phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
