"""Headline benchmark: SpMM edges/s (the BASELINE.json north-star kernel
metric) on a power-law RMAT graph, plus full GCN/GAT epoch times at
rmat17 and rmat20.

Prints ONE JSON record per line, cumulative, after every section:
  {"metric": "spmm_edges_per_s", "value": ..., "unit": "edges/s",
   "vs_baseline": <fraction of a pure row-gather of the same slots>,
   "extra": {..., "platform", "device_kind", "device_count"}}

The run needs a GPU: it exits non-zero when JAX's first device is not
one, unless ``GAB_BENCH_PLATFORM`` names the platform to accept (the
CPU tests set ``cpu``). Every section runs under _section(), which
stashes its numbers as they are produced and turns an exception into an
``errors`` entry, so the sections already measured still print; the run
then exits non-zero. Sections that would start past
``GAB_BENCH_BUDGET_S`` are skipped and listed.

Methodology: every timing runs K iterations INSIDE one jit via
lax.fori_loop and ends in block_until_ready, median of 3. vs_baseline
divides the SpMM rate by the rate of a pure weighted row-gather of the
same padded slot count: an SpMM cannot beat the gather that feeds it.
The reference publishes no absolute GNN numbers (src/gnn/README.md
"TBD")."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np

EXTRA: dict = {}
ERRORS: dict = {}
HEADLINE: dict = {"edges_per_s": None, "sol_edges_per_s": None}

# test hooks (tests/test_bench_harness.py): force a section to throw /
# shrink graph sizes so the error handling itself is testable on CPU
_FAULTS = set(filter(None, os.environ.get("GAB_BENCH_FAULT", "").split(",")))

# wall-clock budget for the WHOLE bench run: sections that would start
# past it are skipped, and the record printed after every section keeps
# everything measured so far if the run is cut
_T_START = time.perf_counter()
_BUDGET_S = float(os.environ.get("GAB_BENCH_BUDGET_S", "1500"))


def _elapsed() -> float:
    return time.perf_counter() - _T_START


def _maybe_fault(name: str):
    if name in _FAULTS:
        raise RuntimeError(f"injected fault ({name})")


class _SkipSection(Exception):
    pass


def _emit():
    """Print the cumulative record as one JSON line (the last JSON line
    on stdout is the result)."""
    value = HEADLINE["edges_per_s"]
    sol = HEADLINE["sol_edges_per_s"]
    record = {
        "metric": "spmm_edges_per_s",
        "value": None if value is None else float(value),
        "unit": "edges/s",
        "vs_baseline": (None if value is None or not sol
                        else float(value / sol)),
        "extra": EXTRA,
    }
    if ERRORS:
        record["errors"] = ERRORS
    print(json.dumps(record), flush=True)


@contextlib.contextmanager
def _section(name: str):
    """Run one bench section; on failure record the error and move on so
    the sections already measured still reach the printed record.
    Yields a fault-check callable the body invokes first (test hook)."""
    t0 = time.perf_counter()

    def _gate():
        # a section that would START past the budget is skipped
        if _elapsed() > _BUDGET_S:
            raise _SkipSection
        _maybe_fault(name)

    try:
        yield _gate
        print(f"[bench] {name} ok ({time.perf_counter() - t0:.1f}s)",
              file=sys.stderr)
    except _SkipSection:
        EXTRA.setdefault("skipped_over_budget", []).append(name)
        print(f"[bench] {name} SKIPPED: over budget "
              f"({_elapsed():.0f}s > {_BUDGET_S:.0f}s)", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - recorded; the run exits non-zero
        ERRORS[name] = f"{type(e).__name__}: {e}"[:300]
        print(f"[bench] {name} FAILED: {ERRORS[name]}", file=sys.stderr)
    _emit()


def _init_backend() -> bool:
    """Bring up JAX's backend once and record which devices run the
    bench. False (with an ``errors`` entry) when it fails or when the
    first device is not of the required platform."""
    from graphaibench_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    want = os.environ.get("GAB_BENCH_PLATFORM", "gpu")
    try:
        import jax

        devs = jax.devices()
    except Exception as e:  # noqa: BLE001 - reported in the record
        ERRORS["backend_init"] = f"{type(e).__name__}: {e}"[:300]
        return False
    EXTRA.update(platform=devs[0].platform, device_kind=devs[0].device_kind,
                 device_count=len(devs))
    print(f"[bench] backend up: {devs[0].platform} x{len(devs)}",
          file=sys.stderr)
    if devs[0].platform != want:
        ERRORS["backend_init"] = (f"needs platform {want!r}; JAX's first "
                                  f"device is {devs[0].platform!r}")
        return False
    return True


def _bench_looped(f, init, iters, *args):
    """Median-of-3 timed runs of ``iters`` chained iterations inside one
    jit, each ended by block_until_ready. Every array/pytree operand
    rides in ``*args``: a closed-over device array would be embedded in
    the compiled program as a constant."""
    import jax

    run = jax.jit(lambda c, *a: jax.lax.fori_loop(
        0, iters, lambda i, v: f(i, v, *a), c))
    jax.block_until_ready(run(init, *args))  # compile + warm up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(init, *args))
        times.append((time.perf_counter() - t0) / iters)
    return sorted(times)[1]


def _timed_epochs(model, epochs):
    """One compile pass, one timed pass (train_epochs syncs on its
    losses)."""
    model.train_epochs(epochs)  # compile
    t0 = time.perf_counter()
    model.train_epochs(epochs)
    return (time.perf_counter() - t0) / epochs


def main() -> int:
    headline = HEADLINE

    if _init_backend():
        import jax.numpy as jnp

        from graphaibench_tpu.graph.generators import rmat
        from graphaibench_tpu.graph.io import GnnDataset
        from graphaibench_tpu.nn.layers import ModelConfig
        from graphaibench_tpu.nn.model import GraphBundle, Model
        from graphaibench_tpu.ops.spmm import spmm_ell

        scale = int(os.environ.get("GAB_BENCH_SCALE", "17"))
        ef, feat = (16, 128) if scale >= 17 else (8, 16)
        scale20 = int(os.environ.get("GAB_BENCH_SCALE20", "20"))
        ef20 = 32 if scale20 >= 20 else 8
        rng = np.random.default_rng(0)
        g = gb = x = ds = None

        def make_ds(graph, feats):
            labels = rng.integers(0, 16, graph.nv).astype(np.int32)
            mask = np.ones(graph.nv, dtype=np.uint8)
            tr = (0, graph.nv, graph.nv)
            return GnnDataset(graph=graph, feats=np.asarray(feats),
                              labels=labels, train_mask=mask, val_mask=mask,
                              test_mask=mask, num_classes=16, train_range=tr,
                              val_range=tr, test_range=tr)

        with _section("rmat17_spmm") as chk:
            chk()
            g = rmat(scale, ef, seed=0, cache=True)
            gb = GraphBundle.build(g, "gcn")
            nv, ne = gb.host.nv, gb.host.ne
            x = jnp.asarray(rng.standard_normal((nv, feat)).astype(np.float32))
            # SpMM throughput (best strategy for this size: ELL; packed
            # static weights = the production training path)
            dt = _bench_looped(
                lambda i, v, dg, w: spmm_ell(dg, w, v), x, 20,
                gb.device, gb.edge_w_agg)
            headline["edges_per_s"] = ne / dt
            from graphaibench_tpu.ops.device_graph import iter_buckets_sliced
            slots = sum(b.nbr.size for b, _ in iter_buckets_sliced(gb.device))
            EXTRA["graph"] = f"rmat{scale} nv={nv} ne={ne} feat={feat}"
            EXTRA["spmm_ms"] = dt * 1e3
            EXTRA["ell_padding_overhead"] = slots / ne

        with _section("rmat17_roofline") as chk:
            chk()
            # pure weighted row-gather of the same number of padded rows
            # (iteration-dependent indices defeat constant-folding)
            from graphaibench_tpu.ops.device_graph import iter_buckets_sliced
            slots = sum(b.nbr.size for b, _ in iter_buckets_sliced(gb.device))
            idx = jnp.asarray(rng.integers(0, g.nv, slots).astype(np.int32))
            wg = jnp.asarray(rng.standard_normal(slots).astype(np.float32))

            def gather_only(i, acc, xs, idxs, wgs):
                shifted = (idxs + i) % g.nv
                return acc + (xs[shifted] * wgs[:, None]).sum(0)

            dt_g = _bench_looped(gather_only, jnp.zeros(feat), 10, x, idx, wg)
            gather_rows_per_s = slots / dt_g
            headline["sol_edges_per_s"] = gather_rows_per_s * g.ne / slots
            EXTRA["gather_rows_per_s"] = float(gather_rows_per_s)
            EXTRA["sol_edges_per_s"] = float(headline["sol_edges_per_s"])

        with _section("rmat17_gcn_epoch") as chk:
            chk()
            ds = make_ds(g, x)
            cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=feat,
                              dim_hid=128, num_cls=16, lr=0.01)
            EXTRA["gcn_epoch_s"] = _timed_epochs(Model(cfg, ds), 10)

        with _section("rmat17_gat_epoch") as chk:
            chk()
            cfg_gat = ModelConfig(arch="gat", num_layers=2, dim_init=feat,
                                  dim_hid=128, num_cls=16, lr=0.01)
            EXTRA["gat_epoch_s"] = _timed_epochs(Model(cfg_gat, ds), 10)

        # --- scale regime: rmat20 (1M v / 32M e). Each section is
        # isolated so a failure here never erases the rmat17 record.
        import gc

        del gb, ds
        # every big object is cleared AFTER its section whether or not
        # the section threw, so a failed body's buffers are freed before
        # the next section allocates
        g20 = x20 = ds20 = gb20 = None
        gc.collect()

        with _section("rmat20_spmm") as chk:
            chk()
            g20 = rmat(scale20, ef20, seed=0)
            gb20 = GraphBundle.build(g20, "gcn")
            x20 = jnp.asarray(
                rng.standard_normal((g20.nv, feat)).astype(np.float32))
            dt20 = _bench_looped(
                lambda i, v, dg, w: spmm_ell(dg, w, v), x20, 5,
                gb20.device, gb20.edge_w_agg)
            EXTRA["rmat20_spmm_ms"] = dt20 * 1e3
            EXTRA["rmat20_spmm_edges_per_s"] = g20.ne / dt20
        gb20 = None
        gc.collect()

        def _epoch(arch, key):
            cfg = ModelConfig(arch=arch, num_layers=2, dim_init=feat,
                              dim_hid=128, num_cls=16, lr=0.01)
            model = Model(cfg, ds20)
            EXTRA[key + "_layout"] = (
                "seg_ell" if model.training.device.seg_ell is not None
                else "plain_ell")
            EXTRA[key] = _timed_epochs(model, 3)

        with _section("rmat20_gcn_epoch") as chk:
            chk()
            ds20 = make_ds(g20, x20)
            x20 = None
            gc.collect()
            _epoch("gcn", "rmat20_gcn_epoch_s")
        gc.collect()

        with _section("rmat20_gat_epoch") as chk:
            chk()
            if ds20 is None:
                raise RuntimeError(
                    "rmat20 dataset unavailable (gcn section failed)")
            _epoch("gat", "rmat20_gat_epoch_s")
        gc.collect()

    _emit()  # final (same cumulative record the last section printed)
    return 1 if ERRORS else 0


if __name__ == "__main__":
    sys.exit(main())
