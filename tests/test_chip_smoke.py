"""CPU tests of chip_smoke.py's guards and comparators, the compile-cache
rule, and bench.py's refusal to run without a GPU.

The phases themselves need a GPU (chip_smoke.py refuses anything else);
here their comparators run at tiny shapes against the same float64
references, and must also fail on a perturbed result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("GAB_BENCH_PLATFORM", None)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=REPO)


def test_device_guard_refuses_cpu():
    import jax

    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu([])


def test_script_on_cpu_exits_nonzero_without_result():
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stdout


@pytest.mark.parametrize("regime", sorted(chip_smoke.TOLS))
def test_compare_passes_within_and_fails_past_tolerance(regime):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((64, 8))
    tol = chip_smoke.TOLS[regime][1]
    assert chip_smoke.compare("ok", ref * (1 + tol / 4), ref, regime).ok
    assert not chip_smoke.compare("off", ref * (1 + 4 * tol), ref,
                                  regime).ok
    bad = ref.copy()
    bad[3, 3] = np.nan
    assert not chip_smoke.compare("nan", bad, ref, regime).ok
    assert not chip_smoke.compare("shape", ref[:-1], ref, regime).ok


# (scale, edge factor): dense strategy (nv <= 4096) and plain ELL
_TINY = [(7, 8), (13, 2)]


@pytest.mark.parametrize("scale,ef", _TINY)
def test_kernel_checks_pass_at_tiny_shapes(scale, ef):
    from graphaibench_tpu.graph.generators import rmat

    checks = chip_smoke.kernel_checks(rmat(scale, ef, seed=1),
                                      np.random.default_rng(1))
    assert len(checks) == 10
    assert all(c.ok for c in checks), [c for c in checks if not c.ok]


@pytest.mark.parametrize("scale,ef", _TINY)
def test_kernel_checks_fail_on_perturbed_spmm(monkeypatch, scale, ef):
    import importlib

    from graphaibench_tpu.graph.generators import rmat

    # the package re-exports the function under the module's name
    spmm_mod = importlib.import_module("graphaibench_tpu.ops.spmm")

    real = spmm_mod.spmm
    monkeypatch.setattr(spmm_mod, "spmm",
                        lambda g, w, x, impl="auto":
                        real(g, w, x, impl) * 1.001)
    checks = {c.name: c for c in chip_smoke.kernel_checks(
        rmat(scale, ef, seed=1), np.random.default_rng(1))}
    assert not checks["spmm forward"].ok
    assert not checks["spmm vjp (A^T ct)"].ok
    assert checks["sddmm_dot"].ok


def test_kernel_checks_fail_on_perturbed_gat(monkeypatch):
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops import fused_gat

    real = fused_gat.gat_attention_spmm_v2
    monkeypatch.setattr(fused_gat, "gat_attention_spmm_v2",
                        lambda g, sl, sr, h: real(g, sl * 1.01, sr, h))
    checks = {c.name: c for c in chip_smoke.kernel_checks(
        rmat(7, 8, seed=1), np.random.default_rng(1))}
    assert not checks["gat v2 forward"].ok
    assert checks["spmm forward"].ok


def test_train_summary_reads_cli_lines():
    t0 = 100.0
    lines = [(101.0, "num_vertices = 8, num_edges = 16, num_layers = 2,"),
             (110.0, "Epoch   0 train_loss 3.850 train_acc 0.020 "
                     "time 5.0000 s"),
             (110.5, "Epoch   1 train_loss 3.700 train_acc 0.030 "
                     "time 0.5000 s"),
             (111.1, "Epoch   2 train_loss 3.600 train_acc 0.040 "
                     "time 0.6000 s")]
    s = chip_smoke.train_summary(t0, lines)
    assert s["losses"] == [3.85, 3.7, 3.6]
    assert s["setup_s"] == pytest.approx(5.0)       # 105.0 - 100.0
    assert s["epoch_s"] == pytest.approx(0.55)
    assert s["compile_s"] == pytest.approx(4.45)


def test_write_dataset_round_trips_through_the_loader(tmp_path):
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import load_gnn_dataset

    g = rmat(8, 4, seed=0)
    chip_smoke.write_dataset(g, str(tmp_path), feat_len=6, num_classes=5)
    ds = load_gnn_dataset(str(tmp_path))
    assert ds.feats.shape == (g.nv, 6) and ds.num_classes == 5
    assert ds.labels.min() >= 0 and ds.labels.max() < 5
    a = int(g.nv * 0.6)
    assert ds.train_range == (0, a, a)
    np.testing.assert_array_equal(ds.graph.col_idx, g.col_idx)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    import jax

    from graphaibench_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    from graphaibench_tpu.utils import compile_cache

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


_CACHE_PROBE = (
    "import sys\n"
    "import graphaibench_tpu.utils.compile_cache as c\n"
    "if len(sys.argv) > 1: c.CHECKOUT = sys.argv[1]\n"
    "c.enable_compile_cache()\n"
    "import jax, jax.numpy as jnp\n"
    "jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)).block_until_ready()\n")


@pytest.mark.parametrize("with_env", [True, False])
def test_compile_cache_lands_where_the_rule_says(tmp_path, with_env):
    env = {"JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
    if with_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "env")
        args, where = [], tmp_path / "env"
    else:
        args, where = [str(tmp_path)], tmp_path / ".jax_cache"
    extra = dict(os.environ, **env)
    if not with_env:
        extra.pop("JAX_COMPILATION_CACHE_DIR", None)
    p = subprocess.run([sys.executable, "-c", _CACHE_PROBE, *args],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=dict(extra, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-800:]
    assert where.is_dir() and any(where.iterdir())


def test_bench_refuses_a_non_gpu_backend():
    p = _run(["bench.py"])
    assert p.returncode != 0
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert rec["value"] is None
    assert "needs platform 'gpu'" in rec["errors"]["backend_init"]
    assert rec["extra"]["platform"] == "cpu"
