"""Segment-scanned bucket sweeps (device_graph.seg_sweep).

The UNROLLED segmented layout grows O(S * buckets) gather stages; the
sweep runs as one lax.scan body over [S]-stacked uniform bucket tables
instead (6.6x smaller StableHLO at S=8).

These tests pin (a) scan == unrolled == plain for every op routed
through seg_sweep, including gradients, and (b) that the scanned
program is actually smaller.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from graphaibench_tpu.graph import transforms as T  # noqa: E402
from graphaibench_tpu.graph.generators import rmat  # noqa: E402
from graphaibench_tpu.ops.device_graph import (  # noqa: E402
    build_seg_ell,
    pack_edge_values,
    to_device_graph,
)

S = importlib.import_module("graphaibench_tpu.ops.spmm")


def _build_graphs():
    g = T.symmetrize(rmat(10, 5, seed=1))
    dg = to_device_graph(g, seg_ell=False)
    dg_seg = dataclasses.replace(dg, seg_ell=build_seg_ell(g, seg_rows=200),
                                 ell=())
    return g, dg, dg_seg


@pytest.fixture()
def graphs():
    return _build_graphs()


def _scan_env(monkeypatch, on: bool):
    monkeypatch.setenv("GAB_SEG_SCAN", "1" if on else "0")


@pytest.mark.parametrize("scan", [False, True])
def test_spmm_seg_scan_matches_plain(graphs, scan, monkeypatch):
    g, dg, dg_seg, = graphs
    _scan_env(monkeypatch, scan)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, 24)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))
    ref = S.spmm_coo(dg, w, x)
    np.testing.assert_allclose(np.asarray(S.spmm_ell(dg_seg, w, x)),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)
    wp = pack_edge_values(dg_seg, w)
    np.testing.assert_allclose(np.asarray(S.spmm(dg_seg, wp, x, impl="ell")),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)
    gx1 = jax.grad(lambda xx: (S.spmm(dg_seg, wp, xx, impl="ell") ** 2).sum())(x)
    gx2 = jax.grad(lambda xx: (S.spmm(dg, w, xx, impl="coo") ** 2).sum())(x)
    np.testing.assert_allclose(np.asarray(gx1), np.asarray(gx2),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("scan", [False, True])
def test_gat_v2_seg_scan_matches_unfused(graphs, scan, monkeypatch):
    from graphaibench_tpu.ops.fused_gat import gat_attention_spmm_v2
    from graphaibench_tpu.ops.segment import segment_softmax

    g, dg, dg_seg = graphs
    _scan_env(monkeypatch, scan)
    rng = np.random.default_rng(1)
    h = jnp.asarray(rng.standard_normal((g.nv, 24)).astype(np.float32))
    sl = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    sr = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))

    def ref(slx, srx, hx):
        logits = S.sddmm_add(dg, slx, srx)
        logits = jnp.where(logits > 0, logits, 0.2 * logits)
        return S.spmm(dg, segment_softmax(dg, logits), hx, impl="coo")

    np.testing.assert_allclose(
        np.asarray(gat_attention_spmm_v2(dg_seg, sl, sr, h)),
        np.asarray(ref(sl, sr, h)), rtol=3e-5, atol=3e-5)
    g1 = jax.grad(lambda *a: (gat_attention_spmm_v2(dg_seg, *a) ** 2).sum(),
                  argnums=(0, 1, 2))(sl, sr, h)
    g2 = jax.grad(lambda *a: (ref(*a) ** 2).sum(),
                  argnums=(0, 1, 2))(sl, sr, h)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("scan", [False, True])
def test_neighbor_reduce_seg_scan(graphs, scan, monkeypatch):
    from graphaibench_tpu.ops.segment import (
        neighbor_reduce,
        pack_neighbor_edge_vals,
    )

    g, dg, dg_seg = graphs
    _scan_env(monkeypatch, scan)
    rng = np.random.default_rng(2)
    vals = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    evals = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))
    for kind in ("min", "max", "sum"):
        ref = neighbor_reduce(dg, vals, kind, evals)
        got = neighbor_reduce(dg_seg, vals, kind,
                              pack_neighbor_edge_vals(dg_seg, evals))
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)


def test_scan_program_is_smaller(graphs, monkeypatch):
    """The whole point: scanned fwd+bwd StableHLO must be several times
    smaller than unrolled (the remote helper's ceiling scales with it)."""
    g, dg, dg_seg = graphs
    w = jnp.ones(g.ne, jnp.float32)
    wp = pack_edge_values(dg_seg, w)
    x = jnp.zeros((g.nv, 16), jnp.float32)

    def step(dgx, wpx, xx):
        y = S.spmm(dgx, wpx, xx, impl="ell")
        return (S.spmm(dgx, wpx, jnp.tanh(y), impl="ell") ** 2).sum()

    # pin uniform stacking: on this tiny graph the grouped default cuts
    # segments into ~single-segment groups (zero pad, inline stages), so
    # the scan-vs-unroll mechanism is only visible on uniform stacks; at
    # scale the groups hold many segments each and the compression
    # returns (the pad/program tradeoff is GAB_SEG_GROUPS)
    monkeypatch.setenv("GAB_SEG_GROUPS", "1")
    g2, dg2, dg_seg2 = _build_graphs()
    wp2 = pack_edge_values(dg_seg2, jnp.ones(g2.ne, jnp.float32))
    x2 = jnp.zeros((g2.nv, 16), jnp.float32)
    sizes = {}
    for env in ("0", "1"):
        monkeypatch.setenv("GAB_SEG_SCAN", env)
        low = jax.jit(jax.grad(step, argnums=2)).lower(dg_seg2, wp2, x2)
        sizes[env] = len(low.as_text())
    assert sizes["1"] * 2 < sizes["0"], sizes
