"""Sparse-op tests: every strategy vs a scipy/numpy serial oracle — the
reference's verifier pattern (SURVEY.md §4) as pytest."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphaibench_tpu.graph import transforms as T
from graphaibench_tpu.graph.csr import from_edges
from graphaibench_tpu.graph.generators import rmat, uniform_random
from graphaibench_tpu.ops.device_graph import to_device_graph
from graphaibench_tpu.ops.rng import glorot_reference
from graphaibench_tpu.ops.segment import segment_softmax, segment_softmax_vjp
from graphaibench_tpu.ops.spmm import (
    sddmm_add,
    sddmm_dot,
    spmm,
    spmm_coo,
    spmm_dense,
    spmm_ell,
)


def spmm_oracle(g, w, x):
    """Serial gather loop — gcn_aggregator.cpp:48-77 semantics."""
    out = np.zeros((g.nv, x.shape[1]), dtype=np.float64)
    src, dst = g.coo()
    for e in range(g.ne):
        out[src[e]] += w[e] * x[dst[e]]
    return out


@pytest.fixture(scope="module")
def small_graph():
    g = uniform_random(200, 600, seed=3)
    return g


@pytest.fixture(scope="module")
def skewed_graph():
    return rmat(9, 8, seed=7)  # power-law, 512 vertices


@pytest.mark.parametrize("impl", [spmm_coo, spmm_ell, spmm_dense])
def test_spmm_impls_match_oracle(small_graph, impl, rng):
    g = small_graph
    dg = to_device_graph(g)
    x = rng.standard_normal((g.nv, 16)).astype(np.float32)
    w = rng.standard_normal(g.ne).astype(np.float32)
    out = np.asarray(impl(dg, jnp.asarray(w), jnp.asarray(x)))
    ref = spmm_oracle(g, w, x)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_spmm_skewed_ell(skewed_graph, rng):
    g = skewed_graph
    dg = to_device_graph(g)
    x = rng.standard_normal((g.nv, 8)).astype(np.float32)
    w = np.ones(g.ne, dtype=np.float32)
    out = np.asarray(spmm_ell(dg, jnp.asarray(w), jnp.asarray(x)))
    ref = spmm_oracle(g, w, x)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_spmm_custom_vjp_matches_ad(small_graph, rng):
    """custom_vjp (transpose-permutation adjoint) vs plain-AD segment_sum."""
    g = small_graph
    dg = to_device_graph(g)
    x = jnp.asarray(rng.standard_normal((g.nv, 8)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))

    def f_custom(w, x):
        return jnp.sum(spmm(dg, w, x, "coo") ** 2)

    def f_plain(w, x):
        return jnp.sum(spmm_coo(dg, w, x) ** 2)

    gw1, gx1 = jax.grad(f_custom, argnums=(0, 1))(w, x)
    gw2, gx2 = jax.grad(f_plain, argnums=(0, 1))(w, x)
    np.testing.assert_allclose(np.asarray(gx1), np.asarray(gx2), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gw1), np.asarray(gw2), rtol=1e-3, atol=1e-4)


def test_gcn_aggregate_parity_with_reference_loop(small_graph, rng):
    """Full GCN aggregation: norms * gather, reference update_all oracle."""
    g = T.add_selfloop(small_graph)
    dg = to_device_graph(g)
    w = jnp.asarray(T.gcn_edge_norms(g))
    x = rng.standard_normal((g.nv, 12)).astype(np.float32)
    out = np.asarray(spmm(dg, w, jnp.asarray(x)))
    # oracle: out[src] = sum_e a_src*a_dst*x[dst]
    vn = T.gcn_vertex_norms(g)
    ref = np.zeros_like(out, dtype=np.float64)
    for v in range(g.nv):
        for d in g.neighbors(v):
            ref[v] += vn[v] * vn[d] * x[d]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_segment_softmax(small_graph, rng):
    g = small_graph
    dg = to_device_graph(g)
    s = rng.standard_normal(g.ne).astype(np.float32)
    y = np.asarray(segment_softmax(dg, jnp.asarray(s)))
    # oracle per row
    for v in range(g.nv):
        b, e = g.row_ptr[v], g.row_ptr[v + 1]
        if e > b:
            row = s[b:e]
            ex = np.exp(row - row.max())
            np.testing.assert_allclose(y[b:e], ex / ex.sum(), rtol=1e-5, atol=1e-6)


def test_segment_softmax_vjp(small_graph, rng):
    g = small_graph
    dg = to_device_graph(g)
    s = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))

    def f(s):
        return jnp.sum(jnp.sin(segment_softmax(dg, s)))

    auto = jax.grad(f)(s)
    y = segment_softmax(dg, s)
    dy = jnp.cos(y)
    manual = segment_softmax_vjp(dg, y, dy)
    np.testing.assert_allclose(np.asarray(auto), np.asarray(manual), rtol=1e-4, atol=1e-5)


def test_sddmm(small_graph, rng):
    g = small_graph
    dg = to_device_graph(g)
    a = rng.standard_normal((g.nv, 6)).astype(np.float32)
    b = rng.standard_normal((g.nv, 6)).astype(np.float32)
    dots = np.asarray(sddmm_dot(dg, jnp.asarray(a), jnp.asarray(b)))
    src, dst = g.coo()
    ref = np.einsum("ef,ef->e", a[src], b[dst])
    np.testing.assert_allclose(dots, ref, rtol=1e-4, atol=1e-5)
    sa = rng.standard_normal(g.nv).astype(np.float32)
    sb = rng.standard_normal(g.nv).astype(np.float32)
    adds = np.asarray(sddmm_add(dg, jnp.asarray(sa), jnp.asarray(sb)))
    np.testing.assert_allclose(adds, sa[src] + sb[dst], rtol=1e-6)


def test_glorot_reference_values():
    """Bit-exact against libstdc++ default_random_engine(1) +
    uniform_real_distribution<float> (verified against compiled g++)."""
    w = glorot_reference(4, 5, 1)
    assert w.shape == (4, 5)
    np.testing.assert_allclose(
        w.ravel()[:5],
        [-0.81648386, -0.60169625, 0.4174018, -0.06752402, 0.0535087],
        rtol=1e-6,
    )
    r = np.sqrt(6.0 / 9)
    assert np.all(np.abs(w) <= r)


def test_isolated_vertices_spmm():
    g = from_edges([0, 1], [1, 0], 4)  # vertices 2,3 isolated
    dg = to_device_graph(g)
    x = jnp.ones((4, 4), dtype=jnp.float32)
    out = np.asarray(spmm(dg, jnp.ones(2, dtype=jnp.float32), x))
    np.testing.assert_array_equal(out[2:], 0.0)
    np.testing.assert_array_equal(out[:2], 1.0)


def test_fused_gat_attention_matches_unfused():
    """gat_attention_spmm (fused softmax+SpMM, custom VJP) must equal the
    segment_softmax + spmm composition in values AND gradients."""
    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import to_device_graph
    from graphaibench_tpu.ops.fused_gat import gat_attention_spmm
    from graphaibench_tpu.ops.segment import segment_softmax
    from graphaibench_tpu.ops.spmm import spmm

    g = rmat(8, 8, seed=3)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, 16)).astype(np.float32))
    logits = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))
    ew = jnp.ones(g.ne, jnp.float32)

    ref = spmm(dg, segment_softmax(dg, logits) * ew, x, "ell")
    got = gat_attention_spmm(dg, logits, ew, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)

    def loss_ref(l, xx):
        return (spmm(dg, segment_softmax(dg, l) * ew, xx, "ell") ** 2).sum()

    def loss_fused(l, xx):
        return (gat_attention_spmm(dg, l, ew, xx) ** 2).sum()

    gl_r, gx_r = jax.grad(loss_ref, argnums=(0, 1))(logits, x)
    gl_f, gx_f = jax.grad(loss_fused, argnums=(0, 1))(logits, x)
    np.testing.assert_allclose(np.asarray(gl_f), np.asarray(gl_r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gx_f), np.asarray(gx_r),
                               rtol=1e-4, atol=1e-4)


def test_fused_gat_respects_edge_mask():
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import to_device_graph
    from graphaibench_tpu.ops.fused_gat import gat_attention_spmm
    from graphaibench_tpu.ops.segment import segment_softmax
    from graphaibench_tpu.ops.spmm import spmm

    g = rmat(7, 8, seed=5)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((g.nv, 8)).astype(np.float32))
    logits = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))
    ew = jnp.asarray((rng.random(g.ne) > 0.3).astype(np.float32))
    ref = spmm(dg, segment_softmax(dg, logits) * ew, x, "ell")
    got = gat_attention_spmm(dg, logits, ew, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_sddmm_add_custom_vjp():
    """sddmm_add's streaming adjoint must equal the autodiff scatter."""
    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import to_device_graph
    from graphaibench_tpu.ops.spmm import sddmm_add

    g = rmat(7, 8, seed=2)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    rng = np.random.default_rng(0)
    sa = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    sb = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    w = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))

    def loss(sa, sb):
        return (sddmm_add(dg, sa, sb) * w).sum()

    ga, gb = jax.grad(loss, argnums=(0, 1))(sa, sb)
    # oracle: explicit scatter
    src, dst = g.coo()
    exp_a = np.zeros(g.nv, np.float32)
    np.add.at(exp_a, src, np.asarray(w))
    exp_b = np.zeros(g.nv, np.float32)
    np.add.at(exp_b, dst, np.asarray(w))
    np.testing.assert_allclose(np.asarray(ga), exp_a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb), exp_b, rtol=1e-5, atol=1e-5)


def test_segmented_ell_spmm_matches_coo():
    """Column-segmented layout (large-graph path) must equal coo/ell."""
    import dataclasses

    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import build_seg_ell, to_device_graph
    from graphaibench_tpu.ops.spmm import spmm_coo, spmm_ell

    g = rmat(9, 8, seed=4)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    # force multiple segments on a small graph
    seg = build_seg_ell(g, seg_rows=100)
    dgs = dataclasses.replace(dg, seg_ell=seg)
    assert len(seg.bounds) > 3
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, 24)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))
    ref = spmm_coo(dg, w, x)
    np.testing.assert_allclose(np.asarray(spmm_ell(dgs, w, x)),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_segmented_fused_gat_matches_unfused():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import build_seg_ell, to_device_graph
    from graphaibench_tpu.ops.fused_gat import gat_attention_spmm
    from graphaibench_tpu.ops.segment import segment_softmax
    from graphaibench_tpu.ops.spmm import spmm

    g = rmat(8, 8, seed=6)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    dgs = dataclasses.replace(dg, seg_ell=build_seg_ell(g, seg_rows=64))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((g.nv, 16)).astype(np.float32))
    logits = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))
    ew = jnp.ones(g.ne, jnp.float32)
    ref = spmm(dg, segment_softmax(dg, logits) * ew, x, "ell")
    got = gat_attention_spmm(dgs, logits, ew, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    gl_f = jax.grad(lambda l: gat_attention_spmm(dgs, l, ew, x).sum())(logits)
    gl_r = jax.grad(
        lambda l: spmm(dg, segment_softmax(dg, l) * ew, x, "ell").sum())(logits)
    np.testing.assert_allclose(np.asarray(gl_f), np.asarray(gl_r),
                               rtol=1e-4, atol=1e-4)


def test_gat_v2_matches_v1_with_grads():
    """gat_attention_spmm_v2 (slot-space: logits never materialized) must
    equal the v1 fused path in values and in (sl, sr, h) gradients, on
    both the plain-ELL and the column-segmented layouts."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops import math as gmath
    from graphaibench_tpu.ops.device_graph import build_seg_ell, to_device_graph
    from graphaibench_tpu.ops.fused_gat import (
        gat_attention_spmm,
        gat_attention_spmm_v2,
    )
    from graphaibench_tpu.ops.spmm import sddmm_add

    g = rmat(8, 8, seed=3)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    dgs = dataclasses.replace(dg, seg_ell=build_seg_ell(g, seg_rows=64))
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.standard_normal((g.nv, 16)).astype(np.float32))
    sl = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    sr = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    ew = jnp.ones(g.ne, jnp.float32)

    def v1(sl_, sr_, h_, d):
        logits = gmath.leaky_relu(sddmm_add(d, sl_, sr_), 0.2)
        return gat_attention_spmm(d, logits, ew, h_)

    for d in (dg, dgs):
        got = gat_attention_spmm_v2(d, sl, sr, h)
        ref = v1(sl, sr, h, dg)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)

        loss_v2 = lambda a, b, x: (gat_attention_spmm_v2(d, a, b, x) ** 2).sum()
        loss_v1 = lambda a, b, x: (v1(a, b, x, dg) ** 2).sum()
        g2 = jax.grad(loss_v2, argnums=(0, 1, 2))(sl, sr, h)
        g1 = jax.grad(loss_v1, argnums=(0, 1, 2))(sl, sr, h)
        for a, b, name in zip(g2, g1, ("dsl", "dsr", "dh")):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def test_gat_v2_bf16_gathers_close_to_f32():
    """The large-graph bf16 gathered-operand mode (halves gather rows:
    one <=512 B chunk instead of two) must track the f32 path within
    bf16 tolerance in values and gradients. Forced on a small graph by
    dropping the size gate."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops import device_graph as dgm
    from graphaibench_tpu.ops import fused_gat as fg
    from graphaibench_tpu.ops.device_graph import build_seg_ell, to_device_graph

    g = rmat(8, 8, seed=5)
    dg = to_device_graph(g, with_transpose=True, with_ell=True)
    dgs = dataclasses.replace(dg, seg_ell=build_seg_ell(g, seg_rows=64))
    rng = np.random.default_rng(1)
    # 129 columns at f32 would need 2 chunks; at bf16 exactly one
    h = jnp.asarray(rng.standard_normal((g.nv, 128)).astype(np.float32))
    sl = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    sr = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))

    def run_all(d):
        out = fg.gat_attention_spmm_v2(d, sl, sr, h)
        loss = lambda a, b, x: (fg.gat_attention_spmm_v2(d, a, b, x) ** 2).sum()
        return (out, *jax.grad(loss, argnums=(0, 1, 2))(sl, sr, h))

    saved = dgm.SEG_ELL_MIN_NV
    try:
        for d in (dg, dgs):
            ref = run_all(d)            # gate above g.nv -> f32 path
            dgm.SEG_ELL_MIN_NV = 0      # force bf16 gathers (+ seq barriers)
            got = run_all(d)
            dgm.SEG_ELL_MIN_NV = saved
            for a, b, name in zip(got, ref, ("out", "dsl", "dsr", "dh")):
                a, b = np.asarray(a), np.asarray(b)
                scale = np.abs(b).max() + 1e-6
                np.testing.assert_allclose(a / scale, b / scale, atol=3e-2,
                                           err_msg=name)
    finally:
        dgm.SEG_ELL_MIN_NV = saved


def test_spmm_ell_bf16_gathers_close_to_f32():
    """spmm_ell's large-graph bf16 gathered-operand mode (the policy
    shared with fused GAT v2) must track the f32 path within bf16
    tolerance — values and the x/w gradients — on both the plain and
    column-segmented layouts. Forced on a small graph by dropping the
    size gate; small graphs below the gate keep exact f32 (the
    reference-parity regime, untouched by construction)."""
    import dataclasses as _dc

    import jax

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.ops import device_graph as dgm
    from graphaibench_tpu.ops.device_graph import (
        build_seg_ell, pack_edge_values, to_device_graph,
    )
    from graphaibench_tpu.ops.spmm import spmm

    g = T.add_selfloop(rmat(9, 8, seed=7))
    w = jnp.asarray(T.gcn_edge_norms(g))
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((g.nv, 128)).astype(np.float32))

    def run_all(dg, wv):
        out = spmm(dg, wv, x, "ell")
        gx = jax.grad(lambda xx: (spmm(dg, wv, xx, "ell") ** 2).sum())(x)
        return out, gx

    saved = dgm.SEG_ELL_MIN_NV
    try:
        for seg in (False, True):
            dg = to_device_graph(g, with_transpose=True, seg_ell=False)
            if seg:
                dg = _dc.replace(dg, seg_ell=build_seg_ell(g, seg_rows=128))
            for wv in (w, pack_edge_values(dg, w)):
                dgm.SEG_ELL_MIN_NV = saved
                ref = run_all(dg, wv)           # f32 path
                dgm.SEG_ELL_MIN_NV = 0          # force bf16 gathers
                got = run_all(dg, wv)
                dgm.SEG_ELL_MIN_NV = saved
                for a, b, name in zip(got, ref, ("out", "dx")):
                    a, b = np.asarray(a), np.asarray(b)
                    scale = np.abs(b).max() + 1e-6
                    np.testing.assert_allclose(a / scale, b / scale,
                                               atol=3e-2, err_msg=name)
    finally:
        dgm.SEG_ELL_MIN_NV = saved


def test_gat_v2_in_model_matches_unfused_model():
    """End-to-end: a GAT Model forward with trivial_w=True (v2 path) must
    match trivial_w=False (v1/sddmm path) on identical params."""
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.nn.layers import ModelConfig, apply_model, init_params
    from graphaibench_tpu.nn.model import GraphBundle

    g = rmat(8, 8, seed=9)
    gb = GraphBundle.build(g, "gat")
    cfg = ModelConfig(arch="gat", num_layers=2, dim_init=12, dim_hid=8,
                      num_cls=5, use_l2norm=True, use_dense=True)
    params = init_params(cfg)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((gb.host.nv, 12)).astype(np.float32))
    out_v2 = apply_model(cfg, params, gb.device, gb.edge_w, x, trivial_w=True)
    out_v1 = apply_model(cfg, params, gb.device, gb.edge_w, x, trivial_w=False)
    np.testing.assert_allclose(np.asarray(out_v2), np.asarray(out_v1),
                               rtol=2e-4, atol=2e-5)


def test_spmm_packed_weights_match_raw():
    """PackedEdgeW (pre-gathered static weights) must agree with the
    runtime w[edge_id] path — values AND gradients — on a graph large
    enough to take the ELL strategy, for both the plain and the
    column-segmented layouts."""
    import dataclasses as _dc

    import jax

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.ops.device_graph import (
        build_seg_ell, pack_edge_values, to_device_graph,
    )
    from graphaibench_tpu.ops.spmm import spmm

    g = T.add_selfloop(rmat(13, 8, seed=3))       # 8192 v > dense cutoff
    w = jnp.asarray(T.gcn_edge_norms(g))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, 24)).astype(np.float32))

    for seg in (False, True):
        dg = to_device_graph(g, seg_ell=False)
        if seg:
            dg = _dc.replace(dg, seg_ell=build_seg_ell(g, seg_rows=2048))
        wp = pack_edge_values(dg, w)
        ref = spmm(dg, w, x, "ell")
        out = spmm(dg, wp, x)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)

        # gradient w.r.t. x through the packed custom VJP
        f_raw = lambda xx: spmm(dg, w, xx, "ell").sum()
        f_pk = lambda xx: spmm(dg, wp, xx).sum()
        g_raw = jax.grad(f_raw)(x)
        g_pk = jax.grad(f_pk)(x)
        np.testing.assert_allclose(np.asarray(g_pk), np.asarray(g_raw),
                                   rtol=1e-5, atol=1e-5)


def test_model_packed_weights_end_to_end():
    """A Model on an >4096-vertex graph (packed weights engaged) trains
    identically to one with packing disabled."""
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import GnnDataset
    from graphaibench_tpu.nn.layers import ModelConfig
    from graphaibench_tpu.nn.model import Model

    g = rmat(13, 8, seed=1)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.nv, 16)).astype(np.float32)
    labels = rng.integers(0, 4, g.nv).astype(np.int32)
    mask = np.ones(g.nv, dtype=np.uint8)
    tr = (0, g.nv, g.nv)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=tr, val_range=tr, test_range=tr)
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=16, dim_hid=8,
                      num_cls=4, lr=0.01)
    m_packed = Model(cfg, ds)
    assert m_packed.full.packed_w is not None
    m_raw = Model(cfg, ds)
    m_raw.full.packed_w = None
    m_raw.training.packed_w = None
    l1, _ = m_packed.train_epoch()
    l2, _ = m_raw.train_epoch()
    np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-6)


def test_seg_only_layout_end_to_end():
    """At scale ``to_device_graph`` builds ONLY the column-segmented
    layout (plain ELL skipped — it would be a redundant ~1 GB copy at
    products scale). Every bucket-pass op must route and match the
    plain layout: auto SpMM (fwd + grads), segment_softmax, the
    sddmm_add adjoint, the GAT layer gate, and neighbor_reduce (the
    pull-mode frontier primitive)."""
    import dataclasses as _dc

    from graphaibench_tpu.graph import transforms as T2
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import build_seg_ell
    from graphaibench_tpu.ops.segment import neighbor_reduce

    g = T2.add_selfloop(rmat(13, 8, seed=5))      # 8192 v > dense cutoff
    dg_plain = to_device_graph(g, seg_ell=False)
    dg_seg = to_device_graph(g, seg_ell=True)
    assert dg_seg.ell == () and dg_seg.seg_ell is not None
    assert dg_seg.has_ell_layout
    # force several segments (8192 rows in one 2048-row slice each)
    dg_seg = _dc.replace(dg_seg, seg_ell=build_seg_ell(g, seg_rows=2048))

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, 24)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))

    # auto strategy picks "ell" on the seg-only graph, values + grads
    from graphaibench_tpu.ops.spmm import _pick_impl
    assert _pick_impl(dg_seg, "auto") == "ell"
    ref = spmm(dg_plain, w, x, "ell")
    np.testing.assert_allclose(np.asarray(spmm(dg_seg, w, x)),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)
    gx_ref = jax.grad(lambda xx: spmm(dg_plain, w, xx, "ell").sum())(x)
    gx_seg = jax.grad(lambda xx: spmm(dg_seg, w, xx).sum())(x)
    np.testing.assert_allclose(np.asarray(gx_seg), np.asarray(gx_ref),
                               rtol=2e-5, atol=2e-5)

    # segment_softmax (row reductions flatten the segment buckets)
    logits = jnp.asarray(rng.standard_normal(g.ne).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(segment_softmax(dg_seg, logits)),
        np.asarray(segment_softmax(dg_plain, logits)),
        rtol=2e-5, atol=2e-6)

    # sddmm_add adjoint routes through the ELL row reduction
    sa = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    sb = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    for dgi in (dg_plain, dg_seg):
        gsa = jax.grad(lambda a: sddmm_add(dgi, a, sb).sum())(sa)
        if dgi is dg_plain:
            gsa_ref = gsa
    np.testing.assert_allclose(np.asarray(gsa), np.asarray(gsa_ref),
                               rtol=2e-5, atol=2e-5)

    # neighbor_reduce (pull-mode analytics at scale see seg-only graphs)
    vals = jnp.asarray(rng.standard_normal(g.nv).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(neighbor_reduce(dg_seg, vals, "min")),
        np.asarray(neighbor_reduce(dg_plain, vals, "min")),
        rtol=1e-6, atol=1e-6)


def test_seg_only_gat_layer_matches_plain():
    """The GAT layer gate accepts the seg-only layout and the fused v2
    path matches the plain-ELL model output."""
    from graphaibench_tpu.graph import transforms as T2
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.nn.layers import ModelConfig, gat_layer_fwd, init_params

    g = T2.add_selfloop(rmat(13, 8, seed=7))
    dg_plain = to_device_graph(g, seg_ell=False)
    dg_seg = to_device_graph(g, seg_ell=True)
    assert dg_seg.ell == ()
    cfg = ModelConfig(arch="gat", num_layers=2, dim_init=16, dim_hid=8,
                      num_cls=4, lr=0.01)
    p0 = init_params(cfg)["gconv"][0]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, 16)).astype(np.float32))
    ew = jnp.ones(g.ne, jnp.float32)
    out_p = gat_layer_fwd(p0, dg_plain, ew, x, act=True, cfg=cfg,
                          train=False, key=None, trivial_w=True)
    out_s = gat_layer_fwd(p0, dg_seg, ew, x, act=True, cfg=cfg,
                          train=False, key=None, trivial_w=True)
    np.testing.assert_allclose(np.asarray(out_s), np.asarray(out_p),
                               rtol=2e-5, atol=2e-5)


def test_fused_gat_v1_finite_on_empty_rows():
    """Padded sampled subgraphs carry edgeless rows; the v1 softmax
    normalizer floor must be a NORMAL f32 (1e-30) — a subnormal floor
    (1e-38) may be flushed to zero by XLA and turns empty-row z into
    inf, NaN in the backward (fused_gat.py _norm_consts)."""
    import jax
    import jax.numpy as jnp

    from graphaibench_tpu.graph.csr import CSRGraph
    from graphaibench_tpu.ops.device_graph import to_device_graph
    from graphaibench_tpu.ops.fused_gat import gat_attention_spmm

    rp = np.array([0, 2, 4, 6, 6], np.int64)       # vertex 3: no edges
    ci = np.array([1, 2, 0, 2, 0, 1], np.int32)
    dg = to_device_graph(CSRGraph(row_ptr=rp, col_idx=ci))
    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.standard_normal(6).astype(np.float32))
    ew = jnp.ones(6, jnp.float32)
    h = jnp.asarray(rng.standard_normal((4, 8)).astype(np.float32))

    def loss(h_, l_):
        return gat_attention_spmm(dg, l_, ew, h_).sum()

    val = loss(h, logits)
    gh, gl = jax.grad(loss, argnums=(0, 1))(h, logits)
    assert np.isfinite(float(val))
    assert np.all(np.isfinite(np.asarray(gh)))
    assert np.all(np.isfinite(np.asarray(gl)))


def test_fused_gat_denom_floor_is_normal_f32():
    """The behavioral empty-rows test above runs on CPU, where a
    subnormal 1e-38 floor is NOT flushed and would still pass — so the
    floor constants themselves are asserted: every jnp.maximum(..., C)
    literal in fused_gat.py must be a NORMAL f32 (>= finfo(f32).tiny),
    or a device's flush-to-zero turns 1/z into inf on empty rows."""
    import inspect
    import re

    from graphaibench_tpu.ops import fused_gat

    src = inspect.getsource(fused_gat)
    floors = [float(m) for m in
              re.findall(r"jnp\.maximum\([^,]+,\s*([0-9]+(?:\.[0-9]*)?"
                         r"(?:[eE]-?[0-9]+)?)\)", src)]
    assert floors, "expected at least one maximum(..., floor) in fused_gat"
    tiny = float(np.finfo(np.float32).tiny)
    assert all(f >= tiny for f in floors), floors


def test_gab_seg_ell_env_override(monkeypatch):
    """GAB_SEG_ELL forces the layout regardless of graph size (the
    ablation switch)."""
    import jax.numpy as jnp

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.ops.device_graph import to_device_graph
    from graphaibench_tpu.ops.spmm import spmm_ell

    g = rmat(10, 8, seed=3)
    monkeypatch.setenv("GAB_SEG_ELL", "1")
    dg_seg = to_device_graph(g)
    monkeypatch.setenv("GAB_SEG_ELL", "0")
    dg_plain = to_device_graph(g)
    monkeypatch.delenv("GAB_SEG_ELL")
    dg_auto = to_device_graph(g)            # small -> plain by heuristic
    assert dg_seg.seg_ell is not None and dg_seg.ell == ()
    assert dg_plain.seg_ell is None and dg_plain.ell
    assert dg_auto.seg_ell is None
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((g.nv, 8)).astype(np.float32))
    w = jnp.ones(g.ne, jnp.float32)
    np.testing.assert_allclose(np.asarray(spmm_ell(dg_seg, w, x)),
                               np.asarray(spmm_ell(dg_plain, w, x)),
                               rtol=2e-5, atol=2e-5)
