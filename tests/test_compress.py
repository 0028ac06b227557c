"""Compression codecs: roundtrip + on-disk + CLI verify (the reference's
verify_compression gate)."""

import numpy as np
import pytest

from conftest import fixture_path

from graphaibench_tpu.compress import cgr, hybrid, vbyte
from graphaibench_tpu.compress.cli import compress_cmd, decompress_cmd, verify_cmd
from graphaibench_tpu.compress.unary import (
    BitReader, BitWriter, int_2_nat, nat_2_int, read_gamma, read_zeta,
    write_gamma, write_zeta, gamma_len, zeta_len,
)
from graphaibench_tpu.graph.generators import rmat, uniform_random
from graphaibench_tpu.graph.io import load_graph


def test_gamma_zeta_roundtrip():
    w = BitWriter()
    vals = [0, 1, 2, 3, 7, 8, 100, 1023, 1024, 123456, 2**30]
    for v in vals:
        write_gamma(w, v)
    for v in vals:
        write_zeta(w, v, 2)
    for v in vals:
        write_zeta(w, v, 3)
    r = BitReader(w.getvalue())
    for v in vals:
        assert read_gamma(r) == v
    for v in vals:
        assert read_zeta(r, 2) == v
    for v in vals:
        assert read_zeta(r, 3) == v


def test_gamma_zeta_lengths():
    # gamma(x) is 2*floor(log2(x+1))+1 bits; zeta per unary_encoder.cc:44-51
    w = BitWriter(); write_gamma(w, 0)
    assert w.bit_length == 1 == gamma_len(0)
    w = BitWriter(); write_gamma(w, 5)
    assert w.bit_length == 5 == gamma_len(5)
    for x in (0, 1, 7, 63, 1000):
        for k in (1, 2, 3):
            w = BitWriter(); write_zeta(w, x, k)
            assert w.bit_length == zeta_len(x, k)


def test_int_2_nat():
    for x in (-5, -1, 0, 1, 7):
        assert nat_2_int(int_2_nat(x)) == x


@pytest.mark.parametrize("cfg", [
    cgr.CgrConfig(),
    cgr.CgrConfig(zeta_k=1),
    cgr.CgrConfig(zeta_k=3, res_seg_len=128),
    cgr.CgrConfig(res_seg_len=0),
    cgr.CgrConfig(use_interval=True),
    cgr.CgrConfig(use_interval=True, res_seg_len=0, add_degree=True),
    cgr.CgrConfig(alignment="byte"),
    cgr.CgrConfig(alignment="word", use_interval=True),
])
def test_cgr_roundtrip(cfg):
    g = uniform_random(150, 600, seed=2)
    cg = cgr.encode_graph(g, cfg)
    g2 = cgr.decode_graph(cg)
    np.testing.assert_array_equal(g2.row_ptr, g.row_ptr)
    np.testing.assert_array_equal(g2.col_idx, g.col_idx)


def test_cgr_grid_intervals_compress_well():
    """Grids are runs of consecutive ids — intervals must win."""
    from graphaibench_tpu.graph.generators import grid2d
    g = grid2d(20)
    plain = cgr.encode_graph(g, cgr.CgrConfig())
    itv = cgr.encode_graph(g, cgr.CgrConfig(use_interval=True, min_itv_len=2))
    assert itv.compression_ratio() >= plain.compression_ratio() * 0.9


@pytest.mark.parametrize("scheme", ["streamvbyte", "varintgb"])
def test_vbyte_roundtrip(scheme):
    g = rmat(8, 6, seed=3)
    vg = vbyte.encode_graph(g, scheme)
    g2 = vbyte.decode_graph(vg)
    np.testing.assert_array_equal(g2.col_idx, g.col_idx)
    np.testing.assert_array_equal(g2.row_ptr, g.row_ptr)
    # word alignment
    assert len(vg.data) % 4 == 0


def test_hybrid_roundtrip():
    g = rmat(8, 8, seed=5)  # power-law: mixes both schemes
    hg = hybrid.encode_graph(g, threshold=8)
    deg = g.degrees()
    assert (deg >= 8).any() and (deg < 8).any()
    g2 = hybrid.decode_graph(hg)
    np.testing.assert_array_equal(g2.col_idx, g.col_idx)


def test_citeseer_compression_ratio(citeseer, tmp_path):
    cg = cgr.encode_graph(citeseer, cgr.CgrConfig(zeta_k=2))
    assert cg.compression_ratio() > 2.0  # beats raw 4-byte ids
    g2 = cgr.decode_graph(cg)
    np.testing.assert_array_equal(g2.col_idx, citeseer.col_idx)


@pytest.mark.parametrize("scheme", ["cgr", "streamvbyte", "varintgb", "hybrid"])
def test_cli_roundtrip(tmp_path, scheme):
    prefix = str(tmp_path / f"{scheme}/g")
    compress_cmd(fixture_path("tester"), prefix, scheme)
    assert verify_cmd(fixture_path("tester"), prefix)
    out = str(tmp_path / f"{scheme}_out")
    g = decompress_cmd(prefix, out)
    ref = load_graph(fixture_path("tester"))
    np.testing.assert_array_equal(g.col_idx, ref.col_idx)


def test_cli_permuted_roundtrip(tmp_path):
    """-p byte-permutation flag (compressor.cc:117 permutate_bytes_by_word):
    word-aligned CGR stream stored with reversed bytes per 32-bit word;
    verify/decompress must still reproduce the graph exactly."""
    from graphaibench_tpu.compress.cli import permute_bytes_by_word

    raw = bytes(range(8))
    assert permute_bytes_by_word(raw) == bytes([3, 2, 1, 0, 7, 6, 5, 4])
    assert permute_bytes_by_word(permute_bytes_by_word(raw)) == raw

    prefix = str(tmp_path / "perm/g")
    compress_cmd(fixture_path("tester"), prefix, "cgr",
                 alignment="word", permuted=True)
    assert verify_cmd(fixture_path("tester"), prefix)
    g = decompress_cmd(prefix, str(tmp_path / "perm_out"))
    ref = load_graph(fixture_path("tester"))
    np.testing.assert_array_equal(g.col_idx, ref.col_idx)
    # the on-disk stream is actually permuted (differs from unpermuted)
    plain = str(tmp_path / "plain/g")
    compress_cmd(fixture_path("tester"), plain, "cgr", alignment="word")
    b_perm = open(prefix + ".edge.bin", "rb").read()
    b_plain = open(plain + ".edge.bin", "rb").read()
    assert b_perm != b_plain and permute_bytes_by_word(b_perm) == b_plain


def test_streamvbyte_device_decode(citeseer):
    """Device-side decode (compress/device_decode.py) must reproduce the
    host codec bit-for-bit, including the citeseer triangle golden."""
    from graphaibench_tpu.analytics.tc import triangle_count
    from graphaibench_tpu.compress.device_decode import decode_graph_device
    from graphaibench_tpu.compress.vbyte import encode_graph

    vg = encode_graph(citeseer, "streamvbyte")
    g2 = decode_graph_device(vg)
    assert np.array_equal(g2.row_ptr, citeseer.row_ptr)
    assert np.array_equal(g2.col_idx, citeseer.col_idx)
    assert triangle_count(g2) == 1166


def test_streamvbyte_device_decode_edge_cases():
    """Zero-degree vertices, 1-vertex segments, ids needing 1..4 bytes."""
    from graphaibench_tpu.compress.device_decode import decode_graph_device
    from graphaibench_tpu.compress.vbyte import encode_graph
    from graphaibench_tpu.graph.csr import from_edges

    n = 70000  # forces 3-byte absolute ids
    src = np.array([0, 0, 0, 5, 5, 69999, 3])
    dst = np.array([1, 300, 69999, 6, 70, 0, 3 + 0])
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    g = from_edges(src, dst, n)
    vg = encode_graph(g, "streamvbyte")
    g2 = decode_graph_device(vg)
    assert np.array_equal(g2.row_ptr, g.row_ptr)
    assert np.array_equal(g2.col_idx, g.col_idx)


def test_varintgb_device_decode(citeseer):
    """Device VarintGB decode (lane-per-vertex group scan) reproduces
    the host codec exactly, including the citeseer triangle golden."""
    from graphaibench_tpu.analytics.tc import triangle_count
    from graphaibench_tpu.compress.device_decode import varintgb_decode_device
    from graphaibench_tpu.compress.vbyte import encode_graph

    vg = encode_graph(citeseer, "varintgb")
    g2 = varintgb_decode_device(vg)
    assert np.array_equal(g2.row_ptr, citeseer.row_ptr)
    assert np.array_equal(g2.col_idx, citeseer.col_idx)
    assert triangle_count(g2) == 1166


def test_varintgb_device_decode_edge_cases():
    """Multi-byte lanes at every in-word tag alignment, zero-degree
    vertices, partial final groups, and a hub needing several scan
    buckets."""
    from graphaibench_tpu.compress.device_decode import varintgb_decode_device
    from graphaibench_tpu.compress.vbyte import encode_graph
    from graphaibench_tpu.graph.csr import from_edges

    n = 70000
    hub = 17  # degree 40 -> 10 groups (bucket > 8)
    src = [0, 0, 0, 5, 5, 69999] + [hub] * 40
    dst = [1, 300, 69999, 6, 70, 0] + list(range(40000, 40000 + 40))
    src, dst = np.array(src), np.array(dst)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    g = from_edges(src, dst, n)
    vg = encode_graph(g, "varintgb")
    g2 = varintgb_decode_device(vg)
    assert np.array_equal(g2.row_ptr, g.row_ptr)
    assert np.array_equal(g2.col_idx, g.col_idx)


def test_varintgb_device_decode_4byte_lanes():
    """code==3 (4-byte) lanes: vertex ids >= 2**24 force the full-mask
    branch in _varintgb_pass for both absolute values and wide gaps."""
    from graphaibench_tpu.compress.device_decode import varintgb_decode_device
    from graphaibench_tpu.compress.vbyte import encode_graph
    from graphaibench_tpu.graph.csr import from_edges

    n = (1 << 24) + 64
    big = n - 2  # absolute id needs 4 bytes
    src = np.array([0, 0, 0, 3, 3, big])
    dst = np.array([1, 2, big, 5, big - 1, big - 3])  # wide d1 gaps
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    g = from_edges(src, dst, n)
    vg = encode_graph(g, "varintgb")
    g2 = varintgb_decode_device(vg)
    assert np.array_equal(g2.row_ptr, g.row_ptr)
    assert np.array_equal(g2.col_idx, g.col_idx)


def test_varintgb_trip_grid_host_fallback(tmp_path):
    """A hub past the trip-grid degree limit raises ValueError from the
    device decoder and the analytics dispatcher falls back to host."""
    import pytest

    from graphaibench_tpu.analytics import run_benchmark
    from graphaibench_tpu.compress.cli import save_compressed
    from graphaibench_tpu.compress.device_decode import (
        _VGB_SUBS,
        _VGB_TRIP_GRID,
        varintgb_decode_device,
    )
    from graphaibench_tpu.compress.vbyte import encode_graph
    from graphaibench_tpu.graph.csr import from_edges

    limit = 4 * _VGB_SUBS * _VGB_TRIP_GRID[-1]
    n = limit + 8
    hub_deg = limit + 4
    src = np.full(hub_deg, 0)
    dst = np.arange(1, hub_deg + 1)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    g = from_edges(src, dst, n)
    vg = encode_graph(g, "varintgb")
    with pytest.raises(ValueError, match="trip grid"):
        varintgb_decode_device(vg)
    prefix = str(tmp_path / "hubgraph")
    save_compressed(vg, prefix)
    # dispatcher catches the ValueError and decodes on host (exit 0)
    assert run_benchmark("tc", prefix, []) == 0
    from graphaibench_tpu.compress.cli import decode_any, load_compressed

    g2 = decode_any(load_compressed(prefix))
    assert np.array_equal(g2.row_ptr, g.row_ptr)
    assert np.array_equal(g2.col_idx, g.col_idx)


def test_hybrid_trip_grid_host_fallback(tmp_path):
    """Hybrid with a large threshold routes a >2048-degree hub down the
    LOW-degree zeta lanes, past their trip grid: the device decoder must
    raise ValueError (not assert — vanishes under python -O) and the
    analytics dispatcher must fall back to the host decoder (ADVICE r2)."""
    import pytest

    from graphaibench_tpu.analytics import run_benchmark
    from graphaibench_tpu.compress import hybrid
    from graphaibench_tpu.compress.cli import save_compressed
    from graphaibench_tpu.compress.device_decode import decode_hybrid_device
    from graphaibench_tpu.graph.csr import from_edges

    hub_deg = 2500       # > 2048 (last low-lane trip), < threshold
    src = np.full(hub_deg, 0)
    dst = np.arange(1, hub_deg + 1)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    g = from_edges(src, dst, hub_deg + 1)
    hg = hybrid.encode_graph(g, threshold=3000)
    with pytest.raises(ValueError, match="hybrid trip grid"):
        decode_hybrid_device(hg)
    prefix = str(tmp_path / "hubhybrid")
    save_compressed(hg, prefix)
    assert run_benchmark("tc", prefix, []) == 0


def test_compressed_prefix_analytics(tmp_path, citeseer):
    """analytics CLI path on a compressed prefix (reference
    tc_omp_compressed semantics)."""
    from graphaibench_tpu.analytics import run_benchmark
    from graphaibench_tpu.compress.cli import save_compressed
    from graphaibench_tpu.compress.vbyte import encode_graph

    prefix = str(tmp_path / "cs_svb")
    save_compressed(encode_graph(citeseer, "streamvbyte"), prefix)
    assert run_benchmark("tc", prefix, []) == 0
    prefix2 = str(tmp_path / "cs_vgb")
    save_compressed(encode_graph(citeseer, "varintgb"), prefix2)
    assert run_benchmark("tc", prefix2, []) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_fuzz_roundtrip(seed, tmp_path):
    """Random graphs x random codec configs: encode -> decode must be
    exact, for all schemes, including device decode for streamvbyte."""
    from graphaibench_tpu.compress import cgr, hybrid, vbyte
    from graphaibench_tpu.compress.device_decode import decode_graph_device
    from graphaibench_tpu.graph.csr import from_edges

    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 400))
    ne = int(rng.integers(0, 6 * n))
    src = rng.integers(0, n, ne)
    dst = rng.integers(0, n, ne)
    keep = src != dst
    from graphaibench_tpu.graph.transforms import sort_and_clean

    g = sort_and_clean(from_edges(
        np.concatenate([src[keep], dst[keep]]),
        np.concatenate([dst[keep], src[keep]]), n))

    vg = vbyte.encode_graph(g, "streamvbyte")
    assert np.array_equal(vbyte.decode_graph(vg).col_idx, g.col_idx)
    g2 = decode_graph_device(vg)
    assert np.array_equal(g2.col_idx, g.col_idx)
    assert np.array_equal(g2.row_ptr, g.row_ptr)

    vg2 = vbyte.encode_graph(g, "varintgb")
    assert np.array_equal(vbyte.decode_graph(vg2).col_idx, g.col_idx)
    g3 = decode_graph_device(vg2)  # dispatches to the varintgb kernel
    assert np.array_equal(g3.col_idx, g.col_idx)
    assert np.array_equal(g3.row_ptr, g.row_ptr)

    cfg = cgr.CgrConfig(zeta_k=int(rng.integers(1, 5)),
                        use_interval=bool(rng.integers(0, 2)),
                        itv_seg_len=int(rng.choice([32, 64, 128])),
                        min_itv_len=int(rng.integers(2, 6)),
                        res_seg_len=int(rng.choice([64, 128, 256])))
    cg = cgr.encode_graph(g, cfg)
    assert np.array_equal(cgr.decode_graph(cg).col_idx, g.col_idx)
    from graphaibench_tpu.compress.cgr_device import cgr_decode_device

    try:
        g4 = cgr_decode_device(cg)
    except ValueError:
        g4 = None      # oversized-segment fallback: host path covers it
    if g4 is not None:
        assert np.array_equal(g4.col_idx, g.col_idx)
        assert np.array_equal(g4.row_ptr, g.row_ptr)

    hg = hybrid.encode_graph(g, threshold=int(rng.integers(2, 40)))
    assert np.array_equal(hybrid.decode_graph(hg).col_idx, g.col_idx)


def test_cgr_bit_parity_with_reference_compressor():
    """BIT-EXACT stream parity with the reference `compressor` binary
    (src/structure/compressor.cc + cgr_encoder.cc): encoding citeseer
    with default options must reproduce the reference's .edge.bin and
    .vertex.bin byte-for-byte, for both plain-segmented CGR (-g) and
    interval CGR (-g -i). Goldens were generated with the actual
    reference binary (tools/reference_build/build_compressor.sh records
    the exact commands); hashes stand in for the 43 KB of binaries."""
    import hashlib
    import json
    import os

    import numpy as np

    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.io import load_graph

    golden = json.load(open(
        os.path.join(os.path.dirname(__file__), "goldens",
                     "ref_cgr_citeseer.json")))
    g = T.sort_and_clean(load_graph("/root/reference/inputs/citeseer"))
    for name, kw in (("cs_ref", dict(use_interval=False)),
                     ("cs_ref_itv", dict(use_interval=True))):
        cg = cgr.encode_graph(g, cgr.CgrConfig(**kw))
        assert len(cg.data) == golden[f"{name}.edge"]["bytes"], name
        assert (hashlib.sha256(cg.data).hexdigest()
                == golden[f"{name}.edge"]["sha256"]), name
        off_bytes = np.asarray(cg.offsets, dtype=np.int64).tobytes()
        assert (hashlib.sha256(off_bytes).hexdigest()
                == golden[f"{name}.vertex"]["sha256"]), name


def test_cgr_device_decode_matches_host():
    """cgr_decode_device must reproduce the exact CSR across alignments,
    zeta_k, add_degree, and skewed graphs (cgr_decoder.cuh:269 analog)."""
    import jax.numpy as jnp

    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cgr_device import cgr_decode_device
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.generators import rmat, uniform_random

    graphs = [
        T.sort_and_clean(rmat(9, 8, seed=1)),         # hubs + isolated
        T.sort_and_clean(uniform_random(200, 600, seed=2)),
    ]
    cfgs = [dict(), dict(zeta_k=3), dict(alignment="byte"),
            dict(alignment="word"), dict(add_degree=True),
            dict(res_seg_len=64)]
    for g in graphs:
        for kw in cfgs:
            cg = cgr.encode_graph(g, cgr.CgrConfig(use_interval=False, **kw))
            got = cgr_decode_device(cg)
            np.testing.assert_array_equal(
                np.asarray(got.row_ptr), np.asarray(g.row_ptr), err_msg=str(kw))
            np.testing.assert_array_equal(got.col_idx, g.col_idx,
                                          err_msg=str(kw))


def test_cgr_device_decode_intervals_match_host():
    """Interval-coded streams (the reference's headline CGR mode,
    cgr_encoder.cc intervals + cgr_decoder.cuh:168 interval segments)
    must decode on device to the exact CSR: runs of consecutive ids
    exercise segment closing, the merged trailing partial segment, and
    the residual/interval per-row merge."""
    import numpy as np

    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cgr_device import cgr_decode_device
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.csr import from_edges
    from graphaibench_tpu.graph.generators import rmat

    rng = np.random.default_rng(7)
    src, dst = [], []
    nv = 300
    for v in range(nv):
        run = int(rng.integers(0, 12))       # consecutive run -> interval
        for t in range(run):
            if v + 1 + t < nv:
                src.append(v)
                dst.append(v + 1 + t)
        for _ in range(int(rng.integers(0, 6))):   # scattered residuals
            src.append(v)
            dst.append(int(rng.integers(0, nv)))
    runs_graph = T.sort_and_clean(
        from_edges(np.asarray(src), np.asarray(dst), nv))
    graphs = [runs_graph, T.sort_and_clean(rmat(9, 8, seed=1))]
    cfgs = [dict(), dict(add_degree=True), dict(itv_seg_len=128),
            dict(min_itv_len=2), dict(zeta_k=3), dict(alignment="byte")]
    for g in graphs:
        for kw in cfgs:
            cg = cgr.encode_graph(
                g, cgr.CgrConfig(use_interval=True,
                                 **{"itv_seg_len": 64, **kw}))
            got = cgr_decode_device(cg)
            np.testing.assert_array_equal(
                np.asarray(got.row_ptr), np.asarray(g.row_ptr),
                err_msg=str(kw))
            np.testing.assert_array_equal(got.col_idx, g.col_idx,
                                          err_msg=str(kw))


def test_cgr_device_decode_rejects_unsupported():
    import pytest as _pytest

    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cgr_device import cgr_decode_device
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.generators import uniform_random

    import numpy as np

    from graphaibench_tpu.graph.csr import CSRGraph

    g = T.sort_and_clean(uniform_random(50, 150, seed=0))
    cg = cgr.encode_graph(g, cgr.CgrConfig(res_seg_len=0))
    with _pytest.raises(ValueError):
        cgr_decode_device(cg)
    # a seg_len below the trip grid must raise ValueError (not
    # IndexError: the analytics fallback only catches ValueError)
    cg2 = cgr.encode_graph(g, cgr.CgrConfig(res_seg_len=3))
    with _pytest.raises(ValueError):
        cgr_decode_device(cg2)

    # empty graph, add_degree interval stream: no vertex has any
    # section; must return the empty CSR, not crash on empty lanes
    empty = CSRGraph(row_ptr=np.zeros(9, np.int64),
                     col_idx=np.zeros(0, np.int32))
    cg3 = cgr.encode_graph(empty, cgr.CgrConfig(use_interval=True,
                                                add_degree=True))
    got = cgr_decode_device(cg3)
    assert got.ne == 0 and got.nv == 8


def test_cgr_device_decode_small_segments():
    """Small segment lengths (incl. the reference encoder's default
    itv_seg_len=32, cgr_encoder.hh:37) decode exactly when no segment
    overflows its slot; an oversized multi-slot segment (the reference's
    append_segment alignment case) is detected EXACTLY and raises for
    the host fallback instead of mis-parsing."""
    import numpy as np
    import pytest as _pytest

    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cgr_device import cgr_decode_device
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.csr import from_edges
    from graphaibench_tpu.graph.generators import uniform_random

    g = T.sort_and_clean(uniform_random(60, 180, seed=3))
    decoded = 0
    for kw in (dict(res_seg_len=32), dict(res_seg_len=64),
               dict(use_interval=True, itv_seg_len=32)):
        cg = cgr.encode_graph(g, cgr.CgrConfig(**kw))
        try:
            got = cgr_decode_device(cg)
        except ValueError:
            continue    # oversized segment -> loud host fallback: fine
        np.testing.assert_array_equal(got.col_idx, g.col_idx,
                                      err_msg=str(kw))
        decoded += 1
    # small-id graph: no code outgrows its slot, so ALL must decode on
    # device (the except branch is for future-graph safety, not a skip)
    assert decoded == 3

    # force an oversized CLOSED residual segment: vertex 0's residuals
    # each need a ~40-bit gamma (> the 32-bit slot), so each forms its
    # own segment; with three of them the FIRST segment stays closed
    # (the trailing partial group only merges into the last closed one)
    # and occupies multiple slots — the static stride would mis-parse;
    # the detector must raise (host decode stays exact)
    nv = 1 << 22
    src = np.asarray([0, 0, 0])
    dst = np.asarray([1 << 20, (1 << 20) + (1 << 19), 1 << 21])
    g2 = T.sort_and_clean(from_edges(src, dst, nv))
    cg2 = cgr.encode_graph(g2, cgr.CgrConfig(res_seg_len=32, zeta_k=1))
    host = cgr.decode_graph(cg2)
    np.testing.assert_array_equal(host.col_idx, g2.col_idx)
    with _pytest.raises(ValueError):
        cgr_decode_device(cg2)


def test_tc_golden_via_cgr_device_decode(tmp_path):
    """citeseer triangle golden (1166) through the device CGR path."""
    from graphaibench_tpu.analytics.tc import triangle_count
    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cgr_device import cgr_decode_device
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.io import load_graph

    g = T.sort_and_clean(load_graph("/root/reference/inputs/citeseer"))
    cg = cgr.encode_graph(g, cgr.CgrConfig(use_interval=False))
    g2 = cgr_decode_device(cg)
    assert triangle_count(g2) == 1166
    cgi = cgr.encode_graph(g, cgr.CgrConfig(use_interval=True,
                                            itv_seg_len=64))
    g3 = cgr_decode_device(cgi)
    assert triangle_count(g3) == 1166


def test_hybrid_device_decode_matches_host():
    """decode_hybrid_device composes the zeta-lane and SVB-subset device
    decoders; must reproduce the exact CSR (hybrid_encoder.cc analog)."""
    from graphaibench_tpu.compress import hybrid
    from graphaibench_tpu.compress.device_decode import decode_hybrid_device
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.generators import rmat

    g = T.sort_and_clean(rmat(9, 8, seed=4))  # hubs above + below threshold
    for threshold in (4, 32, 10**9):   # all-svb .. mixed .. all-zeta
        hg = hybrid.encode_graph(g, threshold=threshold)
        got = decode_hybrid_device(hg)
        np.testing.assert_array_equal(np.asarray(got.row_ptr),
                                      np.asarray(g.row_ptr))
        np.testing.assert_array_equal(got.col_idx, g.col_idx,
                                      err_msg=f"threshold={threshold}")


def test_tc_golden_via_hybrid_device_decode():
    from graphaibench_tpu.analytics.tc import triangle_count
    from graphaibench_tpu.compress import hybrid
    from graphaibench_tpu.compress.device_decode import decode_hybrid_device
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.graph.io import load_graph

    g = T.sort_and_clean(load_graph("/root/reference/inputs/citeseer"))
    hg = hybrid.encode_graph(g)
    assert triangle_count(decode_hybrid_device(hg)) == 1166


def test_tc_streaming_cgr(tmp_path):
    """Streaming TC off the compressed adjacency: citeseer golden 1166
    with multi-block pairs, never materializing the full CSR; CLI route
    via GAB_TC_STREAM=1."""
    import os

    from graphaibench_tpu.analytics import run_benchmark
    from graphaibench_tpu.analytics.tc import triangle_count
    from graphaibench_tpu.analytics.tc_stream import triangle_count_streaming
    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cli import save_compressed
    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph.io import load_graph

    g = load_graph("/root/reference/inputs/citeseer")
    cg = cgr.encode_graph(g, cgr.CgrConfig())
    n, stats = triangle_count_streaming(cg, block_bytes=1 << 15)
    assert n == 1166 and stats["blocks"] >= 2
    # full CSR slots never allocated: peak block slots well under ne*2
    assert stats["peak_block_slots"] < 16 * stats["ne"]

    g2 = rmat(12, 8, seed=2)
    cg2 = cgr.encode_graph(g2, cgr.CgrConfig())
    n2, _ = triangle_count_streaming(cg2, block_bytes=1 << 17)
    assert n2 == triangle_count(g2)

    prefix = str(tmp_path / "cs_cgr")
    save_compressed(cg, prefix)
    os.environ["GAB_TC_STREAM"] = "1"
    try:
        assert run_benchmark("tc", prefix, []) == 0
    finally:
        os.environ.pop("GAB_TC_STREAM", None)


def test_tc_streaming_interval_fallback(tmp_path):
    """Interval CGR streams refuse streaming (ValueError) and the CLI
    falls back to decode-then-count."""
    import os

    import pytest

    from graphaibench_tpu.analytics import run_benchmark
    from graphaibench_tpu.analytics.tc_stream import triangle_count_streaming
    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cli import save_compressed
    from graphaibench_tpu.graph.io import load_graph

    g = load_graph("/root/reference/inputs/citeseer")
    cg = cgr.encode_graph(g, cgr.CgrConfig(use_interval=True))
    with pytest.raises(ValueError, match="interval"):
        triangle_count_streaming(cg)
    prefix = str(tmp_path / "cs_cgr_itv")
    save_compressed(cg, prefix)
    os.environ["GAB_TC_STREAM"] = "1"
    try:
        assert run_benchmark("tc", prefix, []) == 0
    finally:
        os.environ.pop("GAB_TC_STREAM", None)


def test_bfs_streaming_cgr():
    """Streaming BFS off the compressed stream equals the serial oracle
    (multi-block, symmetric fixture)."""
    from graphaibench_tpu.analytics import verifiers
    from graphaibench_tpu.analytics.tc_stream import bfs_streaming
    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.graph.io import load_graph

    g = load_graph("/root/reference/inputs/citeseer")
    cg = cgr.encode_graph(g, cgr.CgrConfig())
    dist = bfs_streaming(cg, 0, block_bytes=1 << 15)
    np.testing.assert_array_equal(dist, verifiers.bfs_serial(g, 0))
