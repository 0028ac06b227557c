"""Graph analytics benchmark suite.

Each solver pairs with a serial oracle in verifiers.py (the reference's
verifier pattern); run_benchmark prints Correct/Wrong like the reference
binaries' main.cc."""

from __future__ import annotations

import time

import numpy as np

from graphaibench_tpu.analytics import verifiers  # noqa: F401
from graphaibench_tpu.analytics.ann import knn_search  # noqa: F401
from graphaibench_tpu.analytics.assignment import hungarian  # noqa: F401
from graphaibench_tpu.analytics.bc import bc_single_source, betweenness_centrality  # noqa: F401
from graphaibench_tpu.analytics.cc import (  # noqa: F401
    connected_components,
    connected_components_afforest,
)
from graphaibench_tpu.analytics.cf import cf_train  # noqa: F401
from graphaibench_tpu.analytics.coloring import color  # noqa: F401
from graphaibench_tpu.analytics.community import louvain, modularity  # noqa: F401
from graphaibench_tpu.analytics.hac import cut_clusters, hac, hac_from_embeddings  # noqa: F401
from graphaibench_tpu.analytics.kcore import k_core  # noqa: F401
from graphaibench_tpu.analytics.linkpred import adamic_adar, jaccard, predict_links  # noqa: F401
from graphaibench_tpu.analytics.mst import boruvka_mst  # noqa: F401
from graphaibench_tpu.analytics.khop import khop_sample, random_walk  # noqa: F401
from graphaibench_tpu.analytics.pr import pagerank  # noqa: F401
from graphaibench_tpu.analytics.tc import triangle_count  # noqa: F401
from graphaibench_tpu.analytics.traversal import bfs, sssp_bellman_ford  # noqa: F401

# the serial triangle oracle intersects every DAG edge's lists in Python
# (about 5 s at 2^21 symmetric edges), so larger graphs go unverified
TC_VERIFY_MAX_EDGES = 1 << 21


def _run_distributed(kernel: str, g, args: list[str], shards: str) -> int:
    """GAB_SHARDS routing for the analytics CLI: run the mesh-sharded
    solver (parallel/dist_analytics.py) on the first N devices — the
    CLI twin of the reference's *_dist_cpu / *_multigpu binaries. The
    same serial verifiers gate the result."""
    import jax
    from jax.sharding import Mesh

    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.parallel import (
        distributed_bc,
        distributed_bfs,
        distributed_cc,
        distributed_kcore,
        distributed_pagerank,
        distributed_sssp,
        distributed_triangle_count,
    )

    devs = jax.devices()
    n = len(devs) if shards == "auto" else max(1, int(shards))
    n = min(n, len(devs))
    mesh = Mesh(np.asarray(devs[:n]), ("graph",))
    print(f"distributed over {n} device(s)")
    source = int(args[0]) if args else 0
    t0 = time.perf_counter()
    ok = None

    if kernel == "tc":
        cnt = distributed_triangle_count(mesh, g)
        dt = time.perf_counter() - t0
        print(f"total_num_triangles = {cnt}")
        if g.ne <= TC_VERIFY_MAX_EDGES:
            ok = cnt == verifiers.triangle_count_serial(T.orientation(g))
    elif kernel == "bfs":
        depth, sweeps = distributed_bfs(mesh, g, source)
        dt = time.perf_counter() - t0
        reach = depth < 2**30
        print(f"reached = {reach.sum()}, sweeps = {sweeps}")
        ref = verifiers.bfs_serial(g, source)
        unreach = ref < 0 if ref.min() < 0 else ref >= 2**30
        ok = (np.array_equal(depth[~unreach], ref[~unreach])
              and bool(np.all(~reach[unreach])))
    elif kernel == "sssp":
        w = (np.asarray(g.elabels, dtype=np.float32)
             if g.elabels is not None else np.ones(g.ne, np.float32))
        dist, sweeps = distributed_sssp(mesh, g, w, source)
        dt = time.perf_counter() - t0
        print(f"reached = {np.isfinite(dist).sum()}, sweeps = {sweeps}")
        ref = verifiers.dijkstra_serial(g, w, source)
        fin = np.isfinite(ref)
        ok = (np.allclose(dist[fin], ref[fin], rtol=1e-5)
              and bool(np.all(~np.isfinite(dist[~fin]))))
    elif kernel == "pr":
        scores, iters = distributed_pagerank(mesh, g)
        dt = time.perf_counter() - t0
        print(f"iterations = {iters}")
        ref = verifiers.pagerank_serial(g, T.reverse(g))
        ok = np.allclose(scores, ref, atol=1e-4)
    elif kernel == "cc":
        labels, _ = distributed_cc(mesh, g)
        dt = time.perf_counter() - t0
        print(f"num_components = {len(np.unique(labels))}")
        # both labelings are min-vertex-id per component on symmetric
        # graphs, so exact equality is the right check (a remap-based
        # equivalence would let component SPLITS pass)
        ok = np.array_equal(labels, verifiers.cc_serial(g))
    elif kernel == "bc":
        scores = distributed_bc(mesh, g, [source])
        dt = time.perf_counter() - t0
        ok = np.allclose(scores, verifiers.bc_serial(g, [source]),
                         rtol=1e-4, atol=1e-5)
    else:  # kcore
        core, levels = distributed_kcore(mesh, g)
        dt = time.perf_counter() - t0
        print(f"max_coreness = {core.max()}")
        ok = np.array_equal(core, verifiers.kcore_serial(g))

    print(f"runtime = {dt:.4f} sec")
    if ok is not None:
        print("Correct" if ok else "Wrong")
        return 0 if ok else 1
    return 0


def run_benchmark(kernel: str, dataset_path: str, args: list[str]) -> int:
    """CLI driver: load, solve, verify, print Correct/Wrong + runtime."""
    import jax.numpy as jnp

    from graphaibench_tpu.graph.io import load_graph
    from graphaibench_tpu.ops.device_graph import to_device_graph

    import os

    if os.path.exists(dataset_path + ".meta.json"):
        # compressed-graph prefix (the reference's tc_omp_compressed /
        # bfs compressed binaries take these): every scheme decodes on
        # device, with host fallback past the device decoders' limits
        from graphaibench_tpu.compress.cli import load_compressed
        from graphaibench_tpu.compress.device_decode import decode_graph_device

        cg = load_compressed(dataset_path)
        if (kernel == "tc" and hasattr(cg, "cfg")
                and os.environ.get("GAB_TC_STREAM", "") == "1"):
            # stream triangles straight off the compressed adjacency —
            # the N_cgr-accessor capability (graph.h:213-238,
            # tc_omp_compressed.cc): blocks decode on device per pair,
            # the full CSR never materializes (memory over speed)
            from graphaibench_tpu.analytics.tc_stream import (
                triangle_count_streaming,
            )

            t0 = time.perf_counter()
            try:
                n, stats = triangle_count_streaming(cg)
                dt = time.perf_counter() - t0
                print(f"total_num_triangles = {n} (streaming, "
                      f"{stats['blocks']} blocks)")
                print(f"runtime = {dt:.4f} sec")
                return 0
            except ValueError as e:   # interval/unary streams
                print(f"streaming unsupported ({e}); decode-then-count")
        if getattr(cg, "scheme", None) in ("streamvbyte", "varintgb"):
            try:
                g = decode_graph_device(cg)
                print(f"decoded {cg.scheme} on device")
            except ValueError as e:  # varintgb degree > trip grid
                from graphaibench_tpu.compress.cli import decode_any

                g = decode_any(cg)
                print(f"decoded on host ({e})")
        elif hasattr(cg, "cfg"):  # CGR
            from graphaibench_tpu.compress.cgr_device import cgr_decode_device

            try:
                g = cgr_decode_device(cg)
                print("decoded cgr on device")
            # ValueError: tiny-segment/unary streams or an inconsistent
            # parse (oversized multi-slot segments); AssertionError:
            # streams past the int32 bit-position limit — all handled
            # fine by the host decoder
            except (ValueError, AssertionError) as e:
                from graphaibench_tpu.compress.cli import decode_any

                g = decode_any(cg)
                print(f"decoded on host ({e})")
        elif getattr(cg, "vbyte_scheme", None) == "streamvbyte":  # hybrid
            from graphaibench_tpu.compress.device_decode import (
                decode_hybrid_device,
            )

            try:
                g = decode_hybrid_device(cg)
                print("decoded hybrid on device")
            # ValueError: low-degree lanes past the trip grid (large
            # threshold + hub) or a stream past the int32 bit-position
            # limit — both decode fine on host
            except ValueError as e:
                from graphaibench_tpu.compress.cli import decode_any

                g = decode_any(cg)
                print(f"decoded on host ({e})")
        else:
            from graphaibench_tpu.compress.cli import decode_any
            g = decode_any(cg)
            print("decoded on host")
    else:
        g = load_graph(dataset_path, with_elabels=(kernel == "cf"),
                       with_vlabels=(kernel == "fsm"))
    print(f"|V| {g.nv} |E| {g.ne}")
    shards = os.environ.get("GAB_SHARDS", "")
    if shards and kernel in ("tc", "bfs", "sssp", "pr", "cc", "bc",
                             "kcore"):
        # the reference ships separate distributed binaries (tc_dist_cpu,
        # tc_multigpu_*); here the same CLI routes onto the mesh solvers.
        # cc/kcore/bc pull over in-edges and are only correct on
        # symmetric graphs — directed inputs stay on the single-device
        # push kernels (mirroring the pull_ok gate below)
        from graphaibench_tpu.graph.transforms import is_symmetric

        if kernel in ("tc", "bfs", "sssp", "pr") or is_symmetric(g):
            return _run_distributed(kernel, g, args, shards)
        print("directed input: distributed "
              f"{kernel} needs a symmetric graph; running single-device")
    if kernel in ("bfs", "sssp", "pr", "cc", "bc", "kcore"):
        # pull-mode frontier kernels (ELL neighbor_reduce over row
        # buckets) assume a structurally symmetric graph; on directed
        # inputs keep the scatter push formulation, which stays correct
        from graphaibench_tpu.graph.transforms import is_symmetric

        pull_ok = is_symmetric(g)
        if not pull_ok:
            print("directed input: push/scatter kernels (no pull ELL)")
    else:
        pull_ok = False
    t0 = time.perf_counter()
    ok = None

    if kernel == "tc":
        n = triangle_count(g)
        dt = time.perf_counter() - t0
        print(f"total_num_triangles = {n}")
        if g.ne <= TC_VERIFY_MAX_EDGES:
            from graphaibench_tpu.graph.transforms import orientation
            ok = n == verifiers.triangle_count_serial(orientation(g))
    elif kernel == "bfs":
        source = int(args[0]) if args else 0
        dg = to_device_graph(g, with_transpose=False, with_ell=pull_ok)
        dist = np.asarray(bfs(dg, source))
        dt = time.perf_counter() - t0
        print(f"reached = {(dist >= 0).sum()}, max_depth = {dist.max()}")
        ok = np.array_equal(dist, verifiers.bfs_serial(g, source))
    elif kernel == "sssp":
        source = int(args[0]) if args else 0
        w = (np.asarray(g.elabels, dtype=np.float32)
             if g.elabels is not None else np.ones(g.ne, np.float32))
        # pull-mode SSSP gathers each slot's REVERSE-edge weight through
        # trans_perm (traversal.py), so the transpose permutation must
        # ride along whenever the ELL pull path is eligible
        dg = to_device_graph(g, with_transpose=pull_ok, with_ell=pull_ok)
        dist = np.asarray(sssp_bellman_ford(dg, jnp.asarray(w), source))
        dt = time.perf_counter() - t0
        ref = verifiers.dijkstra_serial(g, w, source)
        ok = np.allclose(dist, ref, rtol=1e-5, equal_nan=True)
    elif kernel == "pr":
        dg = to_device_graph(g, with_transpose=False, with_ell=pull_ok)
        scores, iters = pagerank(dg)
        scores = np.asarray(scores)
        dt = time.perf_counter() - t0
        print(f"iterations = {int(iters)}")
        ref = verifiers.pagerank_serial(g, g)
        ok = np.allclose(scores, ref, atol=1e-4)
    elif kernel == "cc":
        if pull_ok:
            # Afforest sampling shortcut (omp_afforest.cc): first-k link
            # rounds + giant-component contraction; symmetric inputs only
            comp = connected_components_afforest(g)
        else:
            dg = to_device_graph(g, with_transpose=False, with_ell=False)
            comp = np.asarray(connected_components(dg))
        dt = time.perf_counter() - t0
        print(f"num_components = {len(np.unique(comp))}")
        ref = verifiers.cc_serial(g)
        ok = np.array_equal(comp, ref)
    elif kernel == "bc":
        source = int(args[0]) if args else 0
        dg = to_device_graph(g, with_transpose=False, with_ell=pull_ok)
        scores = np.asarray(bc_single_source(dg, source))
        dt = time.perf_counter() - t0
        ok = np.allclose(scores, verifiers.bc_serial(g, [source]), rtol=1e-4)
    elif kernel == "kcore":
        if pull_ok:
            core = np.asarray(k_core(None, host=g))   # h-index fixpoint
        else:
            dg = to_device_graph(g, with_transpose=False, with_ell=False)
            core = np.asarray(k_core(dg))
        dt = time.perf_counter() - t0
        print(f"max_coreness = {core.max()}")
        ok = np.array_equal(core, verifiers.kcore_serial(g))
    elif kernel == "color":
        dg = to_device_graph(g, with_transpose=False, with_ell=False)
        colors = np.asarray(color(dg))
        dt = time.perf_counter() - t0
        print(f"num_colors = {len(np.unique(colors))}")
        ok = verifiers.coloring_valid(g, colors)
    elif kernel == "cf":
        ratings = (np.asarray(g.elabels, dtype=np.float32)
                   if g.elabels is not None else np.ones(g.ne, np.float32))
        lat, hist = cf_train(g, ratings)
        dt = time.perf_counter() - t0
        print("RMSE history:", " ".join(f"{h:.4f}" for h in hist))
        ok = hist[-1] <= hist[0]
    elif kernel == "motif":
        from graphaibench_tpu.analytics.motif import (induced_motif_counts,
                                                      motif_counts)
        k = int(args[0]) if args else 4
        induced = len(args) > 1 and args[1] == "induced"
        if induced and k == 3:
            ni = motif_counts(g, 3)
            counts = {"triangle": ni["triangle"],
                      "wedge": ni["wedge"] - 3 * ni["triangle"]}
        elif induced:
            counts = induced_motif_counts(g)
        else:
            counts = motif_counts(g, k)
        dt = time.perf_counter() - t0
        for name, c in sorted(counts.items()):
            print(f"{name} = {c}")
        if g.ne <= TC_VERIFY_MAX_EDGES:
            from graphaibench_tpu.graph.transforms import orientation
            ok = counts.get("triangle") == verifiers.triangle_count_serial(
                orientation(g))
    elif kernel == "fsm":
        from graphaibench_tpu.analytics.fsm import fsm as run_fsm
        min_sup = int(args[0]) if args else 1
        max_size = int(args[1]) if len(args) > 1 else 3
        if g.vlabels is None:
            print("dataset has no vertex labels")
            return 2
        pats = run_fsm(g, min_support=min_sup, max_size=max_size)
        dt = time.perf_counter() - t0
        for f in sorted(pats, key=lambda f: -f.support)[:40]:
            print(f"{f.kind} {f.labels} support={f.support}")
        print(f"num_frequent_patterns = {len(pats)}")
        if g.ne <= 5_000_000:
            # independent check of the edge-pattern supports straight
            # from the edge list (no NLF machinery)
            lab = np.asarray(g.vlabels, dtype=np.int64)
            L = int(lab.max()) + 1
            src, dst = g.coo()
            has = np.zeros((g.nv, L), dtype=bool)
            has[src, lab[dst]] = True
            got = {f.labels: f.support for f in pats if f.kind == "edge"}
            exp = {}
            for la in range(L):
                for lb in range(la, L):
                    na = int(((lab == la) & has[:, lb]).sum())
                    nb = int(((lab == lb) & has[:, la]).sum())
                    if min(na, nb) >= min_sup:
                        exp[(la, lb)] = min(na, nb)
            ok = got == exp
    elif kernel == "embed":
        from graphaibench_tpu.analytics.embedding import deepwalk, node2vec
        algo = args[0] if args else "deepwalk"
        dim = int(args[1]) if len(args) > 1 else 64
        fn = node2vec if algo == "node2vec" else deepwalk
        emb = fn(g, dim=dim)
        dt = time.perf_counter() - t0
        print(f"{algo} embeddings {emb.shape}, mean norm "
              f"{np.linalg.norm(emb, axis=1).mean():.4f}")
        ok = bool(np.isfinite(emb).all())
    elif kernel == "sample":
        seeds = np.arange(min(64, g.nv))
        hops = khop_sample(g, seeds)
        dt = time.perf_counter() - t0
        print("sampled edges per hop:", [len(s) for s, _ in hops])
        ok = True
    else:
        print(f"unknown kernel {kernel!r}")
        return 2

    print(f"runtime = {dt:.4f} sec")
    if ok is not None:
        print("Correct" if ok else "Wrong")
        return 0 if ok else 1
    return 0
