"""Streaming-TC-on-compressed memory/speed evidence.

Runs triangle counting DIRECTLY off a plain-CGR rmat19 stream
(analytics.tc_stream) and records: triangle agreement vs the
uncompressed solver, wall time for both, the streaming path's peak
block footprint vs the uncompressed CSR footprint, and the device
allocator's peak bytes (when the backend exposes memory_stats).

The CGR encode is cached beside the rmat cache (host encode of ~16M
edges takes minutes; the stream is what production would load anyway).

  python tools/tc_stream_bench.py [--scale 19] [--ef 16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--block-mb", type=int, default=32)
    ap.add_argument("--skip-plain", action="store_true")
    args = ap.parse_args()

    import jax

    from graphaibench_tpu.analytics.tc import triangle_count
    from graphaibench_tpu.analytics.tc_stream import triangle_count_streaming
    from graphaibench_tpu.compress import cgr
    from graphaibench_tpu.compress.cli import load_compressed, save_compressed
    from graphaibench_tpu.graph.generators import rmat

    g = rmat(args.scale, args.ef, seed=0, cache=True)
    out = {"graph": f"rmat{args.scale} nv={g.nv} ne={g.ne}",
           "csr_bytes": int((g.nv + 1 + g.ne) * 4)}

    cache = os.path.expanduser(
        f"~/.cache/graphaibench/cgr_rmat{args.scale}_{args.ef}")
    if not os.path.exists(cache + ".meta.json"):
        t0 = time.perf_counter()
        cg = cgr.encode_graph(g, cgr.CgrConfig())
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        save_compressed(cg, cache)
        out["encode_s"] = round(time.perf_counter() - t0, 1)
    cg = load_compressed(cache)
    out["stream_bytes"] = len(cg.data)
    print(json.dumps(out), flush=True)

    def mem_peak():
        try:
            st = jax.local_devices()[0].memory_stats()
            return int(st.get("peak_bytes_in_use", 0))
        except Exception:  # noqa: BLE001 — backend may not expose it
            return None

    t0 = time.perf_counter()
    n_s, stats = triangle_count_streaming(
        cg, block_bytes=args.block_mb << 20)
    out["stream_tc_s"] = round(time.perf_counter() - t0, 2)
    out["stream_triangles"] = int(n_s)
    out["stream_stats"] = stats
    out["stream_peak_block_bytes"] = int(stats["peak_block_slots"]) * 4
    out["peak_device_bytes_after_stream"] = mem_peak()
    print(json.dumps(out), flush=True)

    if not args.skip_plain:
        t0 = time.perf_counter()
        n_p = triangle_count(g)
        out["plain_tc_s"] = round(time.perf_counter() - t0, 2)
        out["agree"] = bool(n_p == n_s)
        out["plain_triangles"] = int(n_p)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
