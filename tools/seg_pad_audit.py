"""Slot-padding audit of the segmented layout (host-only, no device).

Counts stored slots vs real edges for the stacked seg-ELL at a given
scale — the layout's padding tax (at rmat20: equal-vertex bounds 3.21x,
equal-edge 1.79x; grouped stacking targets ~1.1x).

  python tools/seg_pad_audit.py [--scale 20] [--ef 32] [--groups 4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--ef", type=int, default=32)
    ap.add_argument("--groups", type=int, default=None)
    args = ap.parse_args()
    if args.groups is not None:
        os.environ["GAB_SEG_GROUPS"] = str(args.groups)

    from graphaibench_tpu.graph.generators import rmat
    from graphaibench_tpu.graph import transforms as T
    from graphaibench_tpu.ops.device_graph import build_seg_ell

    g = T.add_selfloop(rmat(args.scale, args.ef, seed=0, cache=True))
    ss = build_seg_ell(g)
    slots = sum(int(b.nbr.size) for b in ss.buckets)
    out = {"scale": args.scale, "ne": g.ne, "nseg": ss.nseg,
           "groups": len(ss.buckets),
           "group_env": os.environ.get("GAB_SEG_GROUPS", "4"),
           "stacked_seg_slots": slots,
           "stacked_over_ne": slots / max(g.ne, 1)}
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
