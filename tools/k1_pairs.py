#!/usr/bin/env python3
"""Time kernel K1 (the fusion pack, and its ``out=`` form) of two checkouts
of horovod_tpu_torch in alternating fresh processes on one GPU.

    python3 tools/k1_pairs.py PARENT_ROOT CHANGE_ROOT [--pairs N]

Each process imports the package from one root, builds its kernels and
times K1 as ``chip_smoke.py`` phase 1 does (``check_pack_kernel`` and
``check_pack_out_kernel`` at ResNet-50's two 64 MB buckets, 20 launches,
L2 flushed). Pair i runs parent then change, pair i + 1 change then parent.
Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
process, then the medians of each side and their ratio as the last line.
K1's phase-1 time is bimodal across processes, which a single pair of
runs cannot tell from a change."""

import argparse
import json
import os
import statistics
import subprocess
import sys


def _child(root: str):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.engine import bucket_by_size
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import build, kernels as K
    build.library()
    hvd.init()
    try:
        dev = torch.device("cuda", 0)
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
        shapes = [tuple(p.shape) for p in ResNet50(
            num_classes=1000, fused_bn=True).parameters()]
        row, grads = cs.check_pack_kernel(torch, K, bucket_by_size, dev,
                                          shapes, flush, 20, lambda *a: None)
        out_row = cs.check_pack_out_kernel(torch, K, bucket_by_size, dev,
                                           grads, flush, 20, lambda *a: None)
        print(json.dumps({"pack": row["ms"], "pack_out": out_row["ms"]}))
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    times = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            root = getattr(args, side)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.parent,
                 args.change, "--child", root], capture_output=True,
                text=True)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            row = json.loads(res.stdout.strip().splitlines()[-1])
            times[side].append(row)
            print(json.dumps({"pair": i, "side": side, **row}), flush=True)
    summary = {}
    for key in ("pack", "pack_out"):
        p = statistics.median(r[key] for r in times["parent"])
        c = statistics.median(r[key] for r in times["change"])
        summary[key] = {"parent_ms": p, "change_ms": c,
                        "change_vs_parent": c / p - 1}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
