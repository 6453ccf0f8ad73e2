#!/usr/bin/env python3
"""Device→host copy strategies for a checkpoint's staging buffer on one
GPU: the flagship LM's generation (3,221,447,109 bytes) copied to host
memory each way, alone and beside a thread that launches small kernels
(its launch rate during the copy, against its rate alone, is what the
copy costs a training thread's CUDA calls).

    python3 tools/ckpt_d2h.py

- ``ring+numpy``: ``CheckpointManager``'s path, through two pinned 64 MB
  chunks on a side stream, each copied out to a pageable buffer with
  numpy while the next one crosses;
- ``pageable direct``: ``copy_`` into pageable memory in 64 MB chunks;
- ``pinned whole``: one pinned buffer of the whole size (its allocation,
  timed apart, happens once).

Prints the card's ``nvidia-smi`` name and power limit, one line a run,
the pinned allocation's seconds and sha256's rate on this host."""

import collections
import hashlib
import subprocess
import threading
import time

import numpy as np
import torch

N = 3_221_447_109
CHUNK = 64 << 20


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    stage = torch.empty(N, dtype=torch.uint8, device=dev)
    stage.random_(0, 255)
    side = torch.cuda.Stream(dev)
    host = np.empty(N, np.uint8)
    host[:] = 1                     # pages touched before any timing
    ring = [torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    big = {}

    def ring_numpy():
        pinned = [r.numpy() for r in ring]
        inflight = collections.deque()
        for k, o in enumerate(range(0, N, CHUNK)):
            n = min(CHUNK, N - o)
            if len(inflight) == 2:
                s, ev, po, pn = inflight.popleft()
                ev.synchronize()
                host[po:po + pn] = pinned[s][:pn]
            s = k % 2
            with torch.cuda.stream(side):
                ring[s][:n].copy_(stage[o:o + n], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            inflight.append((s, ev, o, n))
        for s, ev, po, pn in inflight:
            ev.synchronize()
            host[po:po + pn] = pinned[s][:pn]

    def pageable_direct():
        ht = torch.from_numpy(host)
        with torch.cuda.stream(side):
            for o in range(0, N, CHUNK):
                n = min(CHUNK, N - o)
                ht[o:o + n].copy_(stage[o:o + n])

    def pinned_whole():
        if "buf" not in big:
            t0 = time.perf_counter()
            big["buf"] = torch.empty(N, dtype=torch.uint8, pin_memory=True)
            big["alloc_s"] = time.perf_counter() - t0
        with torch.cuda.stream(side):
            big["buf"].copy_(stage, non_blocking=True)
        side.synchronize()

    def launcher(stop, out):
        x = torch.zeros(1024, device=dev)
        n, t0 = 0, time.perf_counter()
        while not stop.is_set():
            for _ in range(100):
                x.add_(1.0)
            n += 100
        torch.cuda.synchronize()
        out.append(n / (time.perf_counter() - t0))

    def launch_rate(seconds, during=None):
        stop, out = threading.Event(), []
        th = threading.Thread(target=launcher, args=(stop, out))
        th.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        if during is not None:
            during()
        else:
            time.sleep(seconds)
        took = time.perf_counter() - t0
        stop.set()
        th.join()
        return out[0], took

    for name, fn in (("ring+numpy", ring_numpy),
                     ("pageable direct", pageable_direct),
                     ("ring+numpy", ring_numpy),
                     ("pageable direct", pageable_direct),
                     ("pinned whole", pinned_whole)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        alone = time.perf_counter() - t0
        during, beside = launch_rate(0, fn)
        base, _ = launch_rate(beside + 0.1)
        print(f"{name}: alone {alone:.3f} s ({N / alone / 1e9:.2f} GB/s), "
              f"beside the launches {beside:.3f} s; launches {during:.0f}/s "
              f"during the copy against {base:.0f}/s without", flush=True)
    print(f"pinned allocation of the whole buffer {big['alloc_s']:.3f} s")
    t0 = time.perf_counter()
    hashlib.sha256(memoryview(host)).hexdigest()
    print(f"sha256 {N / (time.perf_counter() - t0) / 1e9:.3f} GB/s")


if __name__ == "__main__":
    main()
