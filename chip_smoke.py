#!/usr/bin/env python3
"""Chip smoke test of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` and then:

1. holds each kernel against its plain PyTorch version on the card at
   ResNet-50's shapes (batch 64, 224x224) and times both with CUDA events;
2. drives the main path: ``hvd.init()`` on NCCL, ``ResNet50(fused_bn=True)``
   in bf16, ``broadcast_parameters``, ``DistributedOptimizer(SGD)``, a few
   training steps on a fixed synthetic batch (losses finite and falling);
3. runs ``hvd.grouped_allreduce`` on the step's gradients with the pack
   kernel on (``HOROVOD_PALLAS_PACK=1``), at op Sum and Average.

Launch counts are zeroed just before phase 2 and read after phase 3; every
kernel must have launched there (53 BN layers per step for each BN kernel,
one pack per 64 MB bucket). Any failed check exits non-zero with no result.
The line before the last is ``nvidia-smi``'s name and power limit, the one
before it the ``kernels`` JSON, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
BN_REL_TOL = 1e-5              # of sum |terms|: fp32 sums in another order


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def resnet50_bn_shapes(batch: int, image: int = 224):
    """(M, C) of each of ResNet-50's 53 BN layers, in forward order."""
    shapes = []
    s = image // 2                               # conv_init, stride 2
    shapes.append((batch * s * s, 64))
    s_in = s // 2                                # max pool, stride 2
    for i, blocks in enumerate([3, 4, 6, 3]):
        f = 64 * 2 ** i
        for j in range(blocks):
            s_out = s_in // 2 if i > 0 and j == 0 else s_in
            shapes.append((batch * s_in * s_in, f))          # norm0
            shapes.append((batch * s_out * s_out, f))        # norm1
            shapes.append((batch * s_out * s_out, 4 * f))    # norm2
            if j == 0:
                shapes.append((batch * s_out * s_out, 4 * f))  # norm_proj
            s_in = s_out
    return shapes


HEAD_START_CYCLES = 2_000_000  # about 1 ms of the card spinning


def time_ms(torch, fn, flush, reps: int):
    """Median device time of ``fn`` over ``reps`` calls, each timed with
    CUDA events after a write of ``flush`` has evicted the L2 cache, and
    the median host time of issuing it. Before each start event the card
    spins for about a millisecond, so the host has issued the whole call
    by the time the event fires: the device time holds none of the host's
    work, which the host time shows apart. Returns (device ms, host ms)."""
    fn()
    fn()
    events, host = [], []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        events.append((start, end))
        torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in events),
            statistics.median(host))


def check_bn_kernels(torch, K, dev, shapes, flush, reps, log):
    """K2/K3 against their plain versions at every distinct shape; returns
    the two kernel rows (times summed over the 53 layers of a step)."""
    counts = {}
    for shape in shapes:
        counts[shape] = counts.get(shape, 0) + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name in ("bn_stats", "bn_bwd_stats"):
        rows[name] = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0}
    for (m, c), n in counts.items():
        x = torch.randn(m, c, device=dev, generator=gen).to(torch.bfloat16)
        dy = torch.randn(m, c, device=dev, generator=gen).to(torch.bfloat16)
        s_ref, q_ref = K.bn_stats_plain(x)
        mean = s_ref / m
        invstd = torch.rsqrt(torch.clamp(q_ref / m - mean * mean, min=0)
                             + 1e-5)
        xf, dyf = x.float(), dy.float()
        xh = (xf - mean) * invstd
        cases = {
            "bn_stats": (lambda: K.bn_stats(x), (s_ref, q_ref),
                         (xf.abs().sum(0), (xf * xf).sum(0)),
                         lambda: K.bn_stats_plain(x), m * c * 2 + 2 * c * 4,
                         3 * m * c),
            "bn_bwd_stats": (lambda: K.bn_bwd_stats(dy, x, mean, invstd),
                             K.bn_bwd_stats_plain(dy, x, mean, invstd),
                             (dyf.abs().sum(0), (dyf * xh).abs().sum(0)),
                             lambda: K.bn_bwd_stats_plain(dy, x, mean,
                                                          invstd),
                             2 * m * c * 2 + 4 * c * 4, 5 * m * c),
        }
        for name, (kern, ref, mag, plain, nbytes, flops) in cases.items():
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {(m, c)}: two runs differ (not deterministic)")
            abs_err = max(float((g - r).abs().max())
                          for g, r in zip(got, ref))
            rel_err = max(float(((g - r).abs() / (t + 1e-30)).max())
                          for g, r, t in zip(got, ref, mag))
            check(rel_err <= BN_REL_TOL,
                  f"{name} {(m, c)}: error {rel_err:.3g} of sum|terms| "
                  f"> {BN_REL_TOL}")
            ms, host_ms = time_ms(torch, kern, flush, reps)
            plain_ms, _ = time_ms(torch, plain, flush, reps)
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 flops / FP32_FLOPS)
            row = rows[name]
            row["ms"] += n * ms
            row["host_ms"] += n * host_ms
            row["plain_ms"] += n * plain_ms
            row["bound_ms"] += n * bound_ms
            row["max_abs_err"] = max(row["max_abs_err"], abs_err)
            row["max_rel_err"] = max(row["max_rel_err"], rel_err)
            log(f"  {name} M={m} C={c} x{n}: kernel {ms:.4f} ms (host "
                f"{host_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms, abs err "
                f"{abs_err:.3g}, err/sum|terms| {rel_err:.3g}")
        del x, dy, xf, dyf, xh
    return rows


def check_pack_kernel(torch, K, bucket_by_size, dev, shapes, flush, reps,
                      log):
    """K1 bitwise against its plain version on ResNet-50's gradient list,
    bucketed at the 64 MB fusion threshold; times summed over buckets."""
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    buckets = bucket_by_size(grads, 64 * 1024 * 1024)
    row = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "max_abs_err": 0.0, "buckets": len(buckets)}
    for idxs in buckets:
        bucket = [grads[i] for i in idxs]
        flat_views = [t.view(-1) for t in bucket]
        got = K.pack(bucket)
        ref = K.pack_plain(bucket)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), "pack differs from its plain version")
        nbytes = sum(t.nbytes for t in bucket)
        ms, host_ms = time_ms(torch, lambda: K.pack(bucket), flush, reps)
        plain_ms, _ = time_ms(torch, lambda: K.pack_plain(bucket), flush,
                              reps)
        lib_ms, _ = time_ms(torch, lambda: torch.cat(flat_views), flush,
                            reps)
        bound_ms = 1e3 * 2 * nbytes / HBM_BYTES_PER_S
        row["ms"] += ms
        row["host_ms"] += host_ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += lib_ms
        row["bound_ms"] += bound_ms
        log(f"  pack bucket of {len(bucket)} tensors, {nbytes} B: kernel "
            f"{ms:.4f} ms (host {host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"torch.cat {lib_ms:.4f} ms, bound {bound_ms:.4f} ms, bitwise "
            "equal")
    return row, grads


def make_trainer(torch, hvd, ResNet50, dev, batch):
    """The main path's model, data and optimizer; returns one train step."""
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, fused_bn=True,
                     generator=torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand(batch, 224, 224, 3, device=dev, generator=gen)
    labels = torch.randint(0, 1000, (batch,), device=dev, generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        op=hvd.Average)
    model.train()

    def step():
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


def train(torch, step, batch, warmup, steps, windows, log):
    """Warmup steps, then ``windows`` timed windows of ``steps`` steps each;
    returns (losses, img/s over all timed steps, img/s of each window)."""
    losses = [float(step()) for _ in range(warmup)]
    rates, total_s = [], 0.0
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = [step() for _ in range(steps)]
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        total_s += window_s
        rates.append(batch * steps / window_s)
        losses += [float(v) for v in timed]
    log(f"  losses: {' '.join(f'{v:.4f}' for v in losses)}")
    return losses, batch * steps * windows / total_s, rates


KERNEL_GROUPS = (   # kernel-name patterns -> layer of the step, first match
    ("bn_stats kernels (csrc/bn_stats.cu)", ("bn_partial", "bn_finalize")),
    ("pack kernel (csrc/pack.cu)", ("pack_kernel",)),
    ("convolutions and dense (cuDNN/cuBLAS)",
     ("conv", "gemm", "xmma", "cudnn", "sm90", "cutlass", "dgrad", "wgrad",
      "nchwToNhwc", "nhwcToNchw")),
    ("reductions (torch)", ("reduce",)),
    ("elementwise and copies (torch)",
     ("elementwise", "vectorized", "copy", "fill", "Memcpy", "Memset")),
    ("pooling", ("pool",)),
)


def profile_steps(torch, step, n, log):
    """Device time by kernel over ``n`` steps with torch.profiler: the
    busy share of the window and the time of each layer of the step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and str(ev.device_type).endswith("CUDA"):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    check(busy > 0, "the profiler recorded no device time")
    groups = {}
    for name, ms in kernels.items():
        group = next((g for g, pats in KERNEL_GROUPS
                      if any(p.lower() in name.lower() for p in pats)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"  profile of {n} steps: wall {wall_ms / n:.2f} ms/step, device "
        f"busy {busy / n:.2f} ms/step ({100 * busy / wall_ms:.1f}%)")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group}: {ms / n:.3f} ms/step ({100 * ms / busy:.1f}% of "
            f"device time)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    kernel {ms / n:.3f} ms/step  {name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10,
                    help="steps in each timed window")
    ap.add_argument("--windows", type=int, default=3,
                    help="timed windows (their spread is printed beside "
                         "the img/s over all of them)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed launches per kernel and shape")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the timed steps, trace N more with "
                         "torch.profiler and print device time by layer")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # the repo's kernel configuration of the main path: the pack kernel on
    # (read once at init, as in the reference)
    os.environ["HOROVOD_PALLAS_PACK"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.engine import bucket_by_size
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import build, kernels as K

    def log(msg):
        print(msg, flush=True)

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    try:
        hvd.init()
        check(hvd.size() == 1 and hvd.device() == dev,
              f"unexpected world {hvd.size()} on {hvd.device()}")
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

        log("phase 1: kernels against their plain versions")
        bn_shapes = resnet50_bn_shapes(args.batch)
        check(len(bn_shapes) == 53, f"{len(bn_shapes)} BN layers, not 53")
        bn_rows = check_bn_kernels(torch, K, dev, bn_shapes, flush,
                                   args.reps, log)
        param_shapes = [tuple(p.shape) for p in ResNet50(
            num_classes=1000, fused_bn=True).parameters()]
        pack_row, _ = check_pack_kernel(torch, K, bucket_by_size, dev,
                                        param_shapes, flush, args.reps, log)
        check(pack_row["buckets"] == 2,
              f"{pack_row['buckets']} buckets at 64 MB, expected 2")
        del flush
        torch.cuda.empty_cache()

        log(f"phase 2: ResNet-50 training, batch {args.batch}, "
            f"{args.warmup} + {args.windows} x {args.steps} steps")
        model, step = make_trainer(torch, hvd, ResNet50, dev, args.batch)
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, img_s, rates = train(torch, step, args.batch, args.warmup,
                              args.steps, args.windows, log)
        check(all(v == v and abs(v) != float("inf") for v in losses),
              "non-finite loss")
        check(losses[-1] < losses[0], "loss did not fall on the fixed batch")
        if args.profile:
            profile_steps(torch, step, args.profile, log)
        n_steps = args.warmup + args.windows * args.steps + args.profile
        grads = [p.grad for p in model.parameters()]
        log(f"  {img_s:.1f} img/s over all timed steps (windows: "
            f"{', '.join(f'{r:.1f}' for r in rates)}), peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

        log("phase 3: grouped_allreduce of the step's gradients through "
            "the pack kernel")
        for op in (hvd.Sum, hvd.Average):
            outs = hvd.grouped_allreduce(grads, name=f"smoke.{op.name}",
                                         op=op)
            torch.cuda.synchronize()
            check(all(torch.equal(o, g) for o, g in zip(outs, grads)),
                  f"grouped_allreduce op={op.name} at size 1 changed "
                  "its inputs")
        counts = K.launch_counts()
        log(f"  launches on the main path: {counts} over {n_steps} steps "
            f"and 2 grouped allreduces")
        check(counts["bn_stats"] == 53 * n_steps,
              f"bn_stats launched {counts['bn_stats']}, "
              f"expected {53 * n_steps}")
        check(counts["bn_bwd_stats"] == 53 * n_steps,
              f"bn_bwd_stats launched {counts['bn_bwd_stats']}, "
              f"expected {53 * n_steps}")
        check(counts["pack"] == 2 * pack_row["buckets"],
              f"pack launched {counts['pack']}, expected "
              f"{2 * pack_row['buckets']}")
    finally:
        hvd.shutdown()

    src = "horovod_tpu_torch/csrc"
    kernels = [
        dict(name="pack", route="cuda", source=f"{src}/pack.cu",
             replaces="horovod_tpu/ops/pallas_kernels.py:138",
             launches=counts["pack"], max_abs_err=pack_row["max_abs_err"],
             ms=pack_row["ms"], host_ms=pack_row["host_ms"],
             plain_ms=pack_row["plain_ms"],
             bound_ms=pack_row["bound_ms"], bound_by="bytes",
             library_ms=pack_row["library_ms"], ok=True,
             work="ResNet-50 fp32 gradients, 2 buckets at 64 MB"),
        dict(name="bn_stats", route="cuda", source=f"{src}/bn_stats.cu",
             replaces="horovod_tpu/ops/pallas_kernels.py:223",
             launches=counts["bn_stats"], library_ms=None, bound_by="bytes",
             ok=True, work=f"53 BN layers of ResNet-50, batch {args.batch}",
             **bn_rows["bn_stats"]),
        dict(name="bn_bwd_stats", route="cuda", source=f"{src}/bn_stats.cu",
             replaces="horovod_tpu/ops/pallas_kernels.py:265",
             launches=counts["bn_bwd_stats"], library_ms=None,
             bound_by="bytes", ok=True,
             work=f"53 BN layers of ResNet-50, batch {args.batch}",
             **bn_rows["bn_bwd_stats"]),
    ]
    print(json.dumps({"kernels": kernels, "img_per_s": img_s,
                      "img_per_s_windows": rates, "batch": args.batch}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
