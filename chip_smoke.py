#!/usr/bin/env python3
"""Chip smoke test of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` and then:

1. holds each of K1-K3 against its plain PyTorch version on the card at
   ResNet-50's shapes (batch 64, 224x224) and times both with CUDA events;
2. drives the main path: ``hvd.init()`` on NCCL, ``ResNet50(fused_bn=True)``
   in bf16, ``broadcast_parameters``, ``DistributedOptimizer(SGD)``, a few
   training steps on a fixed synthetic batch (losses finite and falling);
3. runs ``hvd.grouped_allreduce`` on the step's gradients with the pack
   kernel on (``HOROVOD_PALLAS_PACK=1``), at op Sum and Average;
4. holds the four K6 flash-attention kernels against their plain versions
   computed in fp32 from the same bf16 inputs, at the flagship LM's
   attention (B4 H16 T2048 D128, causal), ViT-B/16's (B32 H12 T197 D64,
   full) and a causal T = 1000 tail-tile shape, and times them beside
   ``scaled_dot_product_attention`` (a yardstick only, never on the path);
5. trains the flagship decoder LM (d2048 x 4 layers, T 2048, batch 4,
   bf16, ``attention="flash"``) through ``broadcast_parameters`` and
   ``DistributedOptimizer(AdamW)`` (losses finite and falling, tokens/s);
6. runs ``hvd.grouped_allreduce`` on the LM's gradients through the pack
   kernel (the 268 MB embedding gradient is a bucket of its own);
7. trains ViT-B/16 at batch 32, 224 px, three SGD-momentum steps;
8. holds the three K7 ring-segment kernels against their plain versions
   computed in fp32 from the same bf16 inputs, at the zig-zag ring's FULL
   and DIAG half-segments of B1 H16 T8192 D128 (strided lse/di halves),
   the contiguous n=1 ring's whole segment and a T = 2000, D 64 tail-tile
   shape, and times them beside SDPA's forward (a yardstick only);
9. drives ring attention's multi-rank code path on one card
   (``ring_attention_p(..., force_ring=True)``) at bench.py's
   ``bench_sp_ring`` shape, B1 T8192 H16 D128 bf16, zig-zag and
   contiguous, forward and backward of sum(out²), against K6 on the same
   inputs, and times the three in turns;
10. holds Adasum's combine kernels K4 (the fp32 triple) and K5 (the scaled
    add) against float64 and their plain versions at every gradient size
    of the flagship LM and at tails, in fp32 and bf16 (bitwise repeatable,
    swap-symmetric, a zero operand), and times them beside ``torch.dot``
    (a yardstick of one read of both operands, never on the path);
11. reduces the flagship LM's 34 fp32 gradients of 4 ranks (one sequence
    each of the flagship batch of 4) with ``adasum_stacked``, the VHDD
    schedule in one process, flat (2 levels) and hierarchical (local size
    2), against a float64 VHDD of the same gradients, times each whole
    reduction, and applies one AdamW step through
    ``DistributedOptimizer(op=Adasum)``.

Launch counts are zeroed just before each path (phases 2-3, 5, 6, 7, 9, and
each form of 11) and read just after it; every kernel of the path must have
launched there (53 BN layers per ResNet step for each BN kernel, one pack
per 64 MB bucket, one of each K6 kernel per attention layer and step, 3 of
each K7 kernel per zig-zag ring call and 1 per contiguous one, one K4 and
one K5 per pair, level and tensor: 136 each for the flat form, 68 for the
hierarchical one, whose 2 shards a pair halve the work). Any failed check
exits non-zero with no result. The line before the last is
``nvidia-smi``'s name and power limit, the one before it the ``kernels``
JSON, and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
BN_REL_TOL = 1e-5              # of sum |terms|: fp32 sums in another order

# K6 at the main path's attention calls: (what, B, H, T, D, causal)
FLASH_SHAPES = (("flagship LM", 4, 16, 2048, 128, True),
                ("ViT-B/16", 32, 12, 197, 64, False),
                ("tail tile", 4, 8, 1000, 64, True))
FLASH_KERNELS = ("flash_fwd", "flash_bwd_pre", "flash_bwd_dkdv",
                 "flash_bwd_dq")
# the flagship LM (bench.py's bench_transformer configuration)
LM_DIMS = dict(vocab_size=32768, d_model=2048, n_heads=16, n_layers=4,
               d_ff=8192, max_seq=2048)
LM_WINDOW_STEPS = 5            # steps in each timed window of the LM
VIT_LAYERS = 12
# K7 at the ring path's segments: (what, B, H, T, D, part) with q, k, v
# [B, T, H, D]; "full" is q's zig-zag hi half against the lo half of k/v
# (S = T/2, every key visible), "diag" the lo halves (the causal diagonal),
# "whole" the contiguous n=1 ring's one segment (S = T). lse and di are the
# causal attention's over all T, their halves strided as the ring has them.
SEG_SHAPES = (("zigzag half, FULL", 1, 16, 8192, 128, "full"),
              ("zigzag half, DIAG", 1, 16, 8192, 128, "diag"),
              ("contiguous n=1, DIAG", 1, 16, 8192, 128, "whole"),
              ("tail tile, FULL", 4, 8, 2000, 64, "full"),
              ("tail tile, DIAG", 4, 8, 2000, 64, "diag"))
SEG_KERNELS = ("flash_seg_fwd", "flash_seg_bwd_dkdv", "flash_seg_bwd_dq")
# the ring path on one card: bench.py:bench_sp_ring's shape, B, T, H, D
RING_SHAPE = (1, 8192, 16, 128)
RING_WINDOWS = 5               # timed windows of each ring-path variant
RING_WINDOW_CALLS = 4          # forward + backward calls in each window
# K7 launches of one ring forward + backward at n = 1, per layout
RING_LAUNCHES = {"zigzag": 3, "contiguous": 1}
# K4/K5 at the Adasum path's tensors: every distinct gradient size of the
# flagship LM, then tails
ADASUM_SIZES = (("tied embedding", 67108864), ("d_ff matrix", 16777216),
                ("attention projection", 4194304), ("norm scale", 2048),
                ("tail", 1), ("tail", 1000), ("tail", 65537))
ADASUM_KERNELS = ("adasum_triple", "adasum_scale")
ADASUM_TRIPLE_TOL = 1e-5       # of sum |terms|: fp32 sums in another order
ADASUM_RANKS = 4               # stacked ranks of phase 11
ADASUM_LOCAL = 2               # the hierarchical form's local size
ADASUM_WINDOWS = 5             # timed whole reductions of each form


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


def flash_pairs(b, h, t, causal):
    """The (q, kv) pairs this run's mask lets through."""
    return b * h * (t * (t + 1) // 2 if causal else t * t)


def flash_work(b, h, t, d, causal):
    """Per K6 kernel: (bytes, operations, peak operations/s). Bytes count
    each input read once and each output written once; operations are the
    products over the (q, kv) pairs this run's mask lets through."""
    pairs = flash_pairs(b, h, t, causal)
    x = b * h * t * d * 2          # one bf16 [B, H, T, D] tensor
    st = b * h * t * 4             # one fp32 [B, H, T] tensor (lse, di)
    return {
        # S = QK^T and O = PV
        "flash_fwd": (4 * x + st, 4 * d * pairs, BF16_FLOPS),
        # di = rowsum(dO * O), fp32 outside the tensor cores
        "flash_bwd_pre": (2 * x + st, 2 * b * h * t * d, FP32_FLOPS),
        # S^T, dV += P^T dO, dP^T = V dO^T, dK += dS^T Q
        "flash_bwd_dkdv": (6 * x + 2 * st, 8 * d * pairs, BF16_FLOPS),
        # S, dP = dO V^T, dQ += dS K
        "flash_bwd_dq": (5 * x + 2 * st, 6 * d * pairs, BF16_FLOPS),
    }


def check_flash_kernels(torch, K, dev, flush, reps, log):
    """K6 against its plain versions at each of FLASH_SHAPES: each output's
    error against the plain version in fp32 (from the same bf16 inputs) is
    at most twice the bf16 plain version's, plus 1e-3 of the largest entry.
    Returns a row per kernel (numbers at the flagship shape, every shape
    under "shapes") and a fwd/fwd+bwd summary per shape beside SDPA's."""
    import torch.nn.functional as F
    rows = {n: {"shapes": []} for n in FLASH_KERNELS}
    summary = []
    for what, b, h, t, d, causal in FLASH_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(2)
        # laid out [B, T, H, D], as the models project them; the kernels
        # take the [B, H, T, D] views with their strides
        q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=gen)
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
        scale = d ** -0.5
        f32 = [x.float() for x in (q, k, v, do)]
        o32, lse32 = K.flash_attention_fwd_plain(*f32[:3], causal, scale)
        di32 = K.flash_bwd_pre_plain(o32, f32[3])
        dk32, dv32 = K.flash_bwd_dkdv_plain(*f32, lse32, di32, causal, scale)
        dq32 = K.flash_bwd_dq_plain(*f32, lse32, di32, causal, scale)
        del f32, di32
        ob, lseb = K.flash_attention_fwd_plain(q, k, v, causal, scale)
        dib = K.flash_bwd_pre_plain(ob, do)
        dkb, dvb = K.flash_bwd_dkdv_plain(q, k, v, do, lseb, dib, causal,
                                          scale)
        dqb = K.flash_bwd_dq_plain(q, k, v, do, lseb, dib, causal, scale)
        o, lse = K.flash_fwd(q, k, v, causal, scale)
        di = K.flash_bwd_pre(o, do)
        dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, causal, scale)
        dq = K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale)
        torch.cuda.synchronize()
        err = {}
        for name, got, want, plain in (
                ("o", o, o32, ob), ("lse", lse, lse32, lseb),
                ("dq", dq, dq32, dqb), ("dk", dk, dk32, dkb),
                ("dv", dv, dv32, dvb)):
            err[name] = float((got.float() - want).abs().max())
            base = float((plain.float() - want).abs().max())
            limit = 2 * base + 1e-3 * float(want.abs().max())
            log(f"  {what} {name}: kernel error {err[name]:.4g}, bf16 "
                f"plain error {base:.4g}, limit {limit:.4g}")
            check(err[name] <= limit,
                  f"K6 {what} {name}: error {err[name]:.4g} > {limit:.4g}")
        di_ref = K.flash_bwd_pre_plain(o, do)
        err["di"] = float((di - di_ref).abs().max())
        # fp32 sums of the same products in another order
        check(err["di"] <= 1e-5 * float(di_ref.abs().max()) + 1e-6,
              f"K6 {what} di: error {err['di']:.4g}")
        del o32, lse32, dq32, dk32, dv32, ob, lseb, dib, dkb, dvb, dqb
        errors = {"flash_fwd": max(err["o"], err["lse"]),
                  "flash_bwd_pre": err["di"],
                  "flash_bwd_dkdv": max(err["dk"], err["dv"]),
                  "flash_bwd_dq": err["dq"]}

        calls = {
            "flash_fwd": (lambda: K.flash_fwd(q, k, v, causal, scale),
                          lambda: K.flash_attention_fwd_plain(
                              q, k, v, causal, scale)),
            "flash_bwd_pre": (lambda: K.flash_bwd_pre(o, do),
                              lambda: K.flash_bwd_pre_plain(o, do)),
            "flash_bwd_dkdv": (
                lambda: K.flash_bwd_dkdv(q, k, v, do, lse, di, causal, scale),
                lambda: K.flash_bwd_dkdv_plain(q, k, v, do, lse, di, causal,
                                               scale)),
            "flash_bwd_dq": (
                lambda: K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale),
                lambda: K.flash_bwd_dq_plain(q, k, v, do, lse, di, causal,
                                             scale)),
        }
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg,
                                                  is_causal=causal)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            return torch.autograd.grad(out, (qg, kg, vg), do)

        def kernel_fwd_bwd():
            o_, lse_ = K.flash_fwd(q, k, v, causal, scale)
            di_ = K.flash_bwd_pre(o_, do)
            K.flash_bwd_dkdv(q, k, v, do, lse_, di_, causal, scale)
            return K.flash_bwd_dq(q, k, v, do, lse_, di_, causal, scale)

        with torch.no_grad():
            sdpa_fwd_ms, _ = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), flush, reps)
        sdpa_bwd_ms, _ = time_ms(
            torch, lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                               retain_graph=True),
            flush, reps)
        sdpa_fb_ms, _ = time_ms(torch, sdpa_fwd_bwd, flush, reps)
        fb_ms, fb_host_ms = time_ms(torch, kernel_fwd_bwd, flush, reps)
        work = flash_work(b, h, t, d, causal)
        for name, (kern, plain) in calls.items():
            ms, host_ms = time_ms(torch, kern, flush, reps)
            plain_ms, _ = time_ms(torch, plain, flush, max(3, reps // 4))
            nbytes, ops, peak = work[name]
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / peak)
            entry = dict(what=what, shape=[b, h, t, d], causal=causal, ms=ms,
                         host_ms=host_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms,
                         bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                   >= ops / peak else "operations"),
                         library_ms=(sdpa_fwd_ms if name == "flash_fwd"
                                     else None),
                         max_abs_err=errors[name])
            rows[name]["shapes"].append(entry)
            log(f"  {what} {name}: kernel {ms:.4f} ms (host {host_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({entry['bound_by']})")
        # attention forward and backward as one function: the products of
        # the forward (S, O: 4 D a pair) and of the backward (S again, dP,
        # dV, dK, dQ: 10 D a pair) on the tensor cores, after the pass that
        # reads dO and O for di, which the backward's dS waits for. The
        # kernels' own bounds add up to more: dq recomputes S and dP.
        fb_bound = 1e3 * (14 * d * flash_pairs(b, h, t, causal) / BF16_FLOPS
                          + work["flash_bwd_pre"][0] / HBM_BYTES_PER_S)
        summary.append(dict(what=what, fwd_ms=rows["flash_fwd"]["shapes"][-1]
                            ["ms"], fwd_bwd_ms=fb_ms,
                            fwd_bwd_host_ms=fb_host_ms,
                            fwd_bwd_bound_ms=fb_bound,
                            sdpa_fwd_ms=sdpa_fwd_ms, sdpa_bwd_ms=sdpa_bwd_ms,
                            sdpa_fwd_bwd_ms=sdpa_fb_ms))
        log(f"  {what}: K6 fwd+bwd {fb_ms:.4f} ms (bound {fb_bound:.4f} "
            f"ms); SDPA fwd {sdpa_fwd_ms:.4f} ms, bwd {sdpa_bwd_ms:.4f} ms, "
            f"fwd+bwd {sdpa_fb_ms:.4f} ms")
        del q, k, v, do, o, lse, di, dk, dv, dq, qg, kg, vg, sdpa_out
        torch.cuda.empty_cache()
    for name in FLASH_KERNELS:
        first = rows[name]["shapes"][0]
        rows[name].update({key: first[key] for key in
                           ("ms", "host_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")})
        rows[name]["max_abs_err"] = max(e["max_abs_err"]
                                        for e in rows[name]["shapes"])
    return rows, summary


def seg_work(b, h, s, d, causal):
    """Per K7 kernel on one [B, H, S, D] segment: (bytes, operations, peak
    operations/s), counted as for K6 with fp32 outputs."""
    pairs = flash_pairs(b, h, s, causal)
    x = b * h * s * d * 2          # one bf16 [B, H, S, D] tensor
    xf = 2 * x                     # one fp32 [B, H, S, D] tensor
    st = b * h * s * 4             # one fp32 [B, H, S] tensor (lse, di)
    return {
        "flash_seg_fwd": (3 * x + xf + st, 4 * d * pairs, BF16_FLOPS),
        "flash_seg_bwd_dkdv": (4 * x + 2 * st + 2 * xf, 8 * d * pairs,
                               BF16_FLOPS),
        "flash_seg_bwd_dq": (4 * x + 2 * st + xf, 6 * d * pairs, BF16_FLOPS),
    }


def check_seg_kernels(torch, K, dev, flush, reps, log):
    """K7 against its plain versions at each of SEG_SHAPES, as phase 4 holds
    K6: each output's error against the plain version in fp32 (from the
    same bf16 inputs) is at most twice the bf16 plain version's, plus 1e-3
    of the largest entry, and the kernels give the same bits on the strided
    views as on contiguous copies of them. Returns a row per kernel
    (numbers at the first shape, every shape under "shapes")."""
    import torch.nn.functional as F
    rows = {n: {"shapes": []} for n in SEG_KERNELS}
    for what, b, h, t, d, part in SEG_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(3)
        q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=gen)
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
        scale = d ** -0.5
        # the global lse and di of causal attention over all T (K6)
        o, lse = K.flash_fwd(q, k, v, True, scale)
        di = K.flash_bwd_pre(o, do)
        del o
        s = t if part == "whole" else t // 2
        rows_q = slice(t - s, t) if part == "full" else slice(0, s)
        rows_kv = slice(0, s)
        causal = part != "full"
        seg = (q[:, :, rows_q], k[:, :, rows_kv], v[:, :, rows_kv],
               do[:, :, rows_q], lse[:, :, rows_q], di[:, :, rows_q])
        sq, sk, sv, sdo, slse, sdi = seg
        f32 = [x.float() for x in seg]
        o32, lse32 = K.flash_seg_fwd_plain(*f32[:3], causal, scale)
        dq32, dk32, dv32 = K.flash_seg_bwd_plain(
            f32[0], f32[1], f32[2], f32[4], f32[3], f32[5], causal, scale)
        del f32
        ob, lseb = K.flash_seg_fwd_plain(sq, sk, sv, causal, scale)
        dqb, dkb, dvb = K.flash_seg_bwd_plain(sq, sk, sv, slse, sdo, sdi,
                                              causal, scale)
        kargs = (sq, sk, sv, sdo, slse, sdi, causal, scale)
        o_k, lse_k = K.flash_seg_fwd(sq, sk, sv, causal, scale)
        dk_k, dv_k = K.flash_seg_bwd_dkdv(*kargs)
        dq_k = K.flash_seg_bwd_dq(*kargs)
        cont = [x.contiguous() for x in seg]
        again = (*K.flash_seg_fwd(*cont[:3], causal, scale),
                 *K.flash_seg_bwd_dkdv(*cont, causal, scale),
                 K.flash_seg_bwd_dq(*cont, causal, scale))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in
                  zip((o_k, lse_k, dk_k, dv_k, dq_k), again)),
              f"K7 {what}: strided views and contiguous copies differ")
        del cont, again
        err = {}
        for name, got, want, plain in (
                ("o", o_k, o32, ob), ("lse", lse_k, lse32, lseb),
                ("dq", dq_k, dq32, dqb), ("dk", dk_k, dk32, dkb),
                ("dv", dv_k, dv32, dvb)):
            check(bool(torch.isfinite(got).all()),
                  f"K7 {what} {name}: not finite")
            err[name] = float((got.float() - want).abs().max())
            base = float((plain.float() - want).abs().max())
            limit = 2 * base + 1e-3 * float(want.abs().max())
            log(f"  {what} {name}: kernel error {err[name]:.4g}, bf16 "
                f"plain error {base:.4g}, limit {limit:.4g}")
            check(err[name] <= limit,
                  f"K7 {what} {name}: error {err[name]:.4g} > {limit:.4g}")
        del o32, lse32, dq32, dk32, dv32, ob, lseb, dqb, dkb, dvb
        errors = {"flash_seg_fwd": max(err["o"], err["lse"]),
                  "flash_seg_bwd_dkdv": max(err["dk"], err["dv"]),
                  "flash_seg_bwd_dq": err["dq"]}
        calls = {
            "flash_seg_fwd": (
                lambda: K.flash_seg_fwd(sq, sk, sv, causal, scale),
                lambda: K.flash_seg_fwd_plain(sq, sk, sv, causal, scale)),
            "flash_seg_bwd_dkdv": (
                lambda: K.flash_seg_bwd_dkdv(*kargs),
                lambda: K.flash_seg_bwd_dkdv_plain(*kargs)),
            "flash_seg_bwd_dq": (
                lambda: K.flash_seg_bwd_dq(*kargs),
                lambda: K.flash_seg_bwd_dq_plain(*kargs)),
        }
        with torch.no_grad():
            sdpa_ms, _ = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, is_causal=causal), flush, reps)
        work = seg_work(b, h, s, d, causal)
        for name, (kern, plain) in calls.items():
            ms, host_ms = time_ms(torch, kern, flush, reps)
            plain_ms, _ = time_ms(torch, plain, flush, max(3, reps // 4))
            nbytes, ops, peak = work[name]
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / peak)
            entry = dict(what=what, shape=[b, h, s, d], causal=causal,
                         ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms,
                         bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                   >= ops / peak else "operations"),
                         library_ms=(sdpa_ms if name == "flash_seg_fwd"
                                     else None),
                         max_abs_err=errors[name])
            rows[name]["shapes"].append(entry)
            log(f"  {what} {name}: kernel {ms:.4f} ms (host {host_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({entry['bound_by']})"
                + (f", SDPA forward {sdpa_ms:.4f} ms"
                   if name == "flash_seg_fwd" else ""))
        del q, k, v, do, lse, di, seg, sq, sk, sv, sdo, slse, sdi, kargs
        del o_k, lse_k, dk_k, dv_k, dq_k, calls
        torch.cuda.empty_cache()
    for name in SEG_KERNELS:
        first = rows[name]["shapes"][0]
        rows[name].update({key: first[key] for key in
                           ("ms", "host_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")})
        rows[name]["max_abs_err"] = max(e["max_abs_err"]
                                        for e in rows[name]["shapes"])
    return rows


def run_ring_path(torch, K, R, fa, dev, log):
    """Phase 9: ring attention's multi-rank code path on one card
    (``force_ring=True``, identity hop), zig-zag and contiguous, forward
    and backward of sum(out²) at RING_SHAPE, against K6 on the same inputs.
    Checks the outputs and gradients, the K7 launches of each call, and
    times the three in turns. Returns the ``ring`` summary."""
    b, t, h, d = RING_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(4)
    base = [(torch.randn(b, t, h, d, device=dev, generator=gen) * 0.3)
            .to(torch.bfloat16) for _ in range(3)]

    def fwd_bwd(fn):
        q, k, v = (x.detach().requires_grad_() for x in base)
        out = fn(q, k, v)
        (out.float() ** 2).sum().backward()
        return out.detach(), q.grad, k.grad, v.grad

    paths = {
        layout: (lambda q, k, v, layout=layout: R.ring_attention_p(
            q, k, v, None, 1, causal=True, layout=layout, force_ring=True))
        for layout in RING_LAUNCHES}
    paths["flash"] = lambda q, k, v: fa.flash_attention_local(q, k, v,
                                                              causal=True)

    # references, [B, H, T, D]: fp32 from the same bf16 inputs, and the
    # bf16 plain version, each with its own loss's gradient 2·out
    f32 = [x.float().transpose(1, 2) for x in base]
    o32, lse32 = K.flash_attention_fwd_plain(*f32, True, scale)
    ref32 = (o32, *K.flash_attention_bwd_plain(*f32, o32, lse32, 2 * o32,
                                               True, scale))
    del f32, lse32
    bf = [x.transpose(1, 2) for x in base]
    ob, lseb = K.flash_attention_fwd_plain(*bf, True, scale)
    refb = (ob, *K.flash_attention_bwd_plain(
        *bf, ob, lseb, (2 * ob.float()).to(torch.bfloat16), True, scale))
    del bf, lseb
    names = ("out", "dq", "dk", "dv")
    base_err = [float((x.float() - w).abs().max())
                for x, w in zip(refb, ref32)]
    limits = [2 * e + 1e-3 * float(w.abs().max())
              for e, w in zip(base_err, ref32)]
    del refb

    K.reset_launch_counts()
    results, per_call = {}, {}
    for name, fn in paths.items():
        n0 = K.launch_counts()
        res = fwd_bwd(fn)
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        per_call[name] = {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
        results[name] = [x.transpose(1, 2) for x in res]
    log(f"  launches per forward + backward: {per_call}")
    for layout, count in RING_LAUNCHES.items():
        for kern in SEG_KERNELS:
            check(per_call[layout].get(kern, 0) == count,
                  f"{layout} ring: {kern} launched "
                  f"{per_call[layout].get(kern, 0)} times, expected {count}")
        check(per_call[layout].get("flash_fwd", 0) == 0,
              f"{layout} ring launched K6's forward")
    errors = {}
    for layout in RING_LAUNCHES:
        for name, got, want, w32, lim in zip(
                names, results[layout], results["flash"], ref32, limits):
            e = float((got.float() - want.float()).abs().max())
            e32 = float((got.float() - w32).abs().max())
            errors[f"{layout}_{name}"] = e
            log(f"  {layout} ring {name}: against K6 {e:.4g} (limit "
                f"{lim:.4g}), against fp32 {e32:.4g}")
            check(bool(torch.isfinite(got).all()),
                  f"{layout} ring {name}: not finite")
            check(e <= lim, f"{layout} ring {name}: {e:.4g} from K6 > "
                  f"{lim:.4g}")
    del results, ref32

    windows = {name: [] for name in paths}
    for _ in range(RING_WINDOWS):
        for name, fn in paths.items():   # in turns: drift hits all alike
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(RING_WINDOW_CALLS):
                fwd_bwd(fn)
            end.record()
            torch.cuda.synchronize()
            windows[name].append(start.elapsed_time(end) / RING_WINDOW_CALLS)
    ms = {name: statistics.median(w) for name, w in windows.items()}
    pairs = flash_pairs(b, h, t, True)
    products_ms = 1e3 * 14 * d * pairs / BF16_FLOPS
    di_ms = 1e3 * (2 * b * h * t * d * 2 + b * h * t * 4) / HBM_BYTES_PER_S
    for name, w in windows.items():
        log(f"  {name}: {ms[name]:.4f} ms per forward + backward (windows "
            f"{', '.join(f'{x:.4f}' for x in w)})")
    ratio = ms["flash"] / ms["zigzag"]
    log(f"  K6 / zig-zag ring time (the reference's sp_ring_path_vs_flash): "
        f"{ratio:.4f}; bound {products_ms + di_ms:.4f} ms ({products_ms:.4f} "
        f"ms of products, {di_ms:.4f} ms of di bytes)")
    return dict(shape=list(RING_SHAPE), ms=ms, windows=windows,
                ring_path_vs_flash=ratio,
                bound_ms=products_ms + di_ms, products_bound_ms=products_ms,
                launches_per_call=per_call, max_abs_err_vs_flash=errors,
                limits=dict(zip(names, limits)))


def adasum_work(n, itemsize):
    """Per K4/K5 call on n elements: (bytes, fp32 operations). K4 reads a
    and b and writes the triple, 3 fused multiply-adds an element; K5
    reads the triple, a and b and writes the output, 3 operations an
    element."""
    return {"adasum_triple": (2 * n * itemsize + 12, 6 * n),
            "adasum_scale": (3 * n * itemsize + 12, 3 * n)}


def triple64(torch, a, b):
    af, bf = a.double(), b.double()
    return torch.stack([(af * bf).sum(), (af * af).sum(), (bf * bf).sum()])


def combine64(torch, a, b):
    """The float64 pairwise Adasum (the reference's adasum_reference)."""
    dot, na, nb = (float(v) for v in triple64(torch, a, b))
    ca = 0.0 if na == 0 else 1.0 - dot / (2 * na)
    cb = 0.0 if nb == 0 else 1.0 - dot / (2 * nb)
    return ca * a.double() + cb * b.double()


def check_adasum_kernels(torch, K, dev, flush, reps, log):
    """Phase 10: K4/K5 at each of ADASUM_SIZES in fp32 and bf16. K4's
    triple within ADASUM_TRIPLE_TOL of sum |terms| of float64's; K5's
    output within twice the plain version's error against float64 plus
    the dtype's epsilon and 1e-6 of the largest entry; bitwise repeatable,
    swap-symmetric, and a zero operand gives the other bit for bit.
    Returns a row per kernel (numbers at the embedding in fp32, every case
    under "shapes")."""
    rows = {n: {"shapes": []} for n in ADASUM_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for what, n in ADASUM_SIZES:
            gen = torch.Generator(device=dev).manual_seed(6)
            a = torch.randn(n, device=dev, generator=gen)
            b = 0.6 * a + torch.randn(n, device=dev, generator=gen)
            a, b = a.to(dtype), b.to(dtype)
            t = K.adasum_triple(a, b)
            out = K.adasum_scale(t, a, b)
            t_sw = K.adasum_triple(b, a)
            same = (torch.equal(K.adasum_triple(a, b), t)
                    and torch.equal(K.adasum_scale(t, a, b), out))
            sym = (torch.equal(t_sw, t[[0, 2, 1]])
                   and torch.equal(K.adasum_scale(t_sw, b, a), out))
            z = torch.zeros_like(a)
            zero = (torch.equal(K.adasum_scale(K.adasum_triple(z, b), z, b),
                                b)
                    and torch.equal(K.adasum_scale(K.adasum_triple(a, z), a,
                                                   z), a))
            torch.cuda.synchronize()
            case = f"{what} n={n} {str(dtype)[6:]}"
            check(same, f"K4/K5 {case}: two runs differ")
            check(sym, f"K4/K5 {case}: not swap-symmetric bit for bit")
            check(zero, f"K4/K5 {case}: a zero operand does not give the "
                  "other operand")
            t64 = triple64(torch, a, b)
            terms = torch.stack([(a.double() * b.double()).abs().sum(),
                                 t64[1], t64[2]])
            t_abs = float((t.double() - t64).abs().max())
            t_rel = float(((t.double() - t64).abs() / terms).max())
            check(t_rel <= ADASUM_TRIPLE_TOL,
                  f"K4 {case}: error {t_rel:.3g} of sum|terms| > "
                  f"{ADASUM_TRIPLE_TOL}")
            ref = combine64(torch, a, b)
            plain = K.adasum_scale_plain(K.adasum_triple_plain(a, b), a, b)
            err = float((out.double() - ref).abs().max())
            base = float((plain.double() - ref).abs().max())
            big = float(ref.abs().max())
            limit = 2 * base + (torch.finfo(dtype).eps + 1e-6) * big
            log(f"  {case}: K4 error {t_rel:.3g} of sum|terms|; K5 error "
                f"{err:.4g}, plain error {base:.4g}, limit {limit:.4g}")
            check(err <= limit, f"K5 {case}: error {err:.4g} > {limit:.4g}")
            del ref, plain, z, terms
            calls = {
                "adasum_triple": (lambda: K.adasum_triple(a, b),
                                  lambda: K.adasum_triple_plain(a, b)),
                "adasum_scale": (lambda: K.adasum_scale(t, a, b),
                                 lambda: K.adasum_scale_plain(t, a, b)),
            }
            errors = {"adasum_triple": t_abs, "adasum_scale": err}
            dot_ms, _ = time_ms(torch, lambda: torch.dot(a, b), flush, reps)
            work = adasum_work(n, a.element_size())
            timed = []
            for name, (kern, plain_fn) in calls.items():
                ms, host_ms = time_ms(torch, kern, flush, reps)
                plain_ms, _ = time_ms(torch, plain_fn, flush,
                                      max(3, reps // 4))
                nbytes, ops = work[name]
                bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     ops / FP32_FLOPS)
                rows[name]["shapes"].append(dict(
                    what=what, n=n, dtype=str(dtype)[6:], ms=ms,
                    host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                              >= ops / FP32_FLOPS else "operations"),
                    library_ms=None, dot_ms=dot_ms,
                    max_abs_err=errors[name],
                    **({"max_rel_err": t_rel} if name == "adasum_triple"
                       else {"limit": limit})))
                timed.append(f"{name} {ms:.4f} ms (host {host_ms:.4f}), "
                             f"plain {plain_ms:.4f}, bound {bound_ms:.4f}")
            log(f"  {case}: {'; '.join(timed)}; torch.dot {dot_ms:.4f} ms")
            del a, b, t, out, t_sw, calls
        torch.cuda.empty_cache()
    for name in ADASUM_KERNELS:
        first = rows[name]["shapes"][0]
        rows[name].update({key: first[key] for key in
                           ("ms", "host_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "dot_ms")})
        rows[name]["max_abs_err"] = first["max_abs_err"]
    return rows


def plain_stacked(torch, x, local, combine):
    """The (n, *s) stack's Adasum by the plain formula: the VHDD over the
    ranks, or over the nodes' means for the hierarchical form."""
    vs = list(x)
    if local > 1:
        vs = [x[c * local:(c + 1) * local].mean(0)
              for c in range(len(vs) // local)]
    d = 1
    while d < len(vs):
        vs = [combine(vs[r], vs[r ^ d]) for r in range(len(vs))]
        d *= 2
    return vs[0]


def run_adasum_path(torch, hvd, tm, K, A, dev, log):
    """Phase 11: the flagship LM's fp32 gradients of ADASUM_RANKS ranks
    (one sequence each) reduced by ``adasum_stacked``, flat and
    hierarchical, each driven with the launch counts zeroed just before it
    and read just after; each result against the float64 VHDD of the same
    gradients within twice the fp32 plain VHDD's error plus 1e-6 of its
    largest entry; the whole reduction timed in windows; one AdamW step
    through DistributedOptimizer(op=Adasum) with the flat result. Returns
    the ``adasum`` summary and the launches of each form."""
    cfg = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                               **LM_DIMS)
    model = tm.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    params = list(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (ADASUM_RANKS, cfg.max_seq + 1),
                           device=dev, generator=gen)
    per_rank = []
    for r in range(ADASUM_RANKS):
        model.zero_grad(set_to_none=True)
        tm.lean_lm_loss(model, tokens[r:r + 1, :-1],
                        tokens[r:r + 1, 1:]).backward()
        per_rank.append([p.grad for p in params])
    model.zero_grad(set_to_none=True)
    stacked = [torch.stack(gs) for gs in zip(*per_rank)]
    del per_rank
    n_elems = sum(p.numel() for p in params)
    check(len(stacked) == 34 and all(s.dtype == torch.float32
                                     for s in stacked),
          f"{len(stacked)} gradients, expected 34 fp32")
    log(f"  {len(stacked)} fp32 gradients, {n_elems} elements a rank, "
        f"{ADASUM_RANKS} ranks")
    summary, launches, flat_out = {}, {}, None
    for form, local in (("flat", 0), ("hierarchical", ADASUM_LOCAL)):
        K.reset_launch_counts()
        outs = [A.adasum_stacked(s, local_size=local) for s in stacked]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        launches[form] = {k: counts[k] for k in ADASUM_KERNELS}
        if local:
            cross = ADASUM_RANKS // local
            combines = (cross // 2) * int(math.log2(cross)) * local
            nbytes = (cross // 2) * int(math.log2(cross)) * 5 * 4 * n_elems
        else:
            combines = (ADASUM_RANKS // 2) * int(math.log2(ADASUM_RANKS))
            nbytes = combines * 5 * 4 * n_elems
        want = combines * len(stacked)
        log(f"  {form}: launches {launches[form]}, expected {want} each")
        for name in ADASUM_KERNELS:
            check(counts[name] == want, f"{form} Adasum: {name} launched "
                  f"{counts[name]}, expected {want}")
        worst, worst_plain = 0.0, 0.0
        for i, (s, o) in enumerate(zip(stacked, outs)):
            ref = plain_stacked(torch, s.double(), local,
                                lambda a, b: combine64(torch, a, b))
            plain = plain_stacked(
                torch, s, local, lambda a, b: K.adasum_scale_plain(
                    K.adasum_triple_plain(a, b), a, b))
            check(bool(torch.isfinite(o).all()),
                  f"{form} Adasum: gradient {i} not finite")
            big = float(ref.abs().max())
            err = float((o.double() - ref).abs().max())
            base = float((plain.double() - ref).abs().max())
            limit = 2 * base + 1e-6 * big
            check(err <= limit, f"{form} Adasum gradient {i} "
                  f"{tuple(s.shape[1:])}: error {err:.4g} > {limit:.4g}")
            worst = max(worst, err / big)
            worst_plain = max(worst_plain, base / big)
            del ref, plain
        log(f"  {form}: largest error against float64 {worst:.3g} of the "
            f"tensor's largest entry (fp32 plain VHDD {worst_plain:.3g})")
        windows, hosts = [], []
        for _ in range(ADASUM_WINDOWS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for s in stacked:
                A.adasum_stacked(s, local_size=local)
            hosts.append(1e3 * (time.perf_counter() - t0))
            end.record()
            torch.cuda.synchronize()
            windows.append(start.elapsed_time(end))
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ms = statistics.median(windows)
        log(f"  {form}: {ms:.3f} ms a whole reduction (windows "
            f"{', '.join(f'{w:.3f}' for w in windows)}; host "
            f"{statistics.median(hosts):.3f} ms), bound of its K4/K5 "
            f"bytes {bound_ms:.3f} ms")
        summary[form] = dict(local_size=local, ms=ms, windows=windows,
                             host_ms=statistics.median(hosts),
                             bound_ms=bound_ms, launches=launches[form],
                             max_rel_err=worst, plain_max_rel_err=worst_plain)
        if not local:
            flat_out = outs
        del outs
    del stacked
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=1e-4), op=hvd.Adasum)
    for p, g in zip(params, flat_out):
        p.grad = g
    opt.step()
    with torch.no_grad():
        loss = float(tm.lean_lm_loss(model, tokens[:, :-1], tokens[:, 1:]))
    check(loss == loss and abs(loss) != float("inf"),
          "non-finite LM loss after the Adasum step")
    log(f"  loss on the batch of {ADASUM_RANKS} after one AdamW step with the "
        f"flat Adasum gradients: {loss:.4f}")
    summary.update(ranks=ADASUM_RANKS, tensors=34, elements=n_elems,
                   loss_after_step=loss)
    del model, params, opt, flat_out
    return summary, launches


def make_lm_trainer(torch, hvd, tm, dev, batch):
    """The flagship LM, its data and optimizer; returns one train step."""
    cfg = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                               **LM_DIMS)
    model = tm.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                           device=dev, generator=gen)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # optax.adamw(3e-4)'s settings (PyTorch's weight decay default is 1e-2)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4), op=hvd.Average)

    def step():
        opt.zero_grad()
        loss = tm.lean_lm_loss(model, inputs, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    return cfg, model, step


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
    ("flash-attention kernels (csrc/flash_attn.cu)", ("flash_",)),
    ("bn_stats kernels (csrc/bn_stats.cu)", ("bn_partial", "bn_finalize")),
    ("pack kernel (csrc/pack.cu)", ("pack_kernel",)),
    ("convolutions and dense (cuDNN/cuBLAS)",
     ("conv", "gemm", "xmma", "cudnn", "sm90", "cutlass", "dgrad", "wgrad",
      "nvjet", "nchwToNhwc", "nhwcToNchw")),
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
        # a user annotation (the optimizer's step range) spans kernels that
        # are counted on their own
        if us > 0 and str(ev.device_type).endswith("CUDA") \
                and not getattr(ev, "is_user_annotation", False):
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
                    help="after the timed steps of ResNet-50 and of the LM, "
                         "trace N more with torch.profiler and print device "
                         "time by layer")
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
    from horovod_tpu_torch.models import transformer as tm
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.models.vit import ViT_B16
    from horovod_tpu_torch.ops import adasum as adasum_ops
    from horovod_tpu_torch.ops import build, kernels as K
    from horovod_tpu_torch.parallel import flash_attention, ring_attention

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
        del model, step, grads, outs
        torch.cuda.empty_cache()

        log("phase 4: K6 flash-attention kernels against their plain "
            "versions")
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
        flash_rows, attention = check_flash_kernels(torch, K, dev, flush,
                                                    args.reps, log)
        del flush
        torch.cuda.empty_cache()

        lm_batch = 4
        log(f"phase 5: flagship LM training, batch {lm_batch} x "
            f"{LM_DIMS['max_seq']} tokens, {args.warmup} + {args.windows} x "
            f"{LM_WINDOW_STEPS} steps")
        lm_cfg, lm, lm_step = make_lm_trainer(torch, hvd, tm, dev, lm_batch)
        n_params = sum(p.numel() for p in lm.parameters())
        log(f"  {n_params / 1e6:.1f} M parameters")
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        tokens = lm_batch * lm_cfg.max_seq
        lm_losses, tok_s, tok_rates = train(torch, lm_step, tokens,
                                            args.warmup, LM_WINDOW_STEPS,
                                            args.windows, log)
        check(all(v == v and abs(v) != float("inf") for v in lm_losses),
              "non-finite LM loss")
        check(lm_losses[-1] < lm_losses[0],
              "LM loss did not fall on the fixed batch")
        if args.profile:
            profile_steps(torch, lm_step, args.profile, log)
        lm_steps = (args.warmup + args.windows * LM_WINDOW_STEPS
                    + args.profile)
        lm_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        lm_counts = K.launch_counts()
        log(f"  {tok_s:.1f} tokens/s over all timed steps (windows: "
            f"{', '.join(f'{r:.1f}' for r in tok_rates)}), peak memory "
            f"{lm_peak:.2f} GiB")
        log(f"  launches on the LM path: {lm_counts} over {lm_steps} steps")
        for name in FLASH_KERNELS:
            want = lm_cfg.n_layers * lm_steps
            check(lm_counts[name] == want,
                  f"{name} launched {lm_counts[name]} on the LM path, "
                  f"expected {want}")

        log("phase 6: grouped_allreduce of the LM's gradients through the "
            "pack kernel")
        grads = [p.grad for p in lm.parameters()]
        buckets = bucket_by_size(grads, 64 * 1024 * 1024)
        check(buckets[0] == [0] and grads[0].shape == lm.embed.shape,
              "the embedding gradient is not a bucket of its own")
        K.reset_launch_counts()
        for op in (hvd.Sum, hvd.Average):
            outs = hvd.grouped_allreduce(grads, name=f"lm.{op.name}", op=op)
            torch.cuda.synchronize()
            check(all(torch.equal(o, g) for o, g in zip(outs, grads)),
                  f"grouped_allreduce op={op.name} of the LM's gradients at "
                  "size 1 changed its inputs")
        lm_pack = K.launch_counts()["pack"]
        log(f"  {len(buckets)} buckets ({grads[0].nbytes / 2**20:.0f} MiB "
            f"embedding gradient alone), {lm_pack} pack launches")
        check(lm_pack == 2 * len(buckets),
              f"pack launched {lm_pack}, expected {2 * len(buckets)}")
        del lm, lm_step, grads, outs
        torch.cuda.empty_cache()

        vit_batch = 32
        log(f"phase 7: ViT-B/16 training, batch {vit_batch}, 224 px, 3 "
            "steps")
        vit = ViT_B16(num_classes=1000, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        images = torch.rand(vit_batch, 224, 224, 3, device=dev,
                            generator=gen)
        labels = torch.randint(0, 1000, (vit_batch,), device=dev,
                               generator=gen)
        hvd.broadcast_parameters(vit.state_dict(), root_rank=0)
        vit_opt = hvd.DistributedOptimizer(
            torch.optim.SGD(vit.parameters(), lr=0.01, momentum=0.9),
            op=hvd.Average)
        K.reset_launch_counts()
        vit_losses = []
        for _ in range(3):
            vit_opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(vit(images), labels)
            loss.backward()
            vit_opt.step()
            vit_losses.append(float(loss.detach()))
        vit_counts = K.launch_counts()
        log(f"  losses: {' '.join(f'{v:.4f}' for v in vit_losses)}; "
            f"launches: {vit_counts}")
        check(all(v == v and abs(v) != float("inf") for v in vit_losses),
              "non-finite ViT loss")
        for name in FLASH_KERNELS:
            check(vit_counts[name] == VIT_LAYERS * 3,
                  f"{name} launched {vit_counts[name]} on the ViT path, "
                  f"expected {VIT_LAYERS * 3}")
        del vit, vit_opt, images
        torch.cuda.empty_cache()

        log("phase 8: K7 ring-segment kernels against their plain versions")
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
        seg_rows = check_seg_kernels(torch, K, dev, flush, args.reps, log)
        del flush
        torch.cuda.empty_cache()

        b, t, h, d = RING_SHAPE
        log(f"phase 9: the ring path on one card (force_ring), B{b} T{t} "
            f"H{h} D{d} causal, zig-zag and contiguous, against K6")
        K.reset_launch_counts()
        ring = run_ring_path(torch, K, ring_attention, flash_attention, dev,
                             log)
        ring_counts = K.launch_counts()
        log(f"  launches on the ring path: {ring_counts}")
        torch.cuda.empty_cache()

        log("phase 10: K4/K5 Adasum combine kernels against float64 and "
            "their plain versions")
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
        adasum_rows = check_adasum_kernels(torch, K, dev, flush, args.reps,
                                           log)
        del flush
        torch.cuda.empty_cache()

        log(f"phase 11: the flagship LM's Adasum reduction, {ADASUM_RANKS} "
            f"stacked ranks, flat and hierarchical (local size "
            f"{ADASUM_LOCAL})")
        adasum, adasum_launches = run_adasum_path(torch, hvd, tm, K,
                                                  adasum_ops, dev, log)
        torch.cuda.empty_cache()
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
             work="ResNet-50 fp32 gradients, 2 buckets at 64 MB",
             lm_launches=lm_pack),
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
    ] + [
        # the forward and the custom-VJP backward of the jax library kernel
        # that flash_attention_local calls there
        dict(name=name, route="cuda", source=f"{src}/flash_attn.cu",
             replaces="horovod_tpu/parallel/flash_attention.py:226",
             launches=lm_counts[name], vit_launches=vit_counts[name], ok=True,
             work="one attention layer of the flagship LM (B4 H16 T2048 "
                  "D128, causal); shapes lists every shape",
             **flash_rows[name])
        for name in FLASH_KERNELS] + [
        # the ring's per-segment kernels: _seg_fwd_pallas and the two
        # library backward kernels _seg_bwd_pallas calls
        dict(name=name, route="cuda", source=f"{src}/flash_attn.cu",
             replaces=f"horovod_tpu/parallel/ring_attention.py:{line}",
             launches=ring_counts[name], ok=True,
             work="the zig-zag ring's FULL half-segment (B1 H16 S4096 D128); "
                  "shapes lists every shape",
             **seg_rows[name])
        for name, line in zip(SEG_KERNELS, (169, 188, 194))] + [
        # adasum_combine_pallas's two passes
        dict(name=name, route="cuda", source=f"{src}/adasum.cu",
             replaces=f"horovod_tpu/ops/pallas_kernels.py:{line}",
             launches=adasum_launches["flat"][name],
             hierarchical_launches=adasum_launches["hierarchical"][name],
             ok=True,
             work="the flagship LM's tied embedding gradient (67,108,864 "
                  "fp32); shapes lists every size and dtype",
             **adasum_rows[name])
        for name, line in zip(ADASUM_KERNELS, (58, 77))]
    print(json.dumps({"kernels": kernels, "img_per_s": img_s,
                      "img_per_s_windows": rates, "batch": args.batch,
                      "tokens_per_s": tok_s, "tokens_per_s_windows":
                      tok_rates, "lm_batch": lm_batch,
                      "lm_peak_gib": lm_peak, "attention": attention,
                      "ring": ring, "adasum": adasum}))
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
