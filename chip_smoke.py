#!/usr/bin/env python3
"""Chip smoke test of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` (printing
the registers and spill bytes of each attention and BatchNorm kernel's
instantiations from the build's ``ptxas`` report; a spill fails the run)
and then:

1. holds each of K1-K3 against its plain PyTorch version on the card at
   ResNet-50's shapes (batch 64, 224x224) and times both with CUDA events:
   K2/K3 in both modes (the raw sums, and the module's per-channel math in
   the epilogue, which the main path launches), each shape's time beside
   ``torch.batch_norm_stats`` / ``torch.batch_norm_backward_reduce``
   (yardsticks only, never on the path) and the bound, summed over the
   step's 53 layers; the measure's own floor (a memset, K2 on a tiny
   input, the stem layer with and without the flush); K2/K3 on what the
   TMA route does not take (fp16 C=3,
   bf16 C=12, one row, an unaligned view); one ``FusedBatchNorm``
   layer's kernel launches forward and backward (at most 2 and 4); and
   K1's ``out=`` form (ZeRO-1's padded buckets) at ResNet-50's buckets
   with an unaligned tail, into buffers padded for 4 ranks, bitwise
   against its plain version and the padding untouched;
2. drives the main path: ``hvd.init()`` on NCCL, ``ResNet50(fused_bn=True)``
   in bf16, ``broadcast_parameters``, ``DistributedOptimizer(SGD)``, a few
   training steps on a fixed synthetic batch (losses finite and falling);
3. runs ``hvd.grouped_allreduce`` on the step's gradients with the pack
   kernel on (``HOROVOD_PALLAS_PACK=1``), at op Sum and Average;
4. holds the four K6 flash-attention kernels against their plain versions
   computed in fp32 from the same inputs, at the flagship LM's attention
   (B4 H16 T2048 D128, causal) in bf16 and in fp16, ViT-B/16's (B32 H12
   T197 D64, full), a causal T = 1000 tail-tile shape, fp32 inputs (B2 H8
   T1024 D64 causal, and phase 12's ViT_Tiny attention, B32 H4 T65 D16
   full: the Hopper tf32 forward, dk/dv and dq),
   ViT_Tiny's head dim 16 in bf16 and head dims 80
   and 96 (read in place by the D 128 kernels: every such shape logs the
   wrappers' zero-pad copies, and one on a Hopper route fails the run),
   q and k/v of different lengths, causal and full, and head dims above
   128 (bf16 B2 H8 T2048 D256 causal and fp16 D160 with 1024 queries over
   2048 keys: the Hopper wide kernels; bf16 B1 H4 T1024 D320: the Hopper
   forward, O in two accumulators, and the deep dk/dv and dq (output
   columns in groups over blocks, S and dP summed over the depth's
   slabs); D384 and D512: the Hopper forward with O's columns split over
   blocks; bf16 B1 H2 T512 D576, D640, D1024 and D1280: the deep Hopper
   forward, S summed over the depth's slabs, Q resident up to 1024 and
   streamed at 1280, and the deep dk/dv and dq; fp32
   D256 (B2 H4 T512 causal) and D320 (B1 H4 T1024 causal): the Hopper
   tf32 forward, dk/dv and dq, K and V of a dk/dv block resident at 256
   and streamed at 320, Q and dO of a dq block likewise); and times them
   beside ``scaled_dot_product_attention``'s forward and backward (a
   yardstick only, never on the path), the forward with its achieved
   TFLOP/s and its share of the bound. Every fp32 shape's kernels must
   take the Hopper tf32 route, and every 16-bit shape's above head dim
   256 the Hopper one, dk/dv and dq on the deep kernels, by their
   counters and by the kernel names of a profiler trace (check_route: no
   mma.sync kernel);
5. trains the flagship decoder LM (d2048 x 4 layers, T 2048, batch 4,
   bf16, ``attention="flash"``) through ``broadcast_parameters`` and
   ``DistributedOptimizer(AdamW)`` (losses finite and falling, tokens/s);
6. runs ``hvd.grouped_allreduce`` on the LM's gradients through the pack
   kernel (the 268 MB embedding gradient is a bucket of its own);
7. trains ViT-B/16 at batch 32, 224 px, three SGD-momentum steps;
8. holds the three K7 ring-segment kernels against their plain versions
   computed in fp32 from the same bf16 inputs, at the zig-zag ring's FULL
   and DIAG half-segments of B1 H16 T8192 D128 (strided lse/di halves),
   the contiguous n=1 ring's whole segment, a T = 2000, D 64 tail-tile
   shape, a D 256 FULL half-segment (B1 H8 T4096: the Hopper wide
   kernels), D 320, 384 and 512 ones (B1 H4 T2048: the Hopper forward, the
   deep dk/dv and dq) and D 576, 640, 1024 and 1280 ones (B1 H2 T1024,
   and D 1024 at B1 H8 T4096, a grid that fills the card: the deep Hopper
   forward, dk/dv and dq), each above 256 checked by route as phase 4's,
   and the FULL half in fp32 (the Hopper tf32 K7a, K7b and K7c, checked
   as phase 4's fp32 shapes),
   and times them
   beside SDPA's forward and backward (a yardstick only: with the
   segment's own lse, SDPA's backward of the same segment, causal or
   full, computes the same dq, dk and dv), the forward with its
   achieved TFLOP/s and its share of the bound;
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
    ``DistributedOptimizer(op=Adasum)``;
12. trains ViT_Tiny (head dim 16) in fp32 at batch 32, 64 px, three
    SGD-momentum steps, through the Hopper tf32 forward, dk/dv and dq,
    which read the head dim in place (no zero-padded copy), its first
    logits against the same model's on the CPU, and traces one more
    forward and backward: only the Hopper tf32 kernels may run;
13. runs attention above head dim 128 through the entry points a user
    calls, ``flash_attention_local`` (bf16 B1 T4096 H8 D256, fp16 B2 T1024
    H8 D160, bf16 B1 T1024 H4 D320 and D384, B1 T512 H2 D576, fp32 B1
    T1024 H4 D320: the Hopper tf32 forward, dk/dv and dq; causal) and
    the zig-zag ring (``force_ring=True``, bf16 D256, D320, D384 and
    D576), forward and backward, against the plain versions, checks which
    route each kernel took (the Hopper kernels; fp32 the Hopper tf32
    ones), by its launch counter and by the names of the kernels a
    profiler trace saw (at D 384 the forward must be
    ``flash_fwd_sm90_kernel<384, ...>``, at D 576
    ``flash_fwd_sm90_kernel_deep<...>``, above 256 dk/dv and dq
    ``flash_bwd_*_sm90_kernel_deep<...>``, and no path may run an mma.sync
    kernel), prints the kernels a trace sees
    per K6 wrapper call at fp16 D160 (one: no zero-pad copy; every path's
    ``*_pad_copies`` on a Hopper route must be 0), and times each path's
    forward + backward with the share of its attention kernels' device
    time that is dq's: the wide kernels' path;
14. runs ``SyncBatchNorm`` (world size 1, so its all_reduce is skipped)
    over ResNet-50's 53 BN layers at batch 64 in bf16 channels_last,
    forward and backward, against ``FusedBatchNorm`` on the same inputs
    and against the module's plain path on the CPU at each distinct shape
    (y and dx within one unit in bf16's last place of the largest entry,
    the sums and running statistics within ``BN_ULPS`` fp32 units; the
    CPU's sums within 1e-5 of sum |terms|), checks that issuing the step
    waits on no device value, and times the stack's forward + backward
    beside ``FusedBatchNorm``'s, with a profile of both (device time,
    launches a layer);
15. reduces ResNet-50's 161 gradients (batch 64, bf16 compute, fp32
    parameters) inside ``hvd.step()`` with ``grouped_allreduce_async``
    (Average, postscale 0.5) between each backward and SGD step: the
    warm-up steps record, the stream arms once, and every later step
    replays as one CUDA graph holding K1 once a bucket, the NCCL allreduce
    and the finish, its results bitwise the eager path's on the same
    gradients, a held result unchanged by the next replay, a divergent
    step (one gradient left out) falling back with correct values, no host
    wait under ``torch.cuda.set_sync_debug_mode("error")``; a trace of one
    eager and one replayed reduction (exactly one ``cudaGraphLaunch`` and no
    ``cudaLaunchKernel``, K1 in the graph, the graph's NCCL operations the
    eager path's), and the host ms of the reduction, the device ms, the
    runtime calls, img/s with replay on and off in turns, peak memory;
16. trains the flagship LM (AdamW) through
    ``DistributedOptimizer(sharded=True)`` (ZeRO-1) at world size 1 and,
    from the same seed, through the dense ``DistributedOptimizer``: the
    warm-up's eager steps, then replayed steps whose packs (K1 into the
    padded buckets), reduce-scatters and finishes are one CUDA graph, the
    AdamW update and the all-gathers after it; the parameters bitwise the
    dense run's (else within 1e-6 of the largest entry), the losses finite
    and falling, K1's launches in padded mode and as graph nodes, a
    replayed step with no host wait, the host ms of the optimizer step
    eager against replayed, the graph's device ms, a step's runtime calls
    each way, the optimizer-state bytes and the peak memory of both runs;
17. reduces the flagship LM's 268.5 M fp32 gradients (seeded, in phase
    16's 17 buckets) with the wire codecs' flat compressed reduction
    (``ops/collectives.py`` ``codec_allreduce``: K1 into a zero-tailed
    padded buffer, the error-feedback encode, the all-to-all, the scales'
    all-gather, the decode-sum, the all-gather) on the NCCL world of one,
    for int8, fp8 and bf16: 3 eager steps whose payloads, scales,
    residuals and results of the first and last bucket are bitwise the
    plain path's on the CPU from the same inputs, then the whole reduction
    captured as one CUDA graph and replayed 4 times with the residuals
    carried in place, each replay bitwise the eager path on the same
    inputs and residuals; a capture with a host sync in it must raise. It
    prints each codec's device ms of the encode and the decode-sum for
    the whole LM and a 64 MB bucket beside their bytes bound, the device
    operations a bucket's reduction launches, the host ms of the
    reduction eager against replayed, and the peak memory.
18. The collective algorithms on the NCCL world of one: ResNet-50's 161
    gradients through the engine's grouped allreduce under each of
    HOROVOD_TPU_COLLECTIVE_ALGO=auto, flat, tree and hierarchical (every
    bucket resolves to flat, a forced form warns once, results, K1
    launches and collectives bitwise and count for count the unforced
    run's); then the flagship LM's fp32 gradients in 64 MB buckets
    through the tree's pair rounds and the ladder's four legs of
    ``ops/collectives.py`` directly, the world group as the local group
    and a second group of rank 0 as the cross group (two communicators),
    and a (4096, 2048) bf16 block through the two-phase alltoall: each
    eagerly 3 times (bitwise the flat reduction and the flat alltoall),
    then captured as one CUDA graph and replayed 4 times (bitwise the
    eager path); a capture on a communicator never initialised must
    raise. It prints each form's device ms for the LM (eager and
    replayed) beside the flat reduction's, the launches of one bucket's
    reduction (K1 and the NCCL legs) and the peak memory.
19. Observability: ResNet-50's 161 gradients (seeded) reduced inside
    ``hvd.step()`` (eager for the warm-up, then replayed as the CUDA
    graph) in a world re-initialised with every instrument on (the
    defaults: metrics, trace, stall inspector, step health, the memory
    sampler; plus ``HOROVOD_TIMELINE`` and ``HOROVOD_TPU_METRICS_FILE``)
    under ``torch.cuda.set_sync_debug_mode("warn")``, counting the
    synchronizations. Its outputs: the native timeline writer loaded, its
    file JSON with a span and a launch span for each tensor of each eager
    step and one of each a replayed step under the reference's phase
    names, ``metrics_snapshot()``'s grouped-allreduce wire bytes equal to
    the gradient bytes times the steps, ``hvd_tpu_hbm_bytes`` equal to
    ``torch.cuda.memory_stats()`` read at the same sample, a flight dump
    that ``load_trace_file`` reads, a final metrics record. Then the
    overhead: ``OBS_ROUNDS`` rounds of fresh processes (``--obs-arm``; the
    knobs are read at init, the metrics switch once a process), each
    round one process per arm in rotating order (the defaults, everything
    off, everything on: the timeline, the metrics file and
    ``HOROVOD_TPU_DEBUG_CONSISTENCY=1``, which keeps replay unarmed), each
    measuring the LM's tokens/s, ResNet-50's img/s, the host ms of phase
    15's reduction eager and replayed, and the synchronizations of the
    same counted steps; every instrumented run, the in-process one
    included, may synchronize no more times than the bare ones. It prints
    each arm's medians and ranges.
20. The tensor axis's paths at world size 1, on the flagship LM's widths
    with the MoE FFN (8 experts, capacity factor 2; bench.py's
    bench_moe_ep): ``make_moe_ep_train_step`` eager and then with replay
    armed (the replayed losses bitwise the eager ones, one CUDA graph an
    exchange: 4·L a replayed step, the host synchronizations of a
    replayed step, the routing skew, tokens/s and peak memory),
    ``make_train_step`` on the (1, 1, 1) mesh with the MoE FFN, and the
    dense flagship through ``make_train_step`` against
    ``DistributedOptimizer`` on the same weights (the parameters bitwise),
    then ``moe_ep_vs_dense``: the dense step's time over the MoE-EP
    step's at matched active parameters. Every K6 kernel once a layer and
    step in each part.
21. The pipelined flagship at pipe 1 (world size 1: every hop a copy; 1F1B
    and zb refuse one stage, as the reference does), the flagship LM's
    widths, batch 4 in 4 microbatches of 1 x 2048, AdamW:
    ``make_pp_train_step`` interleaved with 2 and 4 chunks from the same
    weights (the losses and parameters bitwise each other, the first loss
    within 1e-3 of ``make_train_step``'s), ``make_pp_engine_train_step``
    through ``DistributedOptimizer(sharded=True)`` eager and then replayed
    (the losses bitwise, one dispatch a replayed step), the host
    synchronizations of a step of each (none: the loss is read after it),
    step ms, tokens/s against phase 5's, peak memory and K6's launches a
    step (the stage's recompute: the forward 1 + (v-1)/v times a layer
    and microbatch, each backward kernel once).

22. Durable checkpointing of the flagship LM (``run_checkpoint_path``).
23. Elastic training of the flagship LM (``run_elastic_path``): an
    injected failure and a host update under ``@hvd.elastic.run``, each
    reset a new NCCL world in this process, the losses after each reset
    bitwise the uninterrupted run's; then a worker killed by
    ``os._exit(137)`` under ``python -m horovod_tpu_torch.runner
    --elastic``, relaunched by the driver and restored from the durable
    tier (``--elastic-worker`` runs one life of it), its losses bitwise.
24. The survivable control plane on the flagship LM
    (``run_control_plane_path``).
25. The estimator layer on the flagship LM (``run_estimator_path``):
    ``Estimator.fit`` on a ``ShardedNpzDataset``, uninterrupted and then
    stopped and resumed through a ``LocalStore`` (the resumed epoch's
    losses and the final parameters bitwise), ``predict``, and a hand loop
    under the training callbacks.

Phases 2 and 5 end with a ``torch.profiler`` trace of ``--profile`` steps
(3 by default): device time by layer, the busy share and the kernel
launches per step. ``--resnet-only`` runs phase 2 alone and prints its
img/s, busy share and launches per step as the last line;
``--package-root DIR`` imports the package from DIR, so one call can
measure a parent checkout the same way.

Launch counts are zeroed just before each path (phases 2-3, 5, 6, 7, 9,
each form of 11, 12, 13, 14, 15, 16, 17 and 18, each part of 20 and 21)
and read
just after it;
every kernel of the path must have launched there (53 BN layers per ResNet step for each
BN kernel, and one K2 and one K3 in raw mode a layer of phase 14's step,
K1 in padded mode once a bucket for the move and each eager step of phase
16 and as a graph node once a bucket each replayed step, K1 in padded
mode once a bucket each eager step of phase 17 and as a graph node once a
bucket each replay, the same in phase 18 for each of its three forms,
one pack per 64 MB bucket, one of each K6 kernel per attention layer and
step, 3 of each K7 kernel per zig-zag ring call and 1 per contiguous one,
one K4 and one K5 per pair, level and tensor: 136 each for the flat form,
68 for the hierarchical one, whose 2 shards a pair halve the work; one of
each fp32 kernel, the Hopper tf32 forward, dk/dv and dq, per layer and
step of ViT_Tiny; each wide instance, the deep dk/dv and dq included, at
least once in phase 13, the Hopper tf32 dk/dv and dq at fp32 D 320 too,
and no mma.sync kernel in any trace). Any failed check exits
non-zero with no result. The line before the last is
``nvidia-smi``'s name and power limit, the one before it the ``kernels``
JSON, and the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 and fp16 tensor cores, dense
TF32_FLOPS = 495e12            # H100 SXM tf32 tensor cores, dense
# fp32 inputs run on tf32 tensor cores (10 mantissa bits, unit roundoff
# 2^-11): a kernel's error limit is twice the plain version's in tf32
# (plain_matmuls), plus this share of the largest entry (half tf32's
# roundoff, as bf16's 1e-3 is about half of 2^-9)
TF32_FLOOR = 2.0 ** -12
# phase 12: ViT_Tiny's logits on the card (tf32 attention) against the CPU's
TINY_REL_TOL = 1e-2
BN_REL_TOL = 1e-5              # of sum |terms|: fp32 sums in another order
# K2/K3's epilogues against the module's math on the kernel's own sums: the
# same fp32 operations, rsqrt approximated in both, in units of fp32's
# epsilon times each output row's largest entry
BN_ULPS = 8
BN_EPS32 = 2.0 ** -23

# K6 at the main path's attention calls and at what else the reference
# computes: (what, B, H, Tq, Tk, D, causal, dtype)
FLASH_SHAPES = (("flagship LM", 4, 16, 2048, 2048, 128, True, "bfloat16"),
                ("ViT-B/16", 32, 12, 197, 197, 64, False, "bfloat16"),
                ("tail tile", 4, 8, 1000, 1000, 64, True, "bfloat16"),
                ("flagship LM fp16", 4, 16, 2048, 2048, 128, True,
                 "float16"),
                ("fp32", 2, 8, 1024, 1024, 64, True, "float32"),
                ("ViT_Tiny fp32", 32, 4, 65, 65, 16, False, "float32"),
                ("ViT_Tiny D16 bf16", 32, 4, 65, 65, 16, False, "bfloat16"),
                ("D80", 4, 16, 1024, 1024, 80, True, "bfloat16"),
                ("D96", 4, 16, 1024, 1024, 96, True, "bfloat16"),
                ("Tq<Tk causal", 4, 16, 1024, 2048, 128, True, "bfloat16"),
                ("Tq>Tk full", 4, 16, 2048, 1024, 128, False, "bfloat16"),
                ("D256", 2, 8, 2048, 2048, 256, True, "bfloat16"),
                ("D160 fp16 Tq<Tk", 2, 8, 1024, 2048, 160, True, "float16"),
                ("D256 fp32", 2, 4, 512, 512, 256, True, "float32"),
                ("D320 fp32", 1, 4, 1024, 1024, 320, True, "float32"),
                ("D320", 1, 4, 1024, 1024, 320, True, "bfloat16"),
                ("D384", 1, 4, 1024, 1024, 384, True, "bfloat16"),
                ("D512", 1, 4, 1024, 1024, 512, True, "bfloat16"),
                ("D576", 1, 2, 512, 512, 576, True, "bfloat16"),
                ("D640", 1, 2, 512, 512, 640, True, "bfloat16"),
                ("D1024", 1, 2, 512, 512, 1024, True, "bfloat16"),
                ("D1280", 1, 2, 512, 512, 1280, True, "bfloat16"))
# the shape whose numbers the fp32 rows carry: phase 12's path
TF32_SHAPE = "ViT_Tiny fp32"
# the fp32 rows of the kernels line: (row, the K6 wrapper and the phase-4
# shape whose numbers it carries, the phase whose counts are its
# launches). The Hopper tf32 forward, dk/dv and dq (K6 and K7 alike) at
# phase 12's shape, every fp32-input shape of phases 4 and 8 under
# "shapes", and dk/dv and dq again at D 320 (rows <name>_d320), a head dim
# at which fp32 dk/dv and dq split their output columns over blocks.
TF32_D320 = "D320 fp32"
TF32_ROWS = (("flash_fwd_sm90_tf32", "flash_fwd", TF32_SHAPE, 12),
             ("flash_bwd_dkdv_sm90_tf32", "flash_bwd_dkdv", TF32_SHAPE, 12),
             ("flash_bwd_dq_sm90_tf32", "flash_bwd_dq", TF32_SHAPE, 12),
             ("flash_bwd_dkdv_sm90_tf32_d320", "flash_bwd_dkdv", TF32_D320,
              13),
             ("flash_bwd_dq_sm90_tf32_d320", "flash_bwd_dq", TF32_D320, 13))
# the K6 wrappers whose launches must take the Hopper tf32 route on fp32
# inputs, and the Hopper one (dk/dv and dq deep) on bf16 and fp16 above
# head dim 256 (di has no route)
K6_ROUTED = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
# the rows of the instances above head dim 128, K6 and K7, of the forwards
# (fwd) and of dk/dv and dq (bwd), and the phase-4 and phase-8 shapes whose
# numbers each carries: the Hopper kernels at D 192 and 256
# (<name>_sm90_wide) at D 256, the forward at D 320 (<name>_sm90_d320) at
# D 320, the forward with O's columns split over blocks at 384 to 512
# (<name>_sm90_split) at D 384, the deep forward above 512, S summed over
# the depth's slabs (<name>_sm90_deep), at D 576, and the deep dk/dv and
# dq above 256, their output columns in groups over blocks and S and dP
# summed over the depth's slabs (<name>_sm90_deep), at D 320; the deep
# rows list their other head dims' shapes under "shapes"
WIDE_ROWS = {"fwd": {"sm90_wide": ("D256", "D256 half, FULL"),
                     "sm90_d320": ("D320", "D320 half, FULL"),
                     "sm90_split": ("D384", "D384 half, FULL"),
                     "sm90_deep": ("D576", "D576 half, FULL")},
             "bwd": {"sm90_wide": ("D256", "D256 half, FULL"),
                     "sm90_deep": ("D320", "D320 half, FULL")}}
# the head dim above which each kind's deep kernels run
DEEP_ABOVE = {"fwd": 512, "bwd": 256}
# phase 13: attention above head dim 128 through the user entry points:
# (what, path, B, T, H, D, dtype), q, k, v [B, T, H, D], causal
WIDE_PATHS = (("flash_attention_local", "flash", 1, 4096, 8, 256, "bfloat16"),
              ("zig-zag ring", "zigzag", 1, 4096, 8, 256, "bfloat16"),
              ("flash_attention_local", "flash", 2, 1024, 8, 160, "float16"),
              ("flash_attention_local", "flash", 1, 1024, 4, 320, "bfloat16"),
              ("zig-zag ring", "zigzag", 1, 2048, 4, 320, "bfloat16"),
              ("flash_attention_local", "flash", 1, 1024, 4, 384, "bfloat16"),
              ("zig-zag ring", "zigzag", 1, 2048, 4, 384, "bfloat16"),
              ("flash_attention_local", "flash", 1, 512, 2, 576, "bfloat16"),
              ("zig-zag ring", "zigzag", 1, 1024, 2, 576, "bfloat16"),
              ("flash_attention_local", "flash", 1, 1024, 4, 320, "float32"))
WIDE_WINDOWS = 5               # timed windows of each wide path
WIDE_WINDOW_CALLS = 2          # forward + backward calls in each window
WIDE_TRACED_CALLS = 2          # forward + backward calls in the trace
WIDE_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                "flash_seg_fwd", "flash_seg_bwd_dkdv", "flash_seg_bwd_dq")
# the CUDA kernel each wrapper's route launches: the Hopper kernel
# (sm90_wide) or the Hopper tf32 one (sm90_tf32), K7's the same as K6's
ROUTE_KERNELS = {"flash_fwd": "flash_fwd", "flash_seg_fwd": "flash_fwd",
                 "flash_bwd_dkdv": "flash_bwd_dkdv",
                 "flash_seg_bwd_dkdv": "flash_bwd_dkdv",
                 "flash_bwd_dq": "flash_bwd_dq",
                 "flash_seg_bwd_dq": "flash_bwd_dq"}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_pre", "flash_bwd_dkdv",
                 "flash_bwd_dq")
# the flagship LM (bench.py's bench_transformer configuration)
LM_DIMS = dict(vocab_size=32768, d_model=2048, n_heads=16, n_layers=4,
               d_ff=8192, max_seq=2048)
LM_WINDOW_STEPS = 5            # steps in each timed window of the LM
VIT_LAYERS = 12
# K7 at the ring path's segments: (what, B, H, T, D, part, dtype) with q,
# k, v [B, T, H, D]; "full" is q's zig-zag hi half against the lo half of
# k/v (S = T/2, every key visible), "diag" the lo halves (the causal
# diagonal), "whole" the contiguous n=1 ring's one segment (S = T). lse and
# di are the causal attention's over all T, their halves strided as the
# ring has them.
SEG_SHAPES = (("zigzag half, FULL", 1, 16, 8192, 128, "full", "bfloat16"),
              ("zigzag half, DIAG", 1, 16, 8192, 128, "diag", "bfloat16"),
              ("contiguous n=1, DIAG", 1, 16, 8192, 128, "whole",
               "bfloat16"),
              ("tail tile, FULL", 4, 8, 2000, 64, "full", "bfloat16"),
              ("tail tile, DIAG", 4, 8, 2000, 64, "diag", "bfloat16"),
              ("D256 half, FULL", 1, 8, 4096, 256, "full", "bfloat16"),
              ("D320 half, FULL", 1, 4, 2048, 320, "full", "bfloat16"),
              ("D384 half, FULL", 1, 4, 2048, 384, "full", "bfloat16"),
              ("D512 half, FULL", 1, 4, 2048, 512, "full", "bfloat16"),
              ("D576 half, FULL", 1, 2, 1024, 576, "full", "bfloat16"),
              ("D640 half, FULL", 1, 2, 1024, 640, "full", "bfloat16"),
              ("D1024 half, FULL", 1, 2, 1024, 1024, "full", "bfloat16"),
              ("D1280 half, FULL", 1, 2, 1024, 1280, "full", "bfloat16"),
              # the deep forward on a grid that fills the card
              ("D1024 half, FULL, H8 T4096", 1, 8, 4096, 1024, "full",
               "bfloat16"),
              # the ring's FULL half in fp32: the Hopper tf32 K7a and K7c
              ("zigzag half, FULL, fp32", 1, 16, 8192, 128, "full",
               "float32"))
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
# phase 12: ViT_Tiny in fp32 (head dim 16), batch, image size, steps
TINY_BATCH, TINY_IMAGE, TINY_STEPS = 32, 64, 3
# phase 15: step replay of ResNet-50's gradient reduction
REPLAY_CHECKED = 3             # replayed steps held bitwise to the eager path
REPLAY_TIMED = 20              # reductions timed by the host clock each way
REPLAY_WINDOW_STEPS = 10       # training steps in each timed window
REPLAY_MODES = (True, False, False, True, True, False)   # replay on/off
REPLAY_TRACE_TIMEOUT = 180     # the fresh process tracing a replay, seconds
# phase 16: ZeRO-1 (the flagship LM) at world size 1
SHARDED_REPLAYED = 4           # replayed steps after the warm-up
SHARDED_TIMED = 20             # optimizer steps timed each way
# phase 17: the wire codecs' flat reduction of the LM's gradients, size 1
CODEC_CODECS = ("int8", "fp8", "bf16")
CODEC_EAGER = 3                # eager steps, checked against the CPU
CODEC_REPLAYED = 4             # replays of the captured reduction
CODEC_TIMED = 10               # reductions timed by the host clock each way
CODEC_REPS = 10                # timed encodes and decode-sums
# bytes an element of the encode (read g and r; write the payload and r)
# and of the decode-sum at size 1 (read the payload, write the sum)
CODEC_ENCODE_BYTES = {"int8": 4 + 4 + 1 + 4, "fp8": 4 + 4 + 1 + 4,
                      "bf16": 4 + 2}
CODEC_DECODE_BYTES = {"int8": 1 + 4, "fp8": 1 + 4, "bf16": 2 + 4}
# phase 18: the collective algorithms at world size 1
ALGO_FORMS = ("auto", "flat", "tree", "hierarchical")   # the knob's values
ALGO_EAGER = 3                 # eager reductions of each form
ALGO_REPLAYED = 4              # replays of each captured form
ALGO_REPS = 10                 # timed reductions of each form
ALGO_A2A_SHAPE = (4096, 2048)  # the alltoall's bf16 block
# phase 19: observability
OBS_EAGER = 3                  # eager steps of the reduction (the warm-up)
OBS_REPLAYED = 4               # replayed steps after them
OBS_ROUNDS = 2                 # rounds of overhead processes, one an arm
OBS_LM_WINDOWS = 2             # timed windows of the LM in each process
OBS_RESNET_WINDOWS = 2         # and of ResNet-50
OBS_HOST_TIMED = 20            # reductions timed by the host clock each way
# the instruments off: the issue's list of switches
OBS_OFF = {"HOROVOD_TPU_METRICS": "0", "HOROVOD_TPU_TRACE": "0",
           "HOROVOD_TPU_STEP_HEALTH": "0", "HOROVOD_TPU_HBM": "0",
           "HOROVOD_STALL_CHECK_DISABLE": "1"}
# every knob an arm may set, cleared before each arm sets its own
OBS_KNOBS = tuple(OBS_OFF) + ("HOROVOD_TIMELINE", "HOROVOD_TPU_METRICS_FILE",
                              "HOROVOD_TPU_METRICS_INTERVAL",
                              "HOROVOD_TPU_TRACE_DUMP_DIR",
                              "HOROVOD_TPU_DEBUG_CONSISTENCY")
OBS_ARMS = ("defaults", "off", "all")
# phase 20: the tensor axis's paths at world size 1 on the flagship LM's
# widths, the MoE FFN with bench.py:bench_moe_ep's experts and factor
MOE_EXPERTS, MOE_FACTOR, MOE_BATCH = 8, 2.0, 4
MOE_STEPS = 5                  # MoE-EP steps each way (eager, replay armed)
MOE_WARM = 2                   # of them the replay's warm-up
MOE_TP_STEPS = 3               # make_train_step steps of (b) and (c)
MOE_DENSE_TIMED = 4            # dense lean-loss steps timed for the ratio
# phase 21: the pipelined flagship at pipe 1
PP_MICRO = 4                   # microbatches a step (1 x 2048 tokens each)
PP_VIRTUAL = (2, 4)            # interleaved chunks of the one stage
PP_CHECKED = 3                 # steps of each, held bitwise each other
PP_TIMED = 5                   # v=2 steps timed after them
PP_ENGINE = 5                  # engine steps each way (eager, replayed)
PP_PROFILED = 3                # v=2 steps traced for the busy share
# phase 22: durable checkpointing of the flagship LM at world size 1
CKPT_INTERVAL = 5              # HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS
CKPT_WINDOW = 5                # steps in each window of an arm
CKPT_STEPS = 15                # steps of each arm: a warm-up window, then 2
CKPT_RESUMED = 3               # steps after the restored one, run both ways
CKPT_ZERO1_STEPS = 2           # ZeRO-1 steps before its payload
CKPT_SLEEP_CYCLES = 200_000_000  # the card spinning ahead of snapshot()
# phase 23: elastic training of the flagship LM at world size 1
ELASTIC_STEPS = 15             # steps of each run
ELASTIC_COMMIT = 5             # state.commit() every this many steps
ELASTIC_FAIL_AT = 8            # (a): HorovodInternalError after this step
ELASTIC_NOTIFY_AT = 9          # (a): the host update, after the recovery
ELASTIC_KILL_AFTER = 10        # (b): the worker dies after this commit
ELASTIC_CHILD_TIMEOUT = 300    # (b): the launcher's job, seconds at most
# phase 24: the survivable control plane on the flagship LM
CP_INTERVAL = 0.2              # (a) arm 3's and (b)'s publisher intervals
CP_STEPS = 15                  # (b): the worker's steps
CP_COMMIT = 5                  # (b): state.commit() every this many steps
CP_KILL_AFTER = 5              # (b): the primary dies after this step
CP_CHILD_TIMEOUT = 300         # (b): the worker's seconds at most
CP_PROMOTE_TIMEOUT = 60        # (b): the kill to both promotions, at most
# phase 25: the estimator on the flagship LM at world size 1
EST_TRAIN_SEQS = 40            # training sequences of T + 1 tokens
EST_SHARDS = 5                 # the ShardedNpzDataset's shard files
EST_VAL_SEQS = 4               # validation sequences
EST_EPOCHS = 2                 # run A's epochs (run B: 1, then resumed)
EST_CB_STEPS = 5               # the callbacks' hand loop: steps an epoch
EST_CB_SIZE = 4                # the warm-up's world size (its ramp from 1/4)
# the runtime and driver calls that launch one kernel
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx")


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


def attention_ptxas(build, log):
    """Registers and spill bytes of the attention kernels from the build's
    ptxas report, by row of the ``kernels`` line: {row name: {"registers":
    the most of any instantiation, "spill_bytes": their sum}}. The Hopper
    kernels with In outputs are K6's rows, with fp32 outputs K7's, those at
    head dims 192 and 256 ``<row>_sm90_wide``, the forward's at 320
    ``<row>_sm90_d320``, at 384 to 512 ``<row>_sm90_split`` and its deep
    kernel (every head dim above 512) and the deep dk/dv and dq (every
    head dim above 256) ``<row>_sm90_deep``; the Hopper tf32 kernels' rows
    (fp32 inputs, K6 and K7 alike) are ``<name>_sm90_tf32``. flash_attn.cu
    builds di alone."""
    rows = {}
    names = {  # kernel -> (K6 row, K7 row)
        "flash_fwd_sm90_kernel": ("flash_fwd", "flash_seg_fwd"),
        "flash_fwd_sm90_kernel_deep": ("flash_fwd", "flash_seg_fwd"),
        "flash_bwd_dkdv_sm90_kernel": ("flash_bwd_dkdv",
                                       "flash_seg_bwd_dkdv"),
        "flash_bwd_dkdv_sm90_kernel_deep": ("flash_bwd_dkdv",
                                            "flash_seg_bwd_dkdv"),
        "flash_bwd_dq_sm90_kernel": ("flash_bwd_dq", "flash_seg_bwd_dq"),
        "flash_bwd_dq_sm90_kernel_deep": ("flash_bwd_dq",
                                          "flash_seg_bwd_dq"),
        "flash_bwd_pre_kernel": ("flash_bwd_pre", "flash_bwd_pre"),
        "flash_fwd_sm90_tf32_kernel": ("flash_fwd", "flash_seg_fwd"),
        "flash_bwd_dq_sm90_tf32_kernel": ("flash_bwd_dq",
                                          "flash_seg_bwd_dq"),
        "flash_bwd_dkdv_sm90_tf32_kernel": ("flash_bwd_dkdv",
                                            "flash_seg_bwd_dkdv"),
    }
    for stem in ("flash_fwd_sm90", "flash_bwd_sm90", "flash_attn"):
        for mangled, r in sorted(build.ptxas_report(stem).items()):
            # the kernel's name follows its length (the file's does not);
            # then the head dim or group width, then In and OutT (the tf32
            # kernels have neither: fp32 in and out)
            m = re.search(
                r"(?<=\d)(flash_\w+?_kernel(?:_deep)?)I(?:Li(\d+)E)?(\w*?)"
                r"EEv", mangled)
            check(m is not None and m.group(1) in names and len(r) == 3,
                  f"unexpected ptxas entry {mangled}: {r}")
            kernel, d, types = m.groups()
            # "S1_" repeats In (K6), a final "f" is fp32 (K7)
            k7 = types.endswith("f") and not types.startswith("f")
            row = names[kernel][int(k7)]
            if kernel.endswith("_tf32_kernel"):
                row = f"{names[kernel][0]}_sm90_tf32"
            elif kernel.endswith("_deep"):
                row += "_sm90_deep"
            elif d and int(d) > 128:
                row += ("_sm90_wide" if int(d) <= 256 else
                        "_sm90_d320" if int(d) == 320 else "_sm90_split")
            spill = r["spill_stores"] + r["spill_loads"]
            entry = rows.setdefault(row, {"registers": 0, "spill_bytes": 0})
            entry["registers"] = max(entry["registers"], r["registers"])
            entry["spill_bytes"] += spill
            width = ("kOut " if kernel.endswith(("_deep", "_tf32_kernel"))
                     else "D") + (d or "")
            log(f"  {kernel} {width + ' ' if d else ''}{types}: "
                f"{r['registers']} registers, {spill} bytes spilled")
    return rows


def bn_ptxas(build, log):
    """Registers and spill bytes of K2/K3's instantiations (input type,
    forward or backward, TMA or plain loads) from the build's report:
    {"registers": the most, "spill_bytes": their sum}."""
    entry = {"registers": 0, "spill_bytes": 0}
    for mangled, r in sorted(build.ptxas_report("bn_stats").items()):
        check("bn_stats_kernel" in mangled and len(r) == 3,
              f"unexpected ptxas entry {mangled}: {r}")
        spill = r["spill_stores"] + r["spill_loads"]
        entry["registers"] = max(entry["registers"], r["registers"])
        entry["spill_bytes"] += spill
        log(f"  {mangled}: {r['registers']} registers, {spill} bytes "
            "spilled")
    return entry


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


def _bn_fwd_epilogue(torch, s, q, m, scale, bias, eps):
    """The module's forward math (bn_forward_plain) from given sums."""
    mean = s / m
    var = torch.clamp(q / m - mean * mean, min=0.0)
    invstd = torch.rsqrt(var + eps)
    a = scale * invstd
    return torch.stack([mean, var, invstd, a, bias - mean * a])


def _bn_bwd_epilogue(torch, s1, s2, m, invstd, scale):
    """The module's backward math (bn_backward_plain) from given sums."""
    a = scale * invstd
    return torch.stack([s2, s1, a, -a * (s1 / m), -a * invstd * (s2 / m)])


def _bn_ulps(torch, got, want):
    """The largest difference in fp32 units of each row's largest entry."""
    unit = BN_EPS32 * want.abs().amax(-1, keepdim=True) + 1e-30
    return float(((got - want).abs() / unit).max())


def check_bn_kernels(torch, K, dev, shapes, flush, reps, log):
    """K2/K3 against their plain versions at every distinct shape, in both
    modes: the raw sums within BN_REL_TOL of sum |terms|, the epilogues
    (the module's per-channel math, the EMA in place) within BN_ULPS fp32
    units of that math on the kernel's own sums, two runs bitwise equal.
    Times the epilogue mode (what the main path launches) and the raw mode
    beside the plain versions, the library calls and the bound; returns the
    two kernel rows (times summed over the 53 layers of a step)."""
    counts = {}
    for shape in shapes:
        counts[shape] = counts.get(shape, 0) + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name in ("bn_stats", "bn_bwd_stats"):
        rows[name] = {"ms": 0.0, "host_ms": 0.0, "raw_ms": 0.0,
                      "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                      "max_abs_err": 0.0, "max_rel_err": 0.0,
                      "max_epilogue_ulps": 0.0, "slower_than_library": []}
    eps, mom = 1e-5, 0.9
    for (m, c), n in counts.items():
        x = torch.randn(m, c, device=dev, generator=gen).to(torch.bfloat16)
        dy = torch.randn(m, c, device=dev, generator=gen).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        bias = 0.1 * torch.randn(c, device=dev, generator=gen)
        run_mean = torch.zeros(c, device=dev)
        run_var = torch.ones(c, device=dev)
        s_ref, q_ref = K.bn_stats_plain(x)
        mean = s_ref / m
        invstd = torch.rsqrt(torch.clamp(q_ref / m - mean * mean, min=0)
                             + eps)
        xf, dyf = x.float(), dy.float()
        xh = (xf - mean) * invstd
        # the library yardsticks compute neighbours of K2/K3: mean and
        # invstd instead of the sums; sum dy and sum dy*(x - mean) without
        # K3's invstd factor. They must agree with K2/K3's plain versions.
        lib_mean, lib_invstd = torch.batch_norm_stats(x, eps)
        lib_dy, lib_dyxmu, _, _ = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, None, True, False, False)
        s1_ref, s2_ref = K.bn_bwd_stats_plain(dy, x, mean, invstd)
        for what, got, want, mag in (
                ("mean", lib_mean * m, s_ref, xf.abs().sum(0)),
                ("invstd", lib_invstd, invstd, invstd.abs()),
                ("sum dy", lib_dy, s1_ref, dyf.abs().sum(0)),
                ("sum dy (x - mean) invstd", lib_dyxmu * invstd, s2_ref,
                 (dyf * xh).abs().sum(0))):
            check(bool(((got.float() - want).abs() <= 1e-3 * mag + 1e-6)
                       .all()),
                  f"library yardstick {what} {(m, c)} disagrees with the "
                  "plain version")
        del lib_mean, lib_invstd, lib_dy, lib_dyxmu
        # raw sums against the plain versions, the epilogues against the
        # module's math on the kernel's own sums
        raw = {"bn_stats": K.bn_stats(x),
               "bn_bwd_stats": K.bn_bwd_stats(dy, x, mean, invstd)}
        fwd = K.bn_forward(x, scale, bias, eps)
        bwd = K.bn_backward(dy, x, mean, invstd, scale)
        epi_ulps = {
            "bn_stats": _bn_ulps(torch, fwd, _bn_fwd_epilogue(
                torch, *raw["bn_stats"], m, scale, bias, eps)),
            "bn_bwd_stats": _bn_ulps(torch, bwd, _bn_bwd_epilogue(
                torch, *raw["bn_bwd_stats"], m, invstd, scale))}
        torch.cuda.synchronize()
        check(torch.equal(fwd, K.bn_forward(x, scale, bias, eps))
              and torch.equal(bwd, K.bn_backward(dy, x, mean, invstd, scale)),
              f"BN epilogues {(m, c)}: two runs differ")
        cases = {
            "bn_stats": (lambda: K.bn_forward(x, scale, bias, eps, run_mean,
                                              run_var, mom),
                         lambda: K.bn_stats(x), (s_ref, q_ref),
                         (xf.abs().sum(0), (xf * xf).sum(0)),
                         lambda: K.bn_forward_plain(x, scale, bias, eps,
                                                    run_mean, run_var, mom),
                         lambda: torch.batch_norm_stats(x, eps),
                         m * c * 2 + 11 * c * 4, 3 * m * c),
            "bn_bwd_stats": (lambda: K.bn_backward(dy, x, mean, invstd,
                                                   scale),
                             lambda: K.bn_bwd_stats(dy, x, mean, invstd),
                             (s1_ref, s2_ref),
                             (dyf.abs().sum(0), (dyf * xh).abs().sum(0)),
                             lambda: K.bn_backward_plain(dy, x, mean, invstd,
                                                         scale),
                             lambda: torch.batch_norm_backward_reduce(
                                 dy, x, mean, invstd, None, True, False,
                                 False),
                             2 * m * c * 2 + 8 * c * 4, 5 * m * c),
        }
        for name, (kern, kern_raw, ref, mag, plain, library, nbytes,
                   flops) in cases.items():
            got = raw[name]
            again = kern_raw()
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
            check(epi_ulps[name] <= BN_ULPS,
                  f"{name} {(m, c)}: epilogue {epi_ulps[name]:.3g} fp32 "
                  f"units from the module's math > {BN_ULPS}")
            ms, host_ms = time_ms(torch, kern, flush, reps)
            raw_ms, _ = time_ms(torch, kern_raw, flush, reps)
            plain_ms, _ = time_ms(torch, plain, flush, reps)
            lib_ms, _ = time_ms(torch, library, flush, reps)
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 flops / FP32_FLOPS)
            row = rows[name]
            row["ms"] += n * ms
            row["host_ms"] += n * host_ms
            row["raw_ms"] += n * raw_ms
            row["plain_ms"] += n * plain_ms
            row["library_ms"] += n * lib_ms
            row["bound_ms"] += n * bound_ms
            row["max_abs_err"] = max(row["max_abs_err"], abs_err)
            row["max_rel_err"] = max(row["max_rel_err"], rel_err)
            row["max_epilogue_ulps"] = max(row["max_epilogue_ulps"],
                                           epi_ulps[name])
            if ms > lib_ms:
                row["slower_than_library"].append([m, c])
            log(f"  {name} M={m} C={c} x{n}: kernel {ms:.4f} ms (host "
                f"{host_ms:.4f} ms, raw sums {raw_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms, abs err {abs_err:.3g}, err/sum|terms| "
                f"{rel_err:.3g}, epilogue {epi_ulps[name]:.3g} fp32 units")
        del x, dy, xf, dyf, xh
    for name, row in rows.items():
        log(f"  {name} over a step's 53 layers: kernel {row['ms']:.4f} ms "
            f"(raw sums {row['raw_ms']:.4f} ms, host {row['host_ms']:.4f} "
            f"ms), library {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms; slower than the library at "
            f"{row['slower_than_library'] or 'no shape'}")
    return rows


def bn_measure_floor(torch, K, dev, flush, reps, log):
    """What phase 1's measure costs any call, beside K2's own floor: a
    16-byte memset and K2 on (64, 64) after the flush, and K2 at the stem
    layer (103 MB, past the L2) after the flush and after a 16-byte write
    (the difference is the write-back of the flush's dirty L2 lines); and
    the card's capacity that K2/K3's plan reads."""
    tiny = torch.zeros(16, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    small = torch.randn(64, 64, device=dev, generator=gen).bfloat16()
    stem = torch.randn(802816, 64, device=dev, generator=gen).bfloat16()
    out = {"memset_ms": time_ms(torch, tiny.zero_, flush, reps)[0],
           "k2_64x64_ms": time_ms(torch, lambda: K.bn_stats(small), flush,
                                  reps)[0],
           "k2_stem_ms": time_ms(torch, lambda: K.bn_stats(stem), flush,
                                 reps)[0],
           "k2_stem_unflushed_ms": time_ms(torch, lambda: K.bn_stats(stem),
                                           tiny, reps)[0],
           "card": {"k2": K._bn_card(dev.index, 1, False),
                    "k3": K._bn_card(dev.index, 1, True)}}
    log(f"  the measure's floor: a 16-byte memset {out['memset_ms']:.4f} ms,"
        f" K2 on (64, 64) {out['k2_64x64_ms']:.4f} ms; K2 at M=802816 C=64 "
        f"{out['k2_stem_ms']:.4f} ms after the flush, "
        f"{out['k2_stem_unflushed_ms']:.4f} ms without; (slots, SMs, "
        f"largest cluster) of bf16 K2 {out['card']['k2']}, K3 "
        f"{out['card']['k3']}")
    return out


def check_bn_inputs(torch, K, dev, log):
    """K2/K3 on what the TMA route does not take and the reference
    computes: fp16 C = 3, bf16 C = 12, one row, and a view 2 bytes past a
    16-byte boundary (bitwise equal to its aligned copy), against the plain
    versions."""
    gen = torch.Generator(device=dev).manual_seed(6)
    base = torch.randn(3136 * 512 + 1, device=dev, generator=gen)
    cases = (("fp16 C=3", torch.randn(4096, 3, device=dev, generator=gen)
              .half()),
             ("bf16 C=12", torch.randn(1000, 12, device=dev, generator=gen)
              .bfloat16()),
             ("fp16 M=1", torch.randn(1, 64, device=dev, generator=gen)
              .half()),
             ("unaligned bf16", base.bfloat16()[1:].view(3136, 512)))
    for what, x in cases:
        m, c = x.shape
        dy = torch.randn(m, c, device=dev, generator=gen).to(x.dtype)
        scale = torch.ones(c, device=dev)
        s_ref, q_ref = K.bn_stats_plain(x)
        mean = s_ref / m
        invstd = torch.rsqrt(torch.clamp(q_ref / m - mean * mean, min=0)
                             + 1e-5)
        got = (*K.bn_stats(x), *K.bn_bwd_stats(dy, x, mean, invstd))
        want = (s_ref, q_ref, *K.bn_bwd_stats_plain(dy, x, mean, invstd))
        xf, dyf = x.float(), dy.float()
        terms = (xf, xf * xf, dyf, dyf * (xf - mean) * invstd)
        err = max(float(((g - w).abs() / (t.abs().sum(0) + 1e-30)).max())
                  for g, w, t in zip(got, want, terms))
        fwd = K.bn_forward(x, scale, torch.zeros_like(scale), 1e-5)
        ulps = _bn_ulps(torch, fwd, _bn_fwd_epilogue(
            torch, got[0], got[1], m, scale, torch.zeros_like(scale), 1e-5))
        same = True
        if x.data_ptr() % 16:
            xc = x.clone()
            same = all(torch.equal(a, b) for a, b in
                       zip(K.bn_stats(x), K.bn_stats(xc)))
        torch.cuda.synchronize()
        log(f"  {what} (M={m}, C={c}): err/sum|terms| {err:.3g}, epilogue "
            f"{ulps:.3g} fp32 units" + ("" if same is True else
                                        ", aligned copy differs"))
        check(err <= BN_REL_TOL and ulps <= BN_ULPS and same,
              f"BN kernels on {what}: error {err:.3g}, {ulps:.3g} units, "
              f"aligned copy equal: {same}")


def bn_module_launches(torch, FusedBatchNorm, dev, log):
    """The CUDA kernels one FusedBatchNorm layer (bf16, ResNet-50's
    stage-3 shape at batch 64) issues forward and backward, counted with
    torch.profiler: at most 2 and 4."""
    from torch.profiler import ProfilerActivity, profile
    bn = FusedBatchNorm(256, dtype=torch.bfloat16).to(dev)
    x = torch.randn(64, 256, 14, 14, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last).requires_grad_()
    dy = torch.randn_like(x)
    bn(x).backward(dy)
    bn.zero_grad(set_to_none=True)   # as the step's zero_grad: no adds
    x.grad = None

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    out = {}
    fwd = kernels(lambda: out.setdefault("y", bn(x)))
    bwd = kernels(lambda: out["y"].backward(dy))
    log(f"  FusedBatchNorm launches per layer: forward {len(fwd)}, backward "
        f"{len(bwd)} ({', '.join(n[:40] for n in fwd + bwd)})")
    check(1 <= len(fwd) <= 2 and 1 <= len(bwd) <= 4,
          f"FusedBatchNorm issues {len(fwd)} kernels forward, {len(bwd)} "
          "backward (at most 2 and 4)")
    return {"forward": len(fwd), "backward": len(bwd)}


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


PACK_OUT_RANKS = 4      # the world whose padding phase 1's K1 out= check has
PACK_OUT_TAIL = 13      # a tensor of 13 fp32 after a bucket: no 16-byte tail


def check_pack_out_kernel(torch, K, bucket_by_size, dev, grads, flush, reps,
                          log):
    """K1's out= form (ZeRO-1's padded buckets) against its plain version
    on ResNet-50's gradient buckets at the 64 MB fusion threshold, each
    with a 13-element tensor after it (a tail of no whole 16-byte word),
    into a buffer padded for PACK_OUT_RANKS ranks whose padding holds a
    sentinel: bitwise on the packed prefix, the padding untouched. Times
    summed over buckets, beside ``torch.cat(out=)`` (the library call)."""
    tail = torch.arange(PACK_OUT_TAIL, dtype=torch.float32, device=dev)
    row = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "max_abs_err": 0.0}
    for idxs in bucket_by_size(grads, 64 * 1024 * 1024):
        bucket = [grads[i] for i in idxs] + [tail]
        total = sum(t.numel() for t in bucket)
        shard = -(-total // PACK_OUT_RANKS)
        got = torch.full((shard * PACK_OUT_RANKS,), 7.0, device=dev)
        want = got.clone()
        check(K.pack(bucket, out=got) is got, "pack(out=) returned another "
              "buffer")
        K.pack_plain(bucket, out=want)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and bool((got[total:] == 7.0).all()),
              "pack(out=) differs from its plain version or wrote past its "
              "prefix")
        flat_views = [t.view(-1) for t in bucket]
        ms, host_ms = time_ms(torch, lambda: K.pack(bucket, out=got), flush,
                              reps)
        plain_ms, _ = time_ms(torch, lambda: K.pack_plain(bucket, out=want),
                              flush, reps)
        lib_ms, _ = time_ms(torch, lambda: torch.cat(
            flat_views, out=want[:total]), flush, reps)
        bound_ms = 1e3 * 2 * 4 * total / HBM_BYTES_PER_S
        for key, v in (("ms", ms), ("host_ms", host_ms),
                       ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", bound_ms)):
            row[key] += v
        log(f"  pack(out=) bucket of {len(bucket)} tensors, {total} fp32 "
            f"into {shard * PACK_OUT_RANKS}: kernel {ms:.4f} ms (host "
            f"{host_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.cat(out=) "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms, bitwise equal, "
            "padding untouched")
    return row


def flash_pairs(b, h, tq, tk, causal):
    """The (q, kv) pairs this run's mask lets through: causal, key <= query
    by absolute index."""
    if not causal:
        return b * h * tq * tk
    n = min(tq, tk)
    return b * h * (n * (n + 1) // 2 + (tq - n) * tk)


def flash_work(b, h, tq, tk, d, causal, itemsize):
    """Per K6 kernel: (bytes, operations, peak operations/s). Bytes count
    each input read once and each output written once; operations are the
    products over the (q, kv) pairs this run's mask lets through, at the
    caller's head dim (the padded columns are no work the function
    needs), on the tensor cores (tf32 for fp32 inputs)."""
    pairs = flash_pairs(b, h, tq, tk, causal)
    xq = b * h * tq * d * itemsize   # one [B, H, Tq, D] tensor
    xk = b * h * tk * d * itemsize   # one [B, H, Tk, D] tensor
    st = b * h * tq * 4              # one fp32 [B, H, Tq] tensor (lse, di)
    peak = TF32_FLOPS if itemsize == 4 else BF16_FLOPS
    return {
        # S = QK^T and O = PV
        "flash_fwd": (2 * xq + 2 * xk + st, 4 * d * pairs, peak),
        # di = rowsum(dO * O), fp32 outside the tensor cores
        "flash_bwd_pre": (2 * xq + st, 2 * b * h * tq * d, FP32_FLOPS),
        # S^T, dV += P^T dO, dP^T = V dO^T, dK += dS^T Q
        "flash_bwd_dkdv": (2 * xq + 4 * xk + 2 * st, 8 * d * pairs, peak),
        # S, dP = dO V^T, dQ += dS K
        "flash_bwd_dq": (3 * xq + 2 * xk + 2 * st, 6 * d * pairs, peak),
    }


def bound(nbytes, ops, peak):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def forward_rate(ops, ms, bound_ms):
    """A forward's achieved rate on its products and its share of the
    bound (bound time over kernel time)."""
    return {"tflops": ops / (ms * 1e9), "bound_share": bound_ms / ms}


def rate_text(entry):
    if "tflops" not in entry:
        return ""
    return (f", {entry['tflops']:.1f} TFLOP/s, "
            f"{100 * entry['bound_share']:.1f}% of the bound")


def flash_limit(want, plain_err, dtype):
    """A kernel output's error limit against the fp32 plain version: twice
    the plain version's error in the input dtype (fp32: in tf32, see
    plain_matmuls) plus a floor of the largest entry, 1e-3 for bf16 and
    fp16 and TF32_FLOOR for fp32."""
    big = float(want.abs().max())
    return 2 * plain_err + (TF32_FLOOR if dtype == "float32" else 1e-3) * big


def plain_matmuls(torch, dtype):
    """The context in which the plain versions run in the input dtype: for
    fp32, a mode in which torch.matmul rounds both operands to tf32 (10
    mantissa bits, to nearest with ties away, as the kernels' cvt.rna) and
    sums in fp32, so every product is rounded where the tf32 kernels round
    it, whatever kernel cuBLAS picks (with tf32 allowed it still runs head
    dim 16 in fp32)."""
    if dtype != "float32":
        return contextlib.nullcontext()

    def tf32(x):
        return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    class Tf32Matmuls(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.matmul:
                args = tuple(tf32(a) for a in args)
            return func(*args, **(kwargs or {}))

    return Tf32Matmuls()


def check_flash_kernels(torch, K, dev, flush, reps, log):
    """K6 against its plain versions at each of FLASH_SHAPES: each output's
    error against the plain version in fp32 (from the same inputs) within
    :func:`flash_limit`. Returns a row per kernel (numbers at the flagship
    shape, every shape under "shapes"), the entries of each fp32 shape
    ({shape: {kernel: entry}}, the rows of TF32_ROWS) and a fwd/fwd+bwd
    summary per shape beside SDPA's."""
    import torch.nn.functional as F
    rows = {n: {"shapes": []} for n in FLASH_KERNELS}
    fp32_entries = {}
    summary = []
    for what, b, h, tq, tk, d, causal, dtype in FLASH_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(2)
        dt = getattr(torch, dtype)
        # laid out [B, T, H, D], as the models project them; the kernels
        # take the [B, H, T, D] views with their strides
        q, k, v, do = (torch.randn(b, rows_, h, d, device=dev, generator=gen)
                       .to(dt).transpose(1, 2)
                       for rows_ in (tq, tk, tk, tq))
        scale = d ** -0.5
        f32 = [x.float() for x in (q, k, v, do)]
        o32, lse32 = K.flash_attention_fwd_plain(*f32[:3], causal, scale)
        di32 = K.flash_bwd_pre_plain(o32, f32[3])
        dk32, dv32 = K.flash_bwd_dkdv_plain(*f32, lse32, di32, causal, scale)
        dq32 = K.flash_bwd_dq_plain(*f32, lse32, di32, causal, scale)
        del f32, di32
        with plain_matmuls(torch, dtype):
            ob, lseb = K.flash_attention_fwd_plain(q, k, v, causal, scale)
            dib = K.flash_bwd_pre_plain(ob, do)
            dkb, dvb = K.flash_bwd_dkdv_plain(q, k, v, do, lseb, dib, causal,
                                              scale)
            dqb = K.flash_bwd_dq_plain(q, k, v, do, lseb, dib, causal, scale)
        n0 = K.launch_counts()
        o, lse = K.flash_fwd(q, k, v, causal, scale)
        di = K.flash_bwd_pre(o, do)
        dk, dv = K.flash_bwd_dkdv(q, k, v, do, lse, di, causal, scale)
        dq = K.flash_bwd_dq(q, k, v, do, lse, di, causal, scale)
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        pad_copies = {n: n1[f"{n}_pad_copies"] - n0[f"{n}_pad_copies"]
                      for n in FLASH_KERNELS}
        if d != K._flash_dim(d):
            # every launch is a Hopper kernel's, which reads these [B, T,
            # H, D] views in place
            log(f"  {what}: zero-pad copies {pad_copies}")
            check(not any(pad_copies.values()),
                  f"K6 {what}: a Hopper route copied its inputs: "
                  f"{pad_copies}")
        err = {}
        for name, got, want, plain in (
                ("o", o, o32, ob), ("lse", lse, lse32, lseb),
                ("dq", dq, dq32, dqb), ("dk", dk, dk32, dkb),
                ("dv", dv, dv32, dvb)):
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"K6 {what} {name}: shape {tuple(got.shape)} or not finite")
            err[name] = float((got.float() - want).abs().max())
            base = float((plain.float() - want).abs().max())
            limit = flash_limit(want, base, dtype)
            log(f"  {what} {name}: kernel error {err[name]:.4g}, "
                f"{'tf32' if dtype == 'float32' else dtype} plain error "
                f"{base:.4g}, limit {limit:.4g}")
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

        # SDPA takes causal as the same top-left rule (key <= query)
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
        work = flash_work(b, h, tq, tk, d, causal, dt.itemsize)
        library = {"flash_fwd": sdpa_fwd_ms, "flash_bwd_dkdv": sdpa_bwd_ms,
                   "flash_bwd_dq": sdpa_bwd_ms}
        entries = {}
        for name, (kern, plain) in calls.items():
            ms, host_ms = time_ms(torch, kern, flush, reps)
            plain_ms, _ = time_ms(torch, plain, flush, max(3, reps // 4))
            nbytes, ops, peak = work[name]
            bound_ms, bound_by = bound(nbytes, ops, peak)
            entry = dict(what=what, shape=[b, h, tq, tk, d], dtype=dtype,
                         causal=causal, ms=ms, host_ms=host_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library.get(name),
                         max_abs_err=errors[name])
            if name == "flash_fwd":
                entry.update(forward_rate(ops, ms, bound_ms))
            entries[name] = entry
            rows[name]["shapes"].append(entry)
            log(f"  {what} {name}: kernel {ms:.4f} ms (host {host_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})" + rate_text(entry))
        if dtype == "float32":
            fp32_entries[what] = entries
            check_route(torch, K, f"K6 {what}", kernel_fwd_bwd, K6_ROUTED,
                        "sm90_tf32", log)
        elif K._flash_dim(d) > DEEP_ABOVE["bwd"]:
            check_route(torch, K, f"K6 {what}", kernel_fwd_bwd, K6_ROUTED,
                        "sm90_wide", log, d)
        # attention forward and backward as one function: the products of
        # the forward (S, O: 4 D a pair) and of the backward (S again, dP,
        # dV, dK, dQ: 10 D a pair) on the tensor cores, after the pass that
        # reads dO and O for di, which the backward's dS waits for. The
        # kernels' own bounds add up to more: dq recomputes S and dP.
        peak = work["flash_fwd"][2]
        fb_bound = 1e3 * (14 * d * flash_pairs(b, h, tq, tk, causal) / peak
                          + work["flash_bwd_pre"][0] / HBM_BYTES_PER_S)
        bwd_ms = sum(entries[n]["ms"] for n in FLASH_KERNELS[1:])
        summary.append(dict(what=what, dtype=dtype, pad_copies=pad_copies,
                            fwd_ms=entries["flash_fwd"]["ms"],
                            bwd_ms=bwd_ms, fwd_bwd_ms=fb_ms,
                            fwd_bwd_host_ms=fb_host_ms,
                            fwd_bwd_bound_ms=fb_bound,
                            sdpa_fwd_ms=sdpa_fwd_ms, sdpa_bwd_ms=sdpa_bwd_ms,
                            sdpa_fwd_bwd_ms=sdpa_fb_ms))
        log(f"  {what}: K6 backward (di + dk/dv + dq) {bwd_ms:.4f} ms "
            f"against SDPA's backward {sdpa_bwd_ms:.4f} ms; K6 fwd+bwd "
            f"{fb_ms:.4f} ms (bound {fb_bound:.4f} ms); SDPA fwd "
            f"{sdpa_fwd_ms:.4f} ms, fwd+bwd {sdpa_fb_ms:.4f} ms")
        del q, k, v, do, o, lse, di, dk, dv, dq, qg, kg, vg, sdpa_out
        torch.cuda.empty_cache()
    for name in FLASH_KERNELS:
        first = rows[name]["shapes"][0]
        rows[name].update({key: first[key] for key in
                           ("ms", "host_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "tflops", "bound_share")
                           if key in first})
        rows[name]["max_abs_err"] = max(e["max_abs_err"]
                                        for e in rows[name]["shapes"])
    return rows, fp32_entries, summary


TRACE_TRIES = 6   # traces of a step, while they miss a kernel that ran
TRACE_PAD_S = 0.02   # host idle before a traced step's launches and after it
TRACE_RETRY_S = 0.2  # pause before a step is traced again
TRACE_LOST = []      # (try, kernels seen) of each trace the caller refused


def trace_once(torch, step, pad=TRACE_PAD_S):
    """{name: (launches, device ms)} of the device operations of
    ``step()`` in one torch.profiler trace: the active step of a schedule
    whose warm-up step runs the same calls (a trace started cold may miss
    what runs first), each step with ``pad`` s of idle host time on either
    side."""
    from torch.profiler import ProfilerActivity, profile, schedule
    seen = {}

    def read(prof):   # the active step's events, before they are cleared
        seen.update({ev.key: (ev.count, ev.self_device_time_total / 1e3)
                     for ev in prof.key_averages()
                     if getattr(ev, "self_device_time_total", 0.0) > 0})

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=read) as prof:
        for _ in range(2):
            time.sleep(pad)
            step()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
    return seen


def trace_kernels(torch, step, ok):
    """trace_once of ``step``, traced again while ``ok(trace)`` is false.
    A trace can lose a short step's kernel events while it keeps their
    launches (``--trace-probe 300`` on an H100: of 300 unpadded traces of
    phase 4's 1.4 ms K6 D640 step, 2 held none of its four kernels and 1
    lost one; of 300 with TRACE_PAD_S, none; PERF.md), so each step is
    padded, and a refused trace is retried after TRACE_RETRY_S, up to
    TRACE_TRIES traces, each refusal noted in TRACE_LOST for the log. The
    caller's check reads the last trace, so a kernel that did not run
    fails it every time."""
    for attempt in range(TRACE_TRIES):
        if attempt:
            time.sleep(TRACE_RETRY_S)
        seen = trace_once(torch, step)
        if ok(seen):
            break
        TRACE_LOST.append((attempt, len(seen)))
    return seen


def trace_probe(torch, K, dev, n, smi, log):
    """How often trace_once loses a short step's kernels, unpadded and
    padded (``--trace-probe N``): phase 4's K6 D640 step (forward, di,
    dk/dv, dq at B1 H2 T512, bf16, causal, two calls) traced N times each
    way, interleaved; the counts as the last line."""
    b, h, t, d = 1, 2, 512, 640
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=gen)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    scale = d ** -0.5

    def step():
        for _ in range(2):
            o, lse = K.flash_fwd(q, k, v, True, scale)
            di = K.flash_bwd_pre(o, do)
            K.flash_bwd_dkdv(q, k, v, do, lse, di, True, scale)
            K.flash_bwd_dq(q, k, v, do, lse, di, True, scale)

    want = ("flash_fwd_", "flash_bwd_pre_", "flash_bwd_dkdv_",
            "flash_bwd_dq_")
    step()
    torch.cuda.synchronize()
    lost = {0.0: [0] * (len(want) + 1), TRACE_PAD_S: [0] * (len(want) + 1)}
    for _ in range(n):
        for pad in lost:
            seen = trace_once(torch, step, pad)
            lost[pad][sum(not any(w in k_ for k_ in seen)
                          for w in want)] += 1
    for pad, hist in lost.items():
        log(f"  pad {pad} s: traces by kernels lost (0..{len(want)}): "
            f"{hist}")
    print(smi)
    print(json.dumps({"trace_probe": {
        "step": f"K6 B{b} H{h} T{t} D{d} bfloat16 causal, 2 calls",
        "traces_by_kernels_lost": {str(p): h_ for p, h_ in lost.items()}}}))
    return 0


def kernels_per_call(torch, calls, n):
    """Device operations per call from a torch.profiler trace of ``n``
    calls of each of ``calls`` ({wrapper: (fn, its kernel's name)})
    (trace_kernels): {wrapper: its kernel's launches a call, "other": the
    operations that are no wrapper's kernel (copies, fills) a call}."""
    def step():
        for fn, _ in calls.values():
            for _ in range(n):
                fn()
    names = [kernel for _, kernel in calls.values()]
    seen = {k: c for k, (c, _) in trace_kernels(
        torch, step,
        lambda t: all(any(n in k for k in t) for n in names)).items()}
    out = {w: sum(c for k, c in seen.items() if kernel in k) / n
           for w, (_, kernel) in calls.items()}
    out["other"] = sum(c for k, c in seen.items()
                       if not any(kernel in k for kernel in names)
                       ) / (n * len(calls))
    return out


def flash_source(name):
    """The source of a K6/K7 kernel's 16-bit instantiations: the Hopper
    forward or backward, or (di) flash_attn.cu."""
    if name in ("flash_fwd", "flash_seg_fwd"):
        return "flash_fwd_sm90.cu"
    return "flash_attn.cu" if name == "flash_bwd_pre" else "flash_bwd_sm90.cu"


def seg_work(b, h, s, d, causal, itemsize):
    """Per K7 kernel on one [B, H, S, D] segment: (bytes, operations, peak
    operations/s), counted as for K6 with fp32 outputs."""
    pairs = flash_pairs(b, h, s, s, causal)
    x = b * h * s * d * itemsize   # one [B, H, S, D] input
    xf = b * h * s * d * 4         # one fp32 [B, H, S, D] tensor
    st = b * h * s * 4             # one fp32 [B, H, S] tensor (lse, di)
    peak = TF32_FLOPS if itemsize == 4 else BF16_FLOPS
    return {
        "flash_seg_fwd": (3 * x + xf + st, 4 * d * pairs, peak),
        "flash_seg_bwd_dkdv": (4 * x + 2 * st + 2 * xf, 8 * d * pairs,
                               peak),
        "flash_seg_bwd_dq": (4 * x + 2 * st + xf, 6 * d * pairs, peak),
    }


def check_seg_kernels(torch, K, dev, flush, reps, log):
    """K7 against its plain versions at each of SEG_SHAPES, as phase 4 holds
    K6: each output's error against the plain version in fp32 (from the
    same inputs) within :func:`flash_limit` (twice the plain version's in
    the input dtype, fp32's in tf32, plus 1e-3 or TF32_FLOOR of the largest
    entry), and the kernels give the same bits on the strided views as on
    contiguous copies of them. Returns a row per kernel (numbers at the
    first shape, every shape under "shapes")."""
    import torch.nn.functional as F
    rows = {n: {"shapes": []} for n in SEG_KERNELS}
    for what, b, h, t, d, part, dtype in SEG_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(3)
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=gen)
                       .to(dt).transpose(1, 2) for _ in range(4))
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
        with plain_matmuls(torch, dtype):
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
            limit = flash_limit(want, base, dtype)
            log(f"  {what} {name}: kernel error {err[name]:.4g}, "
                f"{'tf32' if dtype == 'float32' else 'bf16'} plain error "
                f"{base:.4g}, limit {limit:.4g}")
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
        # SDPA's backward of the same segment (its own lse: the same dq,
        # dk and dv as K7b and K7c under a lse that is the segment's)
        qg, kg, vg = (x.detach().requires_grad_() for x in (sq, sk, sv))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg,
                                                  is_causal=causal)
        sdpa_bwd_ms, _ = time_ms(
            torch, lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), sdo,
                                               retain_graph=True),
            flush, reps)
        del qg, kg, vg, sdpa_out
        library = {"flash_seg_fwd": sdpa_ms, "flash_seg_bwd_dkdv": sdpa_bwd_ms,
                   "flash_seg_bwd_dq": sdpa_bwd_ms}
        work = seg_work(b, h, s, d, causal, dt.itemsize)
        for name, (kern, plain) in calls.items():
            ms, host_ms = time_ms(torch, kern, flush, reps)
            plain_ms, _ = time_ms(torch, plain, flush, max(3, reps // 4))
            bound_ms, bound_by = bound(*work[name])
            entry = dict(what=what, shape=[b, h, s, d], dtype=dtype,
                         causal=causal, ms=ms, host_ms=host_ms,
                         plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library[name],
                         max_abs_err=errors[name])
            if name == "flash_seg_fwd":
                entry.update(forward_rate(work[name][1], ms, bound_ms))
            rows[name]["shapes"].append(entry)
            log(f"  {what} {name}: kernel {ms:.4f} ms (host {host_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})" + rate_text(entry)
                + (f", SDPA forward {sdpa_ms:.4f} ms"
                   if name == "flash_seg_fwd" else ""))
        if dtype == "float32" or K._flash_dim(d) > DEEP_ABOVE["bwd"]:
            check_route(
                torch, K, f"K7 {what}",
                lambda: [fn() for fn, _ in calls.values()], SEG_KERNELS,
                "sm90_tf32" if dtype == "float32" else "sm90_wide", log, d)
        bwd_ms = sum(rows[n]["shapes"][-1]["ms"] for n in SEG_KERNELS[1:])
        log(f"  {what}: K7b + K7c {bwd_ms:.4f} ms against SDPA's "
            f"{'causal' if causal else 'non-causal'} backward of the segment "
            f"{sdpa_bwd_ms:.4f} ms")
        del q, k, v, do, lse, di, seg, sq, sk, sv, sdo, slse, sdi, kargs
        del o_k, lse_k, dk_k, dv_k, dq_k, calls
        torch.cuda.empty_cache()
    for name in SEG_KERNELS:
        first = rows[name]["shapes"][0]
        rows[name].update({key: first[key] for key in
                           ("ms", "host_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "tflops", "bound_share")
                           if key in first})
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
    pairs = flash_pairs(b, h, t, t, True)
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


def wide_routes(K, dtype, d, ring):
    """The route each kernel of one wide path takes (flash_route: bf16 and
    fp16 the Hopper kernels, the deep dk/dv and dq above head dim 256;
    fp32: the Hopper tf32 kernels at every head dim), K7's on the ring,
    K6's on flash_attention_local: {wrapper: "sm90_wide" or
    "sm90_tf32"}."""
    names = WIDE_KERNELS[3:] if ring else WIDE_KERNELS[:3]
    return {name: K.flash_route(dtype, d, name) for name in names}


# the routes a wide path's launches may take, and the CUDA kernel (by the
# suffix of its name after ROUTE_KERNELS' base) each launches
WIDE_PATH_ROUTES = {"sm90_wide": "_sm90_kernel",
                    "sm90_tf32": "_sm90_tf32_kernel"}


def wide_route_ok(counts, routes):
    """Whether one wide path's launch counts show each wrapper on its route
    (at least once) and never on another."""
    for name, want in routes.items():
        for route in WIDE_PATH_ROUTES:
            n = counts.get(f"{name}_{route}", 0)
            if (n < 1) if route == want else (n != 0):
                return False
    return True


def traced_route_ok(names, routes, d=0):
    """Whether the kernel names of a profiler trace agree with the routes:
    each wrapper's kernel on its route (``<kernel>_sm90_kernel`` or
    ``<kernel>_sm90_tf32_kernel``) seen, the other never, and no mma.sync
    kernel (``_mma_kernel``); at a 16-bit head dim ``d`` above 256, dk/dv's
    and dq's deep kernels (``<kernel>_sm90_kernel_deep``)."""
    if any("_mma_kernel" in n for n in names):
        return False
    for name, route in routes.items():
        base = ROUTE_KERNELS[name]
        want = base + WIDE_PATH_ROUTES[route]
        if route == "sm90_wide" and d > DEEP_ABOVE["bwd"] \
                and "_bwd_" in base:
            want += "_deep"
        others = {base + k for k in WIDE_PATH_ROUTES.values()} - {want}
        if not any(want in n for n in names) \
                or any(other in n for other in others for n in names
                       if want not in n):
            return False
    return True


def check_route(torch, K, what, call, wrappers, route, log, d=0):
    """Phases 4, 8 and 12: every launch of ``call`` by ``wrappers`` on
    ``route`` (the Hopper tf32 kernels for fp32 inputs; for bf16 and fp16
    above head dim 256 the Hopper kernels, dk/dv and dq on the deep ones),
    by the counters (each launch of ``wrappers`` counted in
    ``<wrapper>_<route>``) and by the kernel names a torch.profiler trace
    of two calls saw (traced_route_ok: each wrapper's kernel of the route,
    no other and no mma.sync kernel). Returns the traced names of the
    attention kernels."""
    routes = {w: route for w in wrappers}

    def names(trace):
        return sorted({re.sub(r"^.*?(flash_\w+?_kernel\w*).*$", r"\1", k)
                       for k in trace if "flash_" in k})
    n0 = K.launch_counts()
    traced = names(trace_kernels(
        torch, lambda: [call() for _ in range(2)],
        lambda t: traced_route_ok(names(t), routes, d)))
    n1 = K.launch_counts()
    counted = {w: (n1[f"{w}_{route}"] - n0[f"{w}_{route}"], n1[w] - n0[w])
               for w in wrappers}
    log(f"  {what}: launches ({route}, all) {counted}, traced {traced}")
    check(all(on == n >= 2 for on, n in counted.values())
          and traced_route_ok(traced, routes, d),
          f"{what}: a launch off the {route} route: {counted}, traced "
          f"{traced}")
    return traced


def run_wide_path(torch, K, R, fa, dev, log):
    """Phase 13: attention above head dim 128 through the entry points a
    user calls, ``flash_attention_local`` and ``ring_attention_p``
    (zig-zag, ``force_ring=True``), forward and backward of sum(out²) at
    each of WIDE_PATHS: each output and gradient within twice the plain
    version's error in the input dtype (fp32: in tf32) plus 1e-3 (fp32:
    TF32_FLOOR) of the largest entry of the fp32 plain version's; each
    kernel on its route, by its launch
    counter (wide_route_ok) and by the kernels a torch.profiler trace of
    two calls saw (traced_route_ok). Times each path's forward + backward
    (CUDA events, median of WIDE_WINDOWS windows) and, from the trace, the
    share of its attention kernels' device time that is dq's. Returns the
    summary per path."""
    summary = []
    for what, path, b, t, h, d, dtype in WIDE_PATHS:
        path_start = K.launch_counts()
        dt = getattr(torch, dtype)
        scale = d ** -0.5
        gen = torch.Generator(device=dev).manual_seed(8)
        base = [(torch.randn(b, t, h, d, device=dev, generator=gen) * 0.3)
                .to(dt) for _ in range(3)]

        def fwd_bwd():
            q, k, v = (x.detach().requires_grad_() for x in base)
            if path == "flash":
                out = fa.flash_attention_local(q, k, v, causal=True)
            else:
                out = R.ring_attention_p(q, k, v, None, 1, causal=True,
                                         layout=path, force_ring=True)
            (out.float() ** 2).sum().backward()
            return out.detach(), q.grad, k.grad, v.grad

        n0 = K.launch_counts()
        res = fwd_bwd()
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        counts = {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
        log(f"  {what} B{b} T{t} H{h} D{d} {dtype}: launches {counts}")
        routes = wide_routes(K, dt, d, path != "flash")
        check(wide_route_ok(counts, routes),
              f"{what} D{d}: kernels off their routes {routes}: {counts}")
        copies = {name: counts.get(f"{name}_pad_copies", 0)
                  for name in routes}
        check(not any(copies.values()),
              f"{what} D{d}: a Hopper route copied its inputs: {copies}")
        per_call = None
        diag = {}
        if d != K._flash_dim(d) and path == "flash":
            # the K6 wrappers on the path's [B, H, T, D] views, one at a
            # time: one kernel a call where nothing is copied
            diag0 = K.launch_counts()
            q, k, v, do = (x.transpose(1, 2) for x in base + [base[0]])
            o, lse = K.flash_fwd(q, k, v, True, scale)
            di = K.flash_bwd_pre(o, do)
            calls = {
                "flash_fwd": (lambda: K.flash_fwd(q, k, v, True, scale),
                              "flash_fwd_sm90_kernel"),
                "flash_bwd_pre": (lambda: K.flash_bwd_pre(o, do),
                                  "flash_bwd_pre_kernel"),
                "flash_bwd_dkdv": (lambda: K.flash_bwd_dkdv(
                    q, k, v, do, lse, di, True, scale),
                    "flash_bwd_dkdv_sm90_kernel"),
                "flash_bwd_dq": (lambda: K.flash_bwd_dq(
                    q, k, v, do, lse, di, True, scale),
                    "flash_bwd_dq_sm90_kernel")}
            per_call = kernels_per_call(torch, calls, WIDE_TRACED_CALLS)
            log(f"  {what} B{b} T{t} H{h} D{d} {dtype}: device operations a "
                f"K6 wrapper call runs (profiler): {per_call}")
            check(all(per_call[name] == 1 for name in calls)
                  and per_call["other"] == 0,
                  f"{what} D{d}: a K6 wrapper call ran more than its "
                  f"kernel: {per_call}")
            del q, k, v, do, o, lse, di, calls
            # these calls are no traffic of the path: path_launches
            # leaves them out
            diag = {k_: n_ - diag0[k_]
                    for k_, n_ in K.launch_counts().items()}
        got = [x.transpose(1, 2) for x in res]
        f32 = [x.float().transpose(1, 2) for x in base]
        o32, lse32 = K.flash_attention_fwd_plain(*f32, True, scale)
        ref32 = (o32, *K.flash_attention_bwd_plain(*f32, o32, lse32, 2 * o32,
                                                   True, scale))
        del f32, lse32
        lo = [x.transpose(1, 2) for x in base]
        with plain_matmuls(torch, dtype):
            ob, lseb = K.flash_attention_fwd_plain(*lo, True, scale)
            refb = (ob, *K.flash_attention_bwd_plain(
                *lo, ob, lseb, (2 * ob.float()).to(dt), True, scale))
        errors = {}
        for name, g, w32, wb in zip(("out", "dq", "dk", "dv"), got, ref32,
                                    refb):
            e = float((g.float() - w32).abs().max())
            lim = flash_limit(w32, float((wb.float() - w32).abs().max()),
                              dtype)
            errors[name] = e
            log(f"  {what} B{b} T{t} H{h} D{d} {dtype} {name}: error {e:.4g}"
                f" (limit {lim:.4g})")
            check(bool(torch.isfinite(g).all()) and e <= lim,
                  f"{what} D{d} {name}: error {e:.4g} > {lim:.4g}")
        del res, got, ref32, refb, lo, ob, lseb
        windows = []
        for _ in range(WIDE_WINDOWS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(WIDE_WINDOW_CALLS):
                fwd_bwd()
            end.record()
            torch.cuda.synchronize()
            windows.append(start.elapsed_time(end) / WIDE_WINDOW_CALLS)
        ms = statistics.median(windows)
        dp = K._flash_dim(d)
        traced = trace_kernels(
            torch, lambda: [fwd_bwd() for _ in range(WIDE_TRACED_CALLS)],
            lambda t: traced_route_ok(t, routes, dp))
        attn = {k_: ms_ / WIDE_TRACED_CALLS
                for k_, (_, ms_) in traced.items() if "flash_" in k_}
        seen = {k_: c_ for k_, (c_, _) in traced.items() if "flash_" in k_}
        attn_ms = sum(attn.values())
        dq_ms = sum(v for k_, v in attn.items() if "_dq_" in k_)
        check(attn_ms > 0, f"{what} D{d}: the profiler saw no attention "
              "kernel")
        # above 256 dk/dv and dq traced as their deep kernels
        check(traced_route_ok(attn, routes, dp),
              f"{what} D{d}: the traced kernels {sorted(attn)} disagree "
              f"with the counted routes {routes}")
        if dp > 320:
            # the split forward's instance, or above 512 the deep kernel
            want = (f"flash_fwd_sm90_kernel<{dp}," if dp <= 512 else
                    "flash_fwd_sm90_kernel_deep<")
            fwd = [n for n in attn if want in n]
            log(f"  {what} D{d}: traced forward {fwd}")
            check(len(fwd) >= 1, f"{what} D{d}: no {want}...> in the trace "
                  f"{sorted(attn)}")
        log(f"  {what} B{b} T{t} H{h} D{d} {dtype}: {ms:.4f} ms a forward + "
            f"backward (windows {', '.join(f'{x:.4f}' for x in windows)}); "
            f"attention kernels {attn_ms:.4f} ms of device time, dq "
            f"{dq_ms:.4f} ms ({100 * dq_ms / attn_ms:.1f}%)")
        # each attention kernel's launches the trace saw (it may miss the
        # first) and its device ms a launch, by its template name
        by_kernel = {re.sub(r"^.*?(flash_\w+<[^>]*>).*$", r"\1", k_):
                     (seen[k_], v * WIDE_TRACED_CALLS / seen[k_])
                     for k_, v in attn.items()}
        log(f"  {what} B{b} T{t} H{h} D{d} {dtype}: traced launches and "
            "device ms a launch by kernel: " + ", ".join(
                f"{k_} {n_} x {v:.4f}"
                for k_, (n_, v) in sorted(by_kernel.items())))
        summary.append(dict(what=what, shape=[b, t, h, d], dtype=dtype,
                            routes=routes, traced_kernels=sorted(attn),
                            pad_copies=copies,
                            device_ops_per_wrapper_call=per_call,
                            max_abs_err=errors, launches=counts, ms=ms,
                            windows=windows, attention_kernels_ms=attn_ms,
                            traced_launches_and_ms=by_kernel,
                            dq_ms=dq_ms, dq_share=dq_ms / attn_ms,
                            path_launches={
                                k: n - path_start[k] - diag.get(k, 0)
                                for k, n in K.launch_counts().items()
                                if n - path_start[k] - diag.get(k, 0)}))
        del base
        torch.cuda.empty_cache()
    return summary


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


def make_lm_trainer(torch, hvd, tm, dev, batch, sharded=None):
    """The flagship LM, its data and optimizer (``sharded`` as
    ``DistributedOptimizer`` takes it); returns one train step, whose
    ``opt`` attribute is the optimizer."""
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
                          eps=1e-8, weight_decay=1e-4), op=hvd.Average,
        sharded=sharded)

    def step():
        opt.zero_grad()
        loss = tm.lean_lm_loss(model, inputs, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    step.opt = opt
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
    ("flash-attention kernels (csrc/flash_fwd_sm90.cu, flash_attn.cu)",
     ("flash_",)),
    ("bn_stats kernels (csrc/bn_stats.cu)", ("bn_stats_kernel",)),
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
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        # a user annotation (the optimizer's step range) spans kernels that
        # are counted on their own
        if us > 0 and str(ev.device_type).endswith("CUDA") \
                and not getattr(ev, "is_user_annotation", False):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
            launches += ev.count
    busy = sum(kernels.values())
    check(busy > 0, "the profiler recorded no device time")
    groups = {}
    for name, ms in kernels.items():
        group = next((g for g, pats in KERNEL_GROUPS
                      if any(p.lower() in name.lower() for p in pats)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"  profile of {n} steps: wall {wall_ms / n:.2f} ms/step, device "
        f"busy {busy / n:.2f} ms/step ({100 * busy / wall_ms:.1f}%), "
        f"{launches / n:.1f} kernel launches/step (CUDA kernel events)")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group}: {ms / n:.3f} ms/step ({100 * ms / busy:.1f}% of "
            f"device time)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    kernel {ms / n:.3f} ms/step  {name[:110]}")
    return {"wall_ms_per_step": wall_ms / n, "busy_ms_per_step": busy / n,
            "busy_share": busy / wall_ms, "launches_per_step": launches / n}


def run_vit_tiny(torch, hvd, ViT_Tiny, K, dev, log):
    """Phase 12: ViT_Tiny (4 heads of 16) in fp32 on the card, through the
    Hopper tf32 forward, dk/dv and dq, which read the head dim of 16 in
    place (no zero-padded copy): its first logits against the same model's
    on the CPU (K6's plain versions), then TINY_STEPS SGD-momentum steps
    (losses finite), then a traced forward and backward, whose attention
    kernels must all be the Hopper tf32 ones (check_route). Returns
    the summary and the launch counts of the path."""
    model = ViT_Tiny(num_classes=10, dtype=torch.float32,
                     image_size=TINY_IMAGE,
                     generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    images = torch.rand(TINY_BATCH, TINY_IMAGE, TINY_IMAGE, 3, generator=gen)
    labels = torch.randint(0, 10, (TINY_BATCH,), generator=gen)
    with torch.no_grad():
        want = model(images)
    model = model.to(dev)
    images, labels = images.to(dev), labels.to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        op=hvd.Average)
    K.reset_launch_counts()
    losses = []
    for i in range(TINY_STEPS):
        opt.zero_grad()
        logits = model(images)
        if i == 0:
            err = float((logits.detach().cpu() - want).abs().max())
            limit = TINY_REL_TOL * float(want.abs().max())
        loss = torch.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    log(f"  logits against the CPU: {err:.4g} (limit {limit:.4g}); losses: "
        f"{' '.join(f'{v:.4f}' for v in losses)}; launches: {counts}")
    check(err <= limit, f"ViT_Tiny logits: {err:.4g} from the CPU's")
    check(all(v == v and abs(v) != float("inf") for v in losses),
          "non-finite ViT_Tiny loss")
    layers = len(model.blocks)
    for name in K6_ROUTED:
        check(counts[name] == counts[f"{name}_sm90_tf32"]
              == layers * TINY_STEPS,
              f"{name} launched {counts[name]} on the ViT_Tiny path "
              f"({counts[f'{name}_sm90_tf32']} on the Hopper tf32 route), "
              f"expected {layers * TINY_STEPS}")
    for name in K6_ROUTED + ("flash_bwd_pre",):
        copies = counts[f"{name}_pad_copies"]
        check(copies == 0, f"{name}: {copies} zero-padded copies on the "
              "ViT_Tiny path, expected 0")

    def fwd_bwd():
        torch.nn.functional.cross_entropy(model(images), labels).backward()

    traced = check_route(torch, K, "ViT_Tiny", fwd_bwd, K6_ROUTED,
                         "sm90_tf32", log)
    return (dict(logits_err=err, logits_limit=limit, losses=losses,
                 traced_kernels=traced), counts)


# phase 14: SyncBatchNorm over ResNet-50's BN layers, world size 1
SYNC_BN_REPS = 5               # timed forward + backward of the stack
SYNC_BN_SLEEP_CYCLES = 2_000_000_000   # about a second of the card spinning
SYNC_BN_SLEEP_LAYERS = 8       # about 250 launches: well inside the queue
# outputs (y, dx) in bf16 against FusedBatchNorm's and the CPU's: one unit
# in bf16's last place of each tensor's largest entry (both round the same
# fp32 math, from per-channel terms a few fp32 units apart)
SYNC_BN_OUT_EPS = 2.0 ** -7


def _sync_bn_layer(torch, SyncBatchNorm, FusedBatchNorm, m, c, batch, dev,
                   gen):
    """One BN layer of the stack: a bf16 channels_last input of (M, C), its
    cotangent, and a SyncBatchNorm and a FusedBatchNorm with the same
    random fp32 parameters."""
    s = math.isqrt(m // batch)
    x = torch.randn(batch, c, s, s, device=dev, generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(batch, c, s, s, device=dev, generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    scale = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    mods = []
    for cls in (SyncBatchNorm, FusedBatchNorm):
        mod = cls(c).to(dev)
        with torch.no_grad():
            mod.weight.copy_(scale)
            mod.bias.copy_(bias)
        mods.append(mod)
    return x, dy, mods


def _bn_step(torch, mods, xs, dys):
    """Forward and backward of one module per layer; returns (ys, dxs,
    dscales, dbiases)."""
    xs = [x.detach().requires_grad_() for x in xs]
    for mod in mods:
        mod.zero_grad(set_to_none=True)
    ys = [mod(x) for mod, x in zip(mods, xs)]
    torch.autograd.backward(ys, dys)
    return ([y.detach() for y in ys], [x.grad for x in xs],
            [m.weight.grad for m in mods], [m.bias.grad for m in mods])


def _rel_err(got, want):
    """Largest difference over the largest entry of ``want``."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def run_sync_bn_path(torch, K, SyncBatchNorm, FusedBatchNorm, dev, batch,
                     log):
    """Phase 14: SyncBatchNorm (world size 1: the collective is skipped)
    over ResNet-50's 53 BN layers at ``batch`` in bf16 channels_last,
    forward and backward, against FusedBatchNorm on the same inputs and
    against the module's plain path on the CPU (each distinct shape): y
    and dx within SYNC_BN_OUT_EPS of the largest entry, dscale, dbias and
    the running statistics within BN_ULPS fp32 units of the largest entry.
    Counts K2/K3 per layer (1 and 1 in raw mode), checks that issuing the
    step waits on no device value (no sync under torch's sync debug mode;
    the host returns from its first layers while a second of device sleep
    ahead of them still runs), and times the stack's forward + backward
    beside FusedBatchNorm's, by the host clock and by a profile of both
    (device time, busy share, launches a layer). Returns the summary and
    the path's launch counts."""
    shapes = resnet50_bn_shapes(batch)
    gen = torch.Generator(device=dev).manual_seed(14)
    layers = [_sync_bn_layer(torch, SyncBatchNorm, FusedBatchNorm, m, c,
                             batch, dev, gen) for m, c in shapes]
    xs = [x for x, _, _ in layers]
    dys = [dy for _, dy, _ in layers]
    sync_mods = [mods[0] for _, _, mods in layers]
    fused_mods = [mods[1] for _, _, mods in layers]

    # the path: one forward + backward of the stack, counts read after it
    K.reset_launch_counts()
    got = _bn_step(torch, sync_mods, xs, dys)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = _bn_step(torch, fused_mods, xs, dys)
    torch.cuda.synchronize()
    check(counts["bn_stats"] == len(shapes)
          and counts["bn_bwd_stats"] == len(shapes),
          f"SyncBatchNorm launched K2 {counts['bn_stats']} and K3 "
          f"{counts['bn_bwd_stats']} times over {len(shapes)} layers, "
          "expected one each a layer")
    errs = {"y": 0.0, "dx": 0.0, "dscale": 0.0, "dbias": 0.0,
            "running": 0.0}
    for i in range(len(shapes)):
        errs["y"] = max(errs["y"], _rel_err(got[0][i], want[0][i]))
        errs["dx"] = max(errs["dx"], _rel_err(got[1][i], want[1][i]))
        errs["dscale"] = max(errs["dscale"],
                             _rel_err(got[2][i], want[2][i]) / BN_EPS32)
        errs["dbias"] = max(errs["dbias"],
                            _rel_err(got[3][i], want[3][i]) / BN_EPS32)
        for name in ("running_mean", "running_var"):
            errs["running"] = max(errs["running"], _rel_err(
                getattr(sync_mods[i], name), getattr(fused_mods[i], name))
                / BN_EPS32)
    log(f"  against FusedBatchNorm: y {errs['y']:.3g}, dx {errs['dx']:.3g} "
        f"of the largest entry (limit {SYNC_BN_OUT_EPS:.3g}); dscale "
        f"{errs['dscale']:.2f}, dbias {errs['dbias']:.2f}, running "
        f"statistics {errs['running']:.2f} fp32 units (limit {BN_ULPS})")
    check(errs["y"] <= SYNC_BN_OUT_EPS and errs["dx"] <= SYNC_BN_OUT_EPS,
          f"SyncBatchNorm's outputs disagree with FusedBatchNorm's: {errs}")
    check(max(errs["dscale"], errs["dbias"], errs["running"]) <= BN_ULPS,
          f"SyncBatchNorm's sums disagree with FusedBatchNorm's: {errs}")

    # the module's plain path on the CPU, each distinct shape once
    cpu_errs = {"y": 0.0, "dx": 0.0, "dscale": 0.0, "dbias": 0.0}
    seen = set()
    for i, shape in enumerate(shapes):
        if shape in seen:
            continue
        seen.add(shape)
        mod = SyncBatchNorm(shape[1])
        with torch.no_grad():
            mod.weight.copy_(fused_mods[i].weight.detach().cpu())
            mod.bias.copy_(fused_mods[i].bias.detach().cpu())
        x, dy = xs[i].cpu(), dys[i].cpu()
        plain = _bn_step(torch, [mod], [x], [dy])
        for j, key in enumerate(("y", "dx")):
            cpu_errs[key] = max(cpu_errs[key],
                                _rel_err(got[j][i].cpu(), plain[j][0]))
        # the card's sums against torch's on the CPU, in another order:
        # within BN_REL_TOL of sum |terms|, the share of it reported
        rows = x.permute(0, 2, 3, 1).reshape(-1, shape[1]).float()
        dyf = dy.permute(0, 2, 3, 1).reshape(-1, shape[1]).float()
        xh = (rows - rows.mean(0)) * torch.rsqrt(
            rows.var(0, unbiased=False) + mod.eps)
        for j, key, terms in ((2, "dscale", dyf * xh), (3, "dbias", dyf)):
            bound = BN_REL_TOL * terms.abs().sum(0) + 1e-6
            cpu_errs[key] = max(cpu_errs[key], float(
                ((got[j][i].cpu() - plain[j][0]).abs() / bound).max()))
    log(f"  against the plain path on the CPU ({len(seen)} shapes): y "
        f"{cpu_errs['y']:.3g}, dx {cpu_errs['dx']:.3g} (limit "
        f"{SYNC_BN_OUT_EPS:.3g}); dscale {cpu_errs['dscale']:.3g}, dbias "
        f"{cpu_errs['dbias']:.3g} of their limit ({BN_REL_TOL} of "
        "sum |terms|)")
    check(cpu_errs["y"] <= SYNC_BN_OUT_EPS
          and cpu_errs["dx"] <= SYNC_BN_OUT_EPS
          and cpu_errs["dscale"] <= 1 and cpu_errs["dbias"] <= 1,
          f"SyncBatchNorm on the card disagrees with its CPU path: "
          f"{cpu_errs}")
    del got, want, plain

    # no host wait: the whole step under torch's sync debug mode (a call
    # that synchronizes raises), and the first layers' forward and backward
    # issued behind a second of device sleep: the host must return while
    # it runs (the whole step's launches would fill the card's launch
    # queue, which blocks the host by itself)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _bn_step(torch, sync_mods, xs, dys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = SYNC_BN_SLEEP_LAYERS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(SYNC_BN_SLEEP_CYCLES)
    _bn_step(torch, sync_mods[:n], xs[:n], dys[:n])
    issue_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream(dev).query()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    log(f"  the step raised no sync under torch.cuda.set_sync_debug_mode; "
        f"its first {n} layers issued behind {total_s:.3f} s of device work "
        f"took {issue_s:.3f} s of host time (stream still busy: {busy})")
    check(busy and issue_s < total_s / 2,
          f"issuing SyncBatchNorm's step waited on the card ({issue_s:.3f} "
          f"of {total_s:.3f} s)")

    # time: the stack's forward + backward, SyncBatchNorm and
    # FusedBatchNorm in turns
    times = {"sync": [], "fused": []}
    for _ in range(SYNC_BN_REPS):
        for key, mods in (("sync", sync_mods), ("fused", fused_mods),
                          ("fused", fused_mods), ("sync", sync_mods)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _bn_step(torch, mods, xs, dys)
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0))
    sync_ms = statistics.median(times["sync"])
    fused_ms = statistics.median(times["fused"])
    log(f"  forward + backward of the {len(shapes)} layers: SyncBatchNorm "
        f"{sync_ms:.3f} ms, FusedBatchNorm {fused_ms:.3f} ms (medians of "
        f"{2 * SYNC_BN_REPS}); K2 {counts['bn_stats'] // len(shapes)} and "
        f"K3 {counts['bn_bwd_stats'] // len(shapes)} a layer")
    profiles, per_layer = {}, {}
    for key, mods in (("sync", sync_mods), ("fused", fused_mods)):
        log(f"  {key}: the stack's device time")
        profiles[key] = profile_steps(
            torch, lambda mods=mods: _bn_step(torch, mods, xs, dys), 2, log)
        per_layer[key] = profiles[key]["launches_per_step"] / len(shapes)
    log(f"  launches a layer, forward + backward: SyncBatchNorm "
        f"{per_layer['sync']:.1f}, FusedBatchNorm {per_layer['fused']:.1f}")
    return (dict(layers=len(shapes), batch=batch, sync_ms=sync_ms,
                 fused_ms=fused_ms, sync_ms_runs=times["sync"],
                 fused_ms_runs=times["fused"],
                 launches_per_layer=per_layer,
                 k2_per_layer=counts["bn_stats"] / len(shapes),
                 k3_per_layer=counts["bn_bwd_stats"] / len(shapes),
                 against_fused=errs, against_cpu=cpu_errs,
                 issue_s=issue_s, behind_s=total_s, profile=profiles),
            counts)


def _traced_reduction(torch, fn, ok):
    """The host's CUDA runtime calls by name (a Counter) and the device
    operations as (name, us) of one ``fn()``: the active step of a
    torch.profiler schedule whose warm-up step runs ``fn()`` too (a trace
    started cold lost a replayed graph's kernels in most tries after the
    earlier phases' traces), each step padded with TRACE_PAD_S of idle host
    time on either side, traced again while ``ok(host, device)`` is false
    (lost events: trace_kernels)."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile, schedule
    cpu = torch.autograd.DeviceType.CPU
    seen = {}

    def read(prof):   # the active step's events, before they are cleared
        events = prof.events()
        seen["host"] = Counter(e.name for e in events
                               if e.device_type == cpu
                               and e.name.startswith("cu"))
        # the schedule's step annotation spans the step on the device too
        seen["device"] = [(e.name, e.time_range.elapsed_us())
                          for e in events if e.device_type != cpu
                          and not e.name.startswith("ProfilerStep")]

    for attempt in range(TRACE_TRIES):
        if attempt:
            time.sleep(TRACE_RETRY_S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=read) as prof:
            for _ in range(2):
                time.sleep(TRACE_PAD_S)
                fn()
                torch.cuda.synchronize()
                time.sleep(TRACE_PAD_S)
                prof.step()
        if ok(seen["host"], seen["device"]):
            break
        TRACE_LOST.append((attempt, len(seen["device"])))
    return seen["host"], seen["device"]


def _replay_rig(torch, hvd, eng, ResNet50, dev, batch):
    """Phase 15's ResNet-50 and its reduction: (params, backward() ->
    (loss, grads), eager(grads), reduce(grads, debug=True) inside
    ``hvd.step()``, apply(outs))."""
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, fused_bn=True,
                     generator=torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand(batch, 224, 224, 3, device=dev, generator=gen)
    labels = torch.randint(0, 1000, (batch,), device=dev, generator=gen)
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=0.01, momentum=0.9)
    model.train()
    names = iter(range(1 << 30))

    def backward():
        opt.zero_grad(set_to_none=True)  # fresh gradients: new addresses
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        return float(loss.detach()), [p.grad for p in params]

    def eager(grads):
        """The eager path on the same gradients (outside a step)."""
        return [h.synchronize() for h in eng.grouped_allreduce(
            grads, op=hvd.Average, postscale_factor=0.5)]

    def reduce(grads, debug=True):
        """The step's reduction; under the sync debug mode nothing may
        wait on the card."""
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with hvd.step():
                hs = hvd.grouped_allreduce_async(
                    grads, name=f"replay.g{next(names)}", op=hvd.Average,
                    postscale_factor=0.5)
            return [h.synchronize() for h in hs]
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def apply(outs):
        for p, g in zip(params, outs):
            p.grad = g
        opt.step()

    return params, backward, eager, reduce, apply


def _graph_trace_ok(n_buckets):
    return lambda h, d: sum("pack_kernel" in n for n, _ in d) == n_buckets


def replay_trace_child(torch, hvd, K, ResNet50, bucket_by_size, dev, batch):
    """Phase 15's replayed reduction traced in a fresh process
    (``--replay-trace``): the stream armed on the same ResNet-50, then one
    replayed reduction traced as ``_traced_reduction`` traces it in the
    main process. Prints its runtime calls, device operations, the replay
    counters' moves and the refused traces as the last line. A process
    with no earlier traces is the way round a profiler that lost a
    graph's K1 nodes in every in-process try."""
    from horovod_tpu_torch.core.state import engine
    hvd.init()
    try:
        eng = engine()
        rep = eng.replay
        _, backward, _, reduce, apply = _replay_rig(torch, hvd, eng,
                                                    ResNet50, dev, batch)
        for _ in range(eng.config.step_replay_warmup + 1):
            _, grads = backward()
            apply(reduce(grads, debug=False))
        check(rep.replayed_steps >= 1,
              "the fresh process's reduction never replayed")
        n_buckets = len(bucket_by_size(grads,
                                       eng.config.fusion_threshold_bytes))
        before = (rep.replayed_steps, rep.table_copies, rep.copy_outs,
                  K.launch_counts()["pack_graph"])
        host, device = _traced_reduction(
            torch, lambda: reduce(grads, debug=False),
            _graph_trace_ok(n_buckets))
        moved = [a - b for a, b in zip(
            (rep.replayed_steps, rep.table_copies, rep.copy_outs,
             K.launch_counts()["pack_graph"]), before)]
    finally:
        hvd.shutdown()
    print(json.dumps({"replay_trace": {
        "host": dict(host), "device": device, "buckets": n_buckets,
        "replays": moved[0], "table_copies": moved[1],
        "copy_outs": moved[2], "pack_graph": moved[3],
        "refused": len(TRACE_LOST)}}))
    return 0


def _fresh_graph_trace(n_buckets, log):
    """``--replay-trace`` in a child process: its trace of one replayed
    reduction (host calls, device operations) and its counters."""
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--replay-trace",
         "--package-root", os.path.dirname(os.path.dirname(
             os.path.abspath(sys.modules["horovod_tpu_torch"].__file__)))],
        capture_output=True, text=True, timeout=REPLAY_TRACE_TIMEOUT)
    tail = (res.stdout + res.stderr)[-4000:]
    check(res.returncode == 0,
          f"phase 15: the fresh process's trace exited {res.returncode}:"
          f"\n{tail}")
    got = json.loads(res.stdout.strip().splitlines()[-1])["replay_trace"]
    check(got["buckets"] == n_buckets and got["replays"] >= 1
          and got["table_copies"] == n_buckets * got["replays"]
          and got["copy_outs"] == n_buckets * got["replays"]
          and got["pack_graph"] == n_buckets * got["replays"],
          f"phase 15: the fresh process's traced reduction: {got}")
    log(f"  the replayed reduction traced in a fresh process: "
        f"{got['refused']} of its traces refused")
    from collections import Counter
    return Counter(got["host"]), [tuple(d) for d in got["device"]]


def run_replay_path(torch, hvd, K, ResNet50, bucket_by_size, dev, batch,
                    log):
    """Phase 15: ResNet-50's 161 gradients reduced inside ``hvd.step()``
    (``grouped_allreduce_async``, Average, postscale 0.5) between the
    backward and the SGD step: the warm-up steps record, the stream arms
    once, later steps replay as one CUDA graph (K1 once a bucket, the NCCL
    allreduce, the finish) with results bitwise the eager path's on the
    same gradients, a held result unchanged by the next replay, a divergent
    step (one gradient left out) falling back with correct values, and no
    host wait under the sync debug mode. Then a trace of one eager and one
    replayed reduction (runtime calls, device time), the host ms of the
    reduction each way, img/s with replay on and off in turns, peak
    memory. Returns (summary, launch counts)."""
    from horovod_tpu_torch.core.state import engine
    eng = engine()
    cfg, rep = eng.config, eng.replay
    check(hvd.size() == 1 and cfg.step_replay and cfg.pack_kernel,
          "phase 15 needs a size-1 world with replay and the pack kernel on")
    warm = cfg.step_replay_warmup
    torch.cuda.reset_peak_memory_stats(dev)
    params, backward, eager, reduce, apply = _replay_rig(
        torch, hvd, eng, ResNet50, dev, batch)

    def counters():
        return (rep.captured_streams, rep.replayed_steps, rep.fallbacks)

    start = counters()
    K.reset_launch_counts()
    steps, losses, held = 0, [], None
    for i in range(warm + REPLAY_CHECKED):
        loss, grads = backward()
        want = eager(grads)
        outs = reduce(grads)
        steps += 1
        check(len(outs) == len(grads) == 161
              and all(torch.equal(a, b) for a, b in zip(outs, want)),
              f"step {i}: the reduction differs from the eager path's")
        if held is not None:
            check(all(torch.equal(o, c) for o, c in held),
                  f"step {i}: a result held from the step before changed")
        held = [(o, o.clone()) for o in outs]
        got = tuple(a - b for a, b in zip(counters(), start))
        check(got == (int(i + 1 >= warm), max(0, i + 1 - warm), 0),
              f"step {i}: replay counters {got}")
        apply(outs)
        losses.append(loss)
    n_buckets = len(bucket_by_size(grads, cfg.fusion_threshold_bytes))
    # a divergent step: one gradient left out falls back to the eager path
    loss, grads = backward()
    before = counters()
    want = eager(grads[:-1])
    outs = reduce(grads[:-1])
    steps += 1
    check(all(torch.equal(a, b) for a, b in zip(outs, want))
          and counters() == (before[0], before[1], before[2] + 1),
          f"the divergent step: counters {before} -> {counters()}")
    apply(outs)
    losses.append(loss)
    # the next matching step replays again
    loss, grads = backward()
    before = counters()
    want = eager(grads)
    outs = reduce(grads)
    steps += 1
    check(all(torch.equal(a, b) for a, b in zip(outs, want))
          and counters() == (before[0], before[1] + 1, before[2]),
          f"the step after the divergent one did not replay: {counters()}")
    apply(outs)
    losses.append(loss)
    check(all(v == v and abs(v) != float("inf") for v in losses),
          f"non-finite loss in phase 15: {losses}")

    # one eager and one replayed reduction of the same gradients, traced
    replayed0 = rep.replayed_steps
    eager_host, eager_dev = _traced_reduction(
        torch, lambda: eager(grads),
        lambda h, d: sum("pack_kernel" in n for n, _ in d) == n_buckets)
    copies0 = (rep.table_copies, rep.copy_outs)
    lost0 = len(TRACE_LOST)
    graph_host, graph_dev = _traced_reduction(
        torch, lambda: reduce(grads, debug=False),
        _graph_trace_ok(n_buckets))
    replays = rep.replayed_steps - replayed0
    graph_trace = {"in_process_refused": len(TRACE_LOST) - lost0,
                   "path": "in process"}
    if not _graph_trace_ok(n_buckets)(graph_host, graph_dev):
        # every in-process try lost the graph's K1 nodes (the profiler's,
        # after the earlier phases' traces): the same reduction replayed
        # and traced in a fresh process, held to the same checks
        graph_trace["path"] = "fresh process"
        graph_host, graph_dev = _fresh_graph_trace(n_buckets, log)
    check(replays >= 1
          and rep.table_copies - copies0[0] == n_buckets * replays
          and rep.copy_outs - copies0[1] == n_buckets * replays,
          "the traced reductions were not replayed with one table copy and "
          "one copy-out a bucket")
    check(graph_host["cudaGraphLaunch"] == 1
          and sum(graph_host[k] for k in KERNEL_LAUNCH_CALLS) == 0,
          f"a replayed reduction's runtime calls: {dict(graph_host)}")
    check(sum("pack_kernel" in n for n, _ in graph_dev) == n_buckets,
          f"the graph's trace holds no K1 a bucket: {graph_dev}")
    nccl_eager = sum("nccl" in n.lower() for n, _ in eager_dev)
    nccl_graph = sum("nccl" in n.lower() for n, _ in graph_dev)
    check(nccl_graph == nccl_eager,
          f"NCCL operations: graph {nccl_graph}, eager {nccl_eager}")

    def split(device):
        """Device us of the kernels, the copies and the table refreshes."""
        out = {"kernels": 0.0, "copy_outs": 0.0, "table_copies": 0.0}
        for n, us in device:
            key = ("table_copies" if "HtoD" in n else "copy_outs"
                   if "DtoD" in n else "kernels")
            out[key] += us
        return {k: v / 1e3 for k, v in out.items()}

    launches = {mode: {k: v for k, v in host.items()
                       if "Launch" in k or "Memcpy" in k}
                for mode, host in (("eager", eager_host),
                                   ("replayed", graph_host))}
    dev_ms = {"eager": split(eager_dev), "replayed": split(graph_dev)}

    # host ms of the reduction phase, eager (replay off) against replayed,
    # on the same gradients in turns; the armed stream stays armed
    host_ms = {True: [], False: []}
    for _ in range(REPLAY_TIMED):
        for on in (False, True):
            cfg.step_replay = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reduce(grads, debug=False)
            host_ms[on].append(1e3 * (time.perf_counter() - t0))
    cfg.step_replay = True
    torch.cuda.synchronize()

    # img/s of the whole step with replay on and off, in turns
    windows = []
    for on in REPLAY_MODES:
        cfg.step_replay = on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPLAY_WINDOW_STEPS):
            _, grads = backward()
            apply(reduce(grads, debug=False))
        torch.cuda.synchronize()
        windows.append((on, batch * REPLAY_WINDOW_STEPS
                        / (time.perf_counter() - t0)))
        steps += REPLAY_WINDOW_STEPS
    cfg.step_replay = True
    counts = K.launch_counts()
    replayed = rep.replayed_steps - start[1]
    check(counts["pack_graph"] == n_buckets * replayed,
          f"K1 ran {counts['pack_graph']} times as a graph node, expected "
          f"{n_buckets} a replayed step ({replayed})")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rep.invalidate_all("phase 15 done")
    rates = {on: [r for m, r in windows if m == on] for on in (True, False)}
    summary = {
        "tensors": len(params), "buckets": n_buckets,
        "form": "one CUDA graph a step (K1, the NCCL collectives and the "
                "finish captured; ProcessGroupNCCL under capture)",
        "counters": tuple(a - b for a, b in zip(counters(), start)),
        "host_ms_eager": statistics.median(host_ms[False]),
        "host_ms_replayed": statistics.median(host_ms[True]),
        "host_ms_eager_range": (min(host_ms[False]), max(host_ms[False])),
        "host_ms_replayed_range": (min(host_ms[True]), max(host_ms[True])),
        "device_ms": dev_ms, "launches": launches,
        "nccl_ops": {"eager": nccl_eager, "graph": nccl_graph},
        "graph_kernels": sorted({n for n, _ in graph_dev}),
        "graph_trace": graph_trace,
        "img_per_s_on": statistics.mean(rates[True]),
        "img_per_s_off": statistics.mean(rates[False]),
        "windows": windows, "peak_gib": peak, "losses": losses,
        "steps": steps}
    log(f"  form: {summary['form']}")
    log(f"  counters (captured, replayed, fallbacks): {summary['counters']}; "
        f"{n_buckets} buckets of {len(params)} gradients")
    log(f"  host ms of the reduction: eager "
        f"{summary['host_ms_eager']:.3f} ({min(host_ms[False]):.3f}-"
        f"{max(host_ms[False]):.3f}), replayed "
        f"{summary['host_ms_replayed']:.3f} ({min(host_ms[True]):.3f}-"
        f"{max(host_ms[True]):.3f}), median of {REPLAY_TIMED}")
    log(f"  device ms: eager {dev_ms['eager']}, replayed {dev_ms['replayed']}"
        f"; NCCL operations eager {nccl_eager}, graph {nccl_graph}")
    log(f"  runtime calls: eager {launches['eager']}, replayed "
        f"{launches['replayed']}; graph kernels {summary['graph_kernels']}"
        f"; the graph's trace taken {graph_trace['path']} "
        f"({graph_trace['in_process_refused']} in-process traces refused)")
    log(f"  img/s: replay on {summary['img_per_s_on']:.1f}, off "
        f"{summary['img_per_s_off']:.1f} (windows: "
        f"{', '.join(f'{m}:{r:.1f}' for m, r in windows)}); peak memory "
        f"{peak:.2f} GiB")
    return summary, counts


def _state_bytes(torch, optimizer):
    return sum(v.nbytes for st in optimizer.state.values()
               for v in st.values() if torch.is_tensor(v))


def run_sharded_path(torch, hvd, K, tm, dev, log):
    """Phase 16: the flagship LM (AdamW) through
    ``DistributedOptimizer(sharded=True)`` at world size 1 (shard = total),
    against the dense ``DistributedOptimizer`` from the same seed over the
    same SHARDED_STEPS steps: the warm-up records, the stream arms, and the
    later steps replay the packs, the reduce-scatters and the finishes as
    one CUDA graph, the update and the all-gathers after it. The
    parameters bitwise the dense run's (else within 1e-6 of the largest
    entry), the losses finite and falling, K1's launches in padded mode and
    as graph nodes, a replayed step with no host wait, the host ms of the
    optimizer step eager against replayed, the graph's device ms, the
    runtime calls of a step each way, the optimizer-state bytes and the
    peak memory of both runs. Returns (summary, launch counts)."""
    from horovod_tpu_torch.core.state import engine
    eng = engine()
    cfg, rep = eng.config, eng.replay
    check(hvd.size() == 1 and cfg.step_replay and cfg.pack_kernel,
          "phase 16 needs a size-1 world with replay and the pack kernel on")
    warm = cfg.step_replay_warmup
    steps = warm + SHARDED_REPLAYED
    batch = 4

    torch.cuda.reset_peak_memory_stats(dev)
    _, dense, dense_step = make_lm_trainer(torch, hvd, tm, dev, batch,
                                           sharded=False)
    dense_losses = [float(dense_step()) for _ in range(steps)]
    dense_state = _state_bytes(torch, dense_step.opt.optimizer)
    dense_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # held on the host, so that the sharded run's peak is its own
    want = [p.detach().cpu() for p in dense.parameters()]
    del dense, dense_step
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    lm_cfg, model, step = make_lm_trainer(torch, hvd, tm, dev, batch,
                                          sharded=True)
    opt = step.opt
    start = (rep.captured_streams, rep.replayed_steps, rep.fallbacks)
    K.reset_launch_counts()
    losses, allocated = [], []
    for _ in range(steps):
        losses.append(float(step()))
        allocated.append(torch.cuda.memory_allocated(dev) / 2**30)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    got = tuple(a - b for a, b in zip(
        (rep.captured_streams, rep.replayed_steps, rep.fallbacks), start))
    check(got == (1, steps - warm, 0), f"replay counters {got}, expected "
          f"(1, {steps - warm}, 0)")
    zero = opt._zero
    n_buckets = len(zero.buckets)
    check(all(v == v and abs(v) != float("inf") for v in losses)
          and losses[-1] < losses[0],
          f"phase 16's losses are not finite and falling: {losses}")
    # K1 moved each bucket's parameters once, packed each eager step's
    # gradients in padded mode, and ran a graph node a bucket each
    # replayed step; K6 ran once a layer and step
    check(counts["pack_out"] == counts["pack"] == n_buckets * (1 + warm),
          f"K1 ran {counts['pack']} times, {counts['pack_out']} in padded "
          f"mode, expected {n_buckets * (1 + warm)}")
    check(counts["pack_graph"] == n_buckets * (steps - warm),
          f"K1 ran {counts['pack_graph']} times as a graph node, expected "
          f"{n_buckets * (steps - warm)}")
    for name in FLASH_KERNELS:
        check(counts[name] == lm_cfg.n_layers * steps,
              f"{name} launched {counts[name]} times in phase 16, expected "
              f"{lm_cfg.n_layers * steps}")
    with torch.no_grad():
        max_diff = max_entry = 0.0
        bitwise = True
        for p, q in zip(model.parameters(), want):
            q = q.to(dev)
            max_diff = max(max_diff, float((p - q).abs().max()))
            max_entry = max(max_entry, float(q.abs().max()))
            bitwise = bitwise and torch.equal(p, q)
    check(bitwise or max_diff <= 1e-6 * max_entry,
          f"the sharded parameters are {max_diff} from the dense ones "
          f"(largest entry {max_entry})")
    del want

    # a replayed step waits on nothing on the host
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # one eager and one replayed optimizer step, traced (the step re-runs
    # AdamW on the last gradients)
    ok = (lambda h, d: sum("pack_kernel" in n for n, _ in d) == n_buckets)
    cfg.step_replay = False
    eager_host, eager_dev = _traced_reduction(torch, opt.step, ok)
    cfg.step_replay = True
    graph_host, graph_dev = _traced_reduction(torch, opt.step, ok)
    check(graph_host["cudaGraphLaunch"] == 1
          and eager_host["cudaGraphLaunch"] == 0,
          f"graph launches: replayed {graph_host['cudaGraphLaunch']}, "
          f"eager {eager_host['cudaGraphLaunch']}")
    calls = {mode: {k: v for k, v in host.items()
                    if "Launch" in k or "Memcpy" in k}
             for mode, host in (("eager", eager_host),
                                ("replayed", graph_host))}
    # the device's operations, not the optimizer's annotation around them
    dev_ms = {mode: sum(us for n, us in d
                        if not n.startswith("Optimizer.")) / 1e3
              for mode, d in (("eager", eager_dev), ("replayed", graph_dev))}
    # host ms of the optimizer step, eager (replay off) against replayed,
    # in turns; the armed stream stays armed
    host_ms = {True: [], False: []}
    for _ in range(SHARDED_TIMED):
        for on in (False, True):
            cfg.step_replay = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            host_ms[on].append(1e3 * (time.perf_counter() - t0))
    cfg.step_replay = True
    torch.cuda.synchronize()
    # the graph alone (its table still points at the last gradients)
    program = next(e["armed"].program for e in rep._seen.values()
                   if e.get("armed") is not None)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    graph_ms, graph_host_ms = time_ms(torch, program.graph.replay, flush,
                                      SHARDED_TIMED)
    del flush
    state = zero.state_bytes()
    rep.invalidate_all("phase 16 done")
    summary = {
        "params": sum(p.numel() for p in model.parameters()),
        "buckets": n_buckets, "steps": steps,
        "shards": [(b.total, b.shard) for b in zero.buckets],
        "counters": got, "bitwise": bitwise, "max_diff": max_diff,
        "max_entry": max_entry, "losses": losses,
        "dense_losses": dense_losses,
        "k1_padded_launches": counts["pack_out"],
        "k1_graph_launches": counts["pack_graph"],
        "host_ms_eager": statistics.median(host_ms[False]),
        "host_ms_replayed": statistics.median(host_ms[True]),
        "host_ms_eager_range": (min(host_ms[False]), max(host_ms[False])),
        "host_ms_replayed_range": (min(host_ms[True]),
                                   max(host_ms[True])),
        "graph_ms": graph_ms, "graph_host_ms": graph_host_ms,
        "step_device_ms": dev_ms, "runtime_calls": calls,
        "step_kernels": sorted({n for n, _ in graph_dev}),
        "state_bytes": state, "dense_state_bytes": dense_state,
        "peak_gib": peak, "dense_peak_gib": dense_peak,
        "allocated_gib": allocated}
    log(f"  {summary['params'] / 1e6:.1f} M parameters in {n_buckets} "
        f"buckets; counters (captured, replayed, fallbacks) {got}")
    log(f"  parameters against the dense run: bitwise {bitwise}, largest "
        f"difference {max_diff:.3g} (largest entry {max_entry:.3g}); losses "
        f"{' '.join(f'{v:.4f}' for v in losses)} (dense "
        f"{' '.join(f'{v:.4f}' for v in dense_losses)})")
    log(f"  K1: {counts['pack_out']} launches in padded mode (the move and "
        f"the eager steps), {counts['pack_graph']} as graph nodes")
    log(f"  host ms of the optimizer step: eager "
        f"{summary['host_ms_eager']:.3f} ({min(host_ms[False]):.3f}-"
        f"{max(host_ms[False]):.3f}), replayed "
        f"{summary['host_ms_replayed']:.3f} ({min(host_ms[True]):.3f}-"
        f"{max(host_ms[True]):.3f}), median of {SHARDED_TIMED}; the graph "
        f"{graph_ms:.4f} ms on the device ({graph_host_ms:.4f} host)")
    log(f"  device ms of an optimizer step: {dev_ms}; runtime calls: "
        f"eager {calls['eager']}, replayed {calls['replayed']}")
    log(f"  optimizer state {state / 2**30:.3f} GiB (dense "
        f"{dense_state / 2**30:.3f}); peak memory {peak:.2f} GiB (dense "
        f"{dense_peak:.2f}); allocated after each step "
        f"{' '.join(f'{v:.2f}' for v in allocated)} GiB")
    return summary, counts


def _codec_step(torch, C, buckets, grads, residuals, codec, dev, use_kernel,
                collective=True):
    """One eager compressed reduction of every bucket of ``grads`` (lists
    of indices) on this world of one: K1 (or the plain pack) into a
    zero-tailed padded buffer, then ``codec_allreduce`` with the bucket's
    residual, updated in place. Returns per bucket (reduced prefix,
    payload, scale)."""
    out = []
    for idxs, res in zip(buckets, residuals):
        ts = [grads[i] for i in idxs]
        total = sum(t.numel() for t in ts)
        flat = C.padded_bucket(total, 1, ts[0].dtype, dev)
        C.pack_padded(ts, flat, use_kernel)
        payload, scale = C.codec_allreduce(flat, total, res, codec, 1, 0, 1,
                                           1.0, 1.0, None, collective)
        out.append((flat[:total], payload, scale))
    return out


def _codec_graph(torch, C, K, buckets, grads, residuals, codec, dev):
    """The whole compressed reduction as one CUDA graph, captured on a
    side stream into a private pool as step replay captures it: per
    bucket K1 from a PackTable into a zero-tailed padded buffer, then
    ``codec_allreduce`` on the bucket's residual. Returns (graph, tables,
    the reduced prefixes)."""
    tables = [K.PackTable([grads[i].numel() for i in idxs], torch.float32,
                          dev) for idxs in buckets]
    flats = []
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                            capture_error_mode="thread_local")
        try:
            for table, res in zip(tables, residuals):
                flat = C.padded_bucket(table.numel, 1, torch.float32, dev)
                table.capture(flat[:table.numel])
                C.codec_allreduce(flat, table.numel, res, codec, 1, 0, 1,
                                  1.0, 1.0, None)
                flats.append(flat[:table.numel])
        finally:
            graph.capture_end()
    return graph, tables, flats


def _codec_replay(torch, K, graph, tables, buckets, grads):
    for table, idxs in zip(tables, buckets):
        table.refresh([grads[i] for i in idxs])
    graph.replay()
    K.pack.graph_launches += len(tables)


def _capture_raises(torch, dev, fn, what: str) -> str:
    """A capture of ``fn()`` must raise (a program that cannot be captured
    fails the run; nothing falls back to an eager path), and the card must
    go on working after it. Returns the error."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
    except RuntimeError as e:
        torch.cuda.synchronize()
        check(float(torch.ones(4, device=dev).sum()) == 4.0,
              "the card failed after a refused capture")
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    raise SmokeFailure(f"a capture {what} did not raise")


def _capture_refuses_host_sync(torch, comp, dev) -> str:
    """A capture of the int8 encode with a host read of its scale in it."""
    x = torch.randn(1 << 20, device=dev)
    return _capture_raises(
        torch, dev, lambda: comp.ef_encode_(x, torch.zeros_like(x),
                                            "int8")[1].item(),
        "with a host sync in it")


def _bitwise(torch, a, b) -> bool:
    """Equal bits, whatever the dtype (fp8 has no equality kernel)."""
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def run_codec_path(torch, hvd, K, tm, bucket_by_size, dev, log):
    """Phase 17: the flagship LM's fp32 gradients (seeded, phase 16's 64 MB
    buckets) through the wire codecs' flat reduction
    (``collectives.codec_allreduce``) on the NCCL world of one (the
    engine resolves every codec to none at size 1, as the reference
    does, so the phase drives the reduction itself): for each codec,
    CODEC_EAGER eager steps (payloads, scales, residuals and results of
    the first and last bucket bitwise the plain path's on the CPU), the
    reduction captured as one CUDA graph and replayed CODEC_REPLAYED
    times on new gradients (results and residuals bitwise the eager path
    from the same residuals), a capture holding a host sync refused, and
    the times: encode and decode-sum device ms for the whole LM and a
    bucket beside their bytes bound, the device operations of a bucket's
    reduction, the host ms eager against replayed, the peak memory.
    Returns (summary, launch counts)."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import compression as comp
    check(hvd.size() == 1, "phase 17 needs a size-1 world")
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                               **LM_DIMS)
    shapes = [tuple(p.shape) for p in tm.Transformer(
        cfg, generator=torch.Generator().manual_seed(0)).parameters()]
    grads = [torch.empty(s, device=dev) for s in shapes]
    buckets = bucket_by_size(grads, 64 * 1024 * 1024)
    n_elems = sum(g.numel() for g in grads)
    checked = sorted({0, len(buckets) - 1})
    typical = next(b for b, idxs in enumerate(buckets)
                   if sum(grads[i].nbytes for i in idxs)
                   <= 64 * 1024 * 1024)
    gen = torch.Generator(device=dev)

    def fill(step):
        gen.manual_seed(1000 + step)
        for g in grads:
            g.normal_(generator=gen).mul_(1e-3)

    def totals(b):
        return sum(grads[i].numel() for i in buckets[b])

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    K.reset_launch_counts()
    summary = {"params": n_elems, "buckets": len(buckets),
               "bucket_elems": [totals(b) for b in range(len(buckets))],
               "checked_buckets": checked, "typical_bucket": typical,
               "codecs": {}}
    for codec in CODEC_CODECS:
        ef = codec in comp.EF_CODECS
        residuals = [torch.zeros(totals(b), device=dev) if ef else None
                     for b in range(len(buckets))]
        cpu_res = {b: torch.zeros(totals(b)) if ef else None
                   for b in checked}
        # the eager steps against the plain path on the CPU
        for step in range(CODEC_EAGER):
            fill(step)
            got = _codec_step(torch, C, buckets, grads, residuals, codec,
                              dev, True)
            for b in checked:
                ts = [grads[i].cpu() for i in buckets[b]]
                want = _codec_step(torch, C, [list(range(len(ts)))], ts,
                                   [cpu_res[b]], codec, torch.device("cpu"),
                                   False, collective=False)[0]
                for what, x, y in (("result", got[b][0], want[0]),
                                   ("payload", got[b][1], want[1]),
                                   ("scale", got[b][2], want[2]),
                                   ("residual", residuals[b], cpu_res[b])):
                    check(_bitwise(torch, None if x is None else x.cpu(),
                                   y),
                          f"{codec} step {step} bucket {b}: the {what} "
                          "is not bitwise the CPU's plain path")
            del got
        # the reduction as one graph, replayed on new gradients against the
        # eager path from the same residuals
        graph, tables, flats = _codec_graph(torch, C, K, buckets, grads,
                                            residuals, codec, dev)
        for step in range(CODEC_EAGER, CODEC_EAGER + CODEC_REPLAYED):
            fill(step)
            mirror = [None if r is None else r.clone() for r in residuals]
            want = _codec_step(torch, C, buckets, grads, mirror, codec, dev,
                               True)
            _codec_replay(torch, K, graph, tables, buckets, grads)
            for b in range(len(buckets)):
                check(torch.equal(flats[b], want[b][0])
                      and _bitwise(torch, residuals[b], mirror[b]),
                      f"{codec} replay {step}: bucket {b}'s result or "
                      "residual is not bitwise the eager path's")
            del want, mirror
        torch.cuda.synchronize()
        # host ms of the whole reduction, eager against replayed, in turns
        host_ms = {"eager": [], "replayed": []}
        for _ in range(CODEC_TIMED):
            for mode in ("eager", "replayed"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "eager":
                    _codec_step(torch, C, buckets, grads, residuals, codec,
                                dev, True)
                else:
                    _codec_replay(torch, K, graph, tables, buckets, grads)
                torch.cuda.synchronize()
                host_ms[mode].append(1e3 * (time.perf_counter() - t0))
        # the encode and the decode-sum alone, the whole LM and a bucket
        flats_in = [C.padded_bucket(totals(b), 1, torch.float32, dev)
                    for b in range(len(buckets))]
        for flat, idxs in zip(flats_in, buckets):
            K.pack_plain([grads[i] for i in idxs], out=flat)
        scratch = [None if r is None else r.clone() for r in residuals]
        enc = [comp.ef_encode_(f.clone(), r, codec)
               for f, r in zip(flats_in, scratch)]
        outs = [torch.empty_like(f) for f in flats_in]

        def encode(bs):
            return lambda: [comp.ef_encode_(flats_in[b], scratch[b], codec)
                            for b in bs]

        def decode(bs):
            return lambda: [comp.decode_sum(
                enc[b][0].view(1, -1), enc[b][1], codec, torch.float32,
                out=outs[b]) for b in bs]

        every = range(len(buckets))
        times = {}
        for name, fn in (("encode", encode), ("decode_sum", decode)):
            for scope, bs in (("lm", every), ("bucket", [typical])):
                ms, hms = time_ms(torch, fn(bs), flush, CODEC_REPS)
                per = (CODEC_ENCODE_BYTES if name == "encode"
                       else CODEC_DECODE_BYTES)[codec]
                elems = sum(totals(b) for b in bs)
                times[f"{name}_{scope}"] = {
                    "ms": ms, "host_ms": hms,
                    "bound_ms": bound(per * elems, 0, 1.0)[0],
                    "bound_by": "bytes", "bytes": per * elems}
        # the runtime calls and device operations of one bucket's eager
        # reduction (a trace may lose device events; the host's calls it
        # keeps)
        one = [buckets[typical]]
        calls, ops = _traced_reduction(
            torch, lambda: _codec_step(torch, C, one, grads,
                                       [scratch[typical]], codec, dev, True),
            lambda h, d: any("pack_kernel" in n for n, _ in d))
        calls = {k: v for k, v in calls.items()
                 if "Launch" in k or "Memcpy" in k or "Memset" in k}
        torch.cuda.synchronize()
        row = {"host_ms_eager": statistics.median(host_ms["eager"]),
               "host_ms_replayed": statistics.median(host_ms["replayed"]),
               "host_ms_eager_range": (min(host_ms["eager"]),
                                       max(host_ms["eager"])),
               "host_ms_replayed_range": (min(host_ms["replayed"]),
                                          max(host_ms["replayed"])),
               "bucket_runtime_calls": calls,
               "bucket_launches": sum(calls.values()),
               "bucket_device_ops": len(ops),
               "bucket_op_names": sorted({n for n, _ in ops}), **times}
        summary["codecs"][codec] = row
        t = times
        log(f"  {codec}: eager steps bitwise the CPU's (buckets {checked}),"
            f" {CODEC_REPLAYED} replays bitwise the eager path; encode "
            f"{t['encode_lm']['ms']:.3f} ms for the LM (bound "
            f"{t['encode_lm']['bound_ms']:.3f}, "
            f"{t['encode_lm']['bytes'] / 1e9:.2f} GB), "
            f"{t['encode_bucket']['ms']:.4f} a bucket; decode-sum "
            f"{t['decode_sum_lm']['ms']:.3f} (bound "
            f"{t['decode_sum_lm']['bound_ms']:.3f}), "
            f"{t['decode_sum_bucket']['ms']:.4f} a bucket; "
            f"{row['bucket_launches']} launches a bucket ({calls}; "
            f"{len(ops)} device operations traced); host ms eager "
            f"{row['host_ms_eager']:.3f} against replayed "
            f"{row['host_ms_replayed']:.3f}")
        del graph, tables, flats, flats_in, scratch, enc, outs, residuals
        torch.cuda.empty_cache()
    del flush, grads
    counts = K.launch_counts()
    summary["sync_capture_refused"] = _capture_refuses_host_sync(
        torch, comp, dev)
    log(f"  a capture holding a host sync raised: "
        f"{summary['sync_capture_refused']}")
    n_b = len(buckets)
    steps = len(CODEC_CODECS) * (CODEC_EAGER + CODEC_REPLAYED + CODEC_TIMED)
    check(counts["pack_out"] >= n_b * len(CODEC_CODECS) * CODEC_EAGER,
          f"K1 ran {counts['pack_out']} times in padded mode in phase 17")
    check(counts["pack_graph"] == n_b * len(CODEC_CODECS)
          * (CODEC_REPLAYED + CODEC_TIMED),
          f"K1 ran {counts['pack_graph']} times as a graph node in phase 17")
    summary["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    summary["k1_padded_launches"] = counts["pack_out"]
    summary["k1_graph_launches"] = counts["pack_graph"]
    summary["steps"] = steps
    log(f"  {n_elems / 1e6:.1f} M gradients in {n_b} buckets; K1 "
        f"{counts['pack_out']} launches in padded mode, "
        f"{counts['pack_graph']} as graph nodes; peak memory "
        f"{summary['peak_gib']:.2f} GiB")
    return summary, counts


def _algo_legs(C, form, cross):
    """One bucket's collectives under ``form`` on the world of one, the
    world group as the local group and ``cross`` (a second group of rank
    0) as the cross group: flat one ``all_reduce``, tree a pair round on
    each group, the ladder's four legs."""
    import torch.distributed as dist
    if form == "flat":
        return lambda flat: dist.all_reduce(flat)
    if form == "tree":
        return lambda flat: C.tree_allreduce(flat, [None, cross])
    return lambda flat: C.hier_allreduce(flat, None, cross, 1, 1)


def _algo_eager(torch, C, buckets, grads, legs, dev):
    """Every bucket packed by K1 into a padded buffer (``out=``) and
    reduced by ``legs``; returns the reduced buffers."""
    outs = []
    for idxs in buckets:
        ts = [grads[i] for i in idxs]
        flat = C.padded_bucket(sum(t.numel() for t in ts), 1, ts[0].dtype,
                               dev)
        C.pack_padded(ts, flat, True)
        legs(flat)
        outs.append(flat)
    return outs


def _algo_graph(torch, C, K, buckets, grads, legs, dev):
    """The same as one CUDA graph captured on a side stream into a private
    pool, as step replay captures it: per bucket K1 from a PackTable into
    a padded buffer, then the legs. Returns (graph, tables, buffers)."""
    tables = [K.PackTable([grads[i].numel() for i in idxs], grads[0].dtype,
                          dev) for idxs in buckets]
    flats = []
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                            capture_error_mode="thread_local")
        try:
            for table in tables:
                flat = C.padded_bucket(table.numel, 1, grads[0].dtype, dev)
                table.capture(flat[:table.numel])
                legs(flat)
                flats.append(flat)
        finally:
            graph.capture_end()
    return graph, tables, flats


def _cold_capture_refused(torch, dev) -> str:
    """A capture holding a collective on a group whose NCCL communicator was
    never created (it cannot be created inside a capture)."""
    import torch.distributed as dist
    cold = dist.new_group([0])
    x = torch.ones(1024, device=dev)
    return _capture_raises(torch, dev,
                           lambda: dist.all_reduce(x, group=cold),
                           "on a communicator never initialised")


def run_algo_path(torch, hvd, K, tm, ResNet50, bucket_by_size, dev, log):
    """Phase 18: the collective algorithms on the NCCL world of one. First
    ResNet-50's 161 gradients through the engine's ``grouped_allreduce``
    (Average, postscale 0.5) under each value of
    HOROVOD_TPU_COLLECTIVE_ALGO (``engine.config.collective_algo``, read
    per call): every bucket resolves to flat, a forced tree or
    hierarchical form warns once, and every form's results, K1 launches
    and collectives are bitwise and count for count the unforced run's.
    Then the flagship LM's fp32 gradients in 64 MB buckets through the
    reducers of ``ops/collectives.py`` directly, the world group as the
    local group and a second group of rank 0 as the cross group (two NCCL
    communicators): flat, the tree's pair rounds and the ladder's four
    legs, each ALGO_EAGER times eagerly (K1 in padded mode, bitwise the
    flat reduction's), captured as one CUDA graph and replayed
    ALGO_REPLAYED times on new gradients (bitwise the eager path's); the
    two-phase alltoall of a (4096, 2048) bf16 block the same way against
    the flat ``all_to_all_single``; a capture on a communicator never
    initialised refused. Prints each form's device ms for the whole LM
    (eager and replayed) against the flat reduction's, the launches of
    one bucket's reduction (K1 and the NCCL legs) and the peak memory.
    Returns (summary, launch counts)."""
    import collections
    import logging
    import torch.distributed as dist
    from horovod_tpu_torch.core.state import engine
    from horovod_tpu_torch.ops import collectives as C
    eng = engine()
    cfg = eng.config
    check(hvd.size() == 1 and cfg.pack_kernel,
          "phase 18 needs a size-1 world with the pack kernel on")
    torch.cuda.reset_peak_memory_stats(dev)
    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "using flat" in record.getMessage():
                warned.append(record.getMessage())

    catch = Catch()
    logging.getLogger("horovod_tpu_torch").addHandler(catch)
    K.reset_launch_counts()
    summary = {"resnet": {}, "lm": {}, "alltoall": {}}
    # the engine at size 1 under every value of the knob
    gen = torch.Generator(device=dev).manual_seed(18)
    params = ResNet50(num_classes=1000, dtype=torch.bfloat16, fused_bn=True,
                      generator=torch.Generator().manual_seed(0)).parameters()
    grads = [torch.randn(p.shape, dtype=p.dtype, device=dev, generator=gen)
             for p in params]
    n_buckets = len(bucket_by_size(grads, cfg.fusion_threshold_bytes))
    base = None
    try:
        for form in ALGO_FORMS:
            cfg.collective_algo = form
            sel = collections.Counter(eng.algo_selections)
            packs, d0, w0 = K.launch_counts()["pack"], eng.dispatch_count, \
                len(warned)
            outs = [h.synchronize() for h in eng.grouped_allreduce(
                grads, name="algo.resnet", op=hvd.Average,
                postscale_factor=0.5)]
            torch.cuda.synchronize()
            row = {"selections": {f"{k}/{a}": v for (k, a), v in
                                  (eng.algo_selections - sel).items()},
                   "k1": K.launch_counts()["pack"] - packs,
                   "collectives": eng.dispatch_count - d0,
                   "warnings": warned[w0:]}
            check(row["selections"] == {"allreduce/flat": n_buckets},
                  f"phase 18 {form}: buckets resolved {row['selections']}")
            check(len(row["warnings"]) == (form in ("tree", "hierarchical")),
                  f"phase 18 {form}: warnings {row['warnings']}")
            if base is None:
                base = (outs, row["k1"], row["collectives"])
            else:
                check(all(torch.equal(a, b) for a, b in zip(outs, base[0])),
                      f"phase 18 {form}: results not bitwise the unforced "
                      "run's")
                check((row["k1"], row["collectives"]) == base[1:],
                      f"phase 18 {form}: {row['k1']} K1 launches and "
                      f"{row['collectives']} collectives against "
                      f"{base[1:]}")
            summary["resnet"][form] = row
            log(f"  ResNet-50, {form}: {n_buckets} buckets "
                f"{row['selections']}, K1 {row['k1']}, collectives "
                f"{row['collectives']}, warnings {len(row['warnings'])}")
    finally:
        cfg.collective_algo = "auto"
        logging.getLogger("horovod_tpu_torch").removeHandler(catch)
    del grads, base, outs
    # the reducers directly on the flagship LM's gradients
    lm = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                              **LM_DIMS)
    shapes = [tuple(p.shape) for p in tm.Transformer(
        lm, generator=torch.Generator().manual_seed(0)).parameters()]
    grads = [torch.empty(s, device=dev) for s in shapes]
    buckets = bucket_by_size(grads, 64 * 1024 * 1024)
    lm_gen = torch.Generator(device=dev)

    def fill(step):
        lm_gen.manual_seed(1800 + step)
        for g in grads:
            g.normal_(generator=lm_gen).mul_(1e-3)

    cross = dist.new_group([0])
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    want = {}
    for form in ("flat", "tree", "ladder"):
        legs = _algo_legs(C, form, cross)
        for step in range(ALGO_EAGER):
            fill(step)
            got = _algo_eager(torch, C, buckets, grads, legs, dev)
            if form == "flat":
                want[step] = got
            else:
                check(all(torch.equal(a, b) for a, b in zip(got,
                                                            want[step])),
                      f"phase 18 {form} step {step}: not bitwise the flat "
                      "reduction's")
            del got
        graph, tables, flats = _algo_graph(torch, C, K, buckets, grads, legs,
                                           dev)
        for step in range(ALGO_EAGER, ALGO_EAGER + ALGO_REPLAYED):
            fill(step)
            eager = _algo_eager(torch, C, buckets, grads, legs, dev)
            for table, idxs in zip(tables, buckets):
                table.refresh([grads[i] for i in idxs])
            graph.replay()
            K.pack.graph_launches += len(tables)
            check(all(torch.equal(a, b) for a, b in zip(flats, eager)),
                  f"phase 18 {form} replay {step}: not bitwise the eager "
                  "path's")
            del eager

        def replayed():
            for table, idxs in zip(tables, buckets):
                table.refresh([grads[i] for i in idxs])
            graph.replay()
            K.pack.graph_launches += len(tables)

        ms, host_ms = time_ms(torch, lambda: _algo_eager(
            torch, C, buckets, grads, legs, dev), flush, ALGO_REPS)
        graph_ms, graph_host_ms = time_ms(torch, replayed, flush, ALGO_REPS)
        one = [buckets[0]]
        calls, ops = _traced_reduction(
            torch, lambda: _algo_eager(torch, C, one, grads, legs, dev),
            lambda h, d: any("pack_kernel" in n for n, _ in d))
        launches = sum(v for k, v in calls.items()
                       if k in KERNEL_LAUNCH_CALLS)
        summary["lm"][form] = {
            "ms": ms, "host_ms": host_ms, "graph_ms": graph_ms,
            "graph_host_ms": graph_host_ms,
            "bucket_launches": launches,
            "bucket_device_ops": sorted(n for n, _ in ops),
            "bucket_runtime_calls": {k: v for k, v in calls.items()
                                     if "Launch" in k or "Memcpy" in k
                                     or "Memset" in k}}
        log(f"  LM, {form}: {len(buckets)} buckets, {ALGO_EAGER} eager "
            f"reductions bitwise the flat one's, {ALGO_REPLAYED} replays "
            f"bitwise the eager path; device ms {ms:.3f} eager, "
            f"{graph_ms:.3f} replayed; a bucket: {launches} kernel "
            f"launches, device operations {summary['lm'][form]['bucket_device_ops']}")
        del graph, tables, flats
        torch.cuda.empty_cache()
    del want, flush
    # the graphs' device time: the eager reductions' is the host's time to
    # launch them
    for form in ("tree", "ladder"):
        summary["lm"][form]["vs_flat"] = (summary["lm"][form]["graph_ms"]
                                          / summary["lm"]["flat"]["graph_ms"])
    # the two-phase alltoall against the flat one
    x = torch.empty(ALGO_A2A_SHAPE, dtype=torch.bfloat16, device=dev)
    a2a_gen = torch.Generator(device=dev)

    def fill_x(step):
        a2a_gen.manual_seed(1850 + step)
        x.normal_(generator=a2a_gen)

    def flat_a2a():
        out = torch.empty_like(x)
        C.all_to_all(out, x, [x.shape[0]], [x.shape[0]], None)
        return out

    def two_phase():
        return C.hier_alltoall(x, None, cross, 1, 1)

    for step in range(ALGO_EAGER):
        fill_x(step)
        check(torch.equal(two_phase(), flat_a2a()),
              f"phase 18 alltoall step {step}: not bitwise the flat one's")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                            capture_error_mode="thread_local")
        try:
            captured = two_phase()
        finally:
            graph.capture_end()
    for step in range(ALGO_EAGER, ALGO_EAGER + ALGO_REPLAYED):
        fill_x(step)
        graph.replay()
        check(torch.equal(captured, two_phase())
              and torch.equal(captured, flat_a2a()),
              f"phase 18 alltoall replay {step}: not bitwise the eager path")
    a2a_flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                            device=dev)
    for name, fn in (("flat", flat_a2a), ("two_phase", two_phase),
                     ("two_phase_graph", graph.replay)):
        ms, host_ms = time_ms(torch, fn, a2a_flush, ALGO_REPS)
        summary["alltoall"][name] = {"ms": ms, "host_ms": host_ms}
    del graph, captured, a2a_flush, x
    log(f"  alltoall {ALGO_A2A_SHAPE} bf16: {ALGO_EAGER} eager and "
        f"{ALGO_REPLAYED} replayed two-phase exchanges bitwise the flat "
        f"one; device ms flat {summary['alltoall']['flat']['ms']:.4f}, "
        f"two-phase {summary['alltoall']['two_phase']['ms']:.4f}, "
        f"replayed {summary['alltoall']['two_phase_graph']['ms']:.4f}")
    summary["cold_capture_refused"] = _cold_capture_refused(torch, dev)
    log(f"  a capture on a communicator never initialised raised: "
        f"{summary['cold_capture_refused']}")
    counts = K.launch_counts()
    n_b = len(buckets)
    check(counts["pack_out"] >= 3 * n_b * (ALGO_EAGER + ALGO_REPLAYED),
          f"K1 ran {counts['pack_out']} times in padded mode in phase 18")
    check(counts["pack_graph"] >= 3 * n_b * ALGO_REPLAYED,
          f"K1 ran {counts['pack_graph']} times as a graph node in phase 18")
    summary["buckets"] = n_b
    summary["params"] = sum(g.numel() for g in grads)
    summary["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    summary["k1_launches"] = counts["pack"]
    summary["k1_padded_launches"] = counts["pack_out"]
    summary["k1_graph_launches"] = counts["pack_graph"]
    log(f"  {summary['params'] / 1e6:.1f} M gradients in {n_b} buckets; "
        f"tree/flat {summary['lm']['tree']['vs_flat']:.3f}, ladder/flat "
        f"{summary['lm']['ladder']['vs_flat']:.3f} of the graph's device "
        f"time; K1 {counts['pack']} launches ({counts['pack_out']} in "
        f"padded mode, {counts['pack_graph']} as graph nodes); peak "
        f"memory {summary['peak_gib']:.2f} GiB")
    del grads
    return summary, counts


def obs_env(arm: str, out_dir: str) -> dict:
    """The knobs of one observability arm (phase 19): ``defaults`` sets
    none, ``off`` turns every instrument off, ``all`` adds the timeline,
    the metrics file and the consistency check to the defaults, ``on``
    (the synchronization check's) the timeline and the metrics file."""
    if arm == "off":
        return dict(OBS_OFF)
    if arm == "defaults":
        return {}
    env = {"HOROVOD_TIMELINE": os.path.join(out_dir, "timeline.json"),
           "HOROVOD_TPU_METRICS_FILE": os.path.join(out_dir,
                                                    "metrics.jsonl"),
           "HOROVOD_TPU_METRICS_INTERVAL": "3600",
           "HOROVOD_TPU_TRACE_DUMP_DIR": out_dir}
    if arm == "all":
        env["HOROVOD_TPU_DEBUG_CONSISTENCY"] = "1"
    return env


@contextlib.contextmanager
def obs_world(hvd, arm: str, out_dir: str, dev):
    """A world on ``dev`` initialised under ``arm``'s knobs, the
    environment restored after it (the knobs are read at init)."""
    saved = {k: os.environ.get(k) for k in OBS_KNOBS}
    for k in OBS_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(obs_env(arm, out_dir))
    hvd.init(dev)
    try:
        yield hvd.global_state()
    finally:
        hvd.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def obs_reduction(torch, hvd, grads, tag):
    """ResNet-50's reduction as phase 15 issues it: one step's grouped
    Average, postscale 0.5, inside ``hvd.step()``."""
    with hvd.step():
        hs = hvd.grouped_allreduce_async(grads, name=tag, op=hvd.Average,
                                         postscale_factor=0.5)
    return [h.synchronize() for h in hs]


def obs_counted_steps(torch, hvd, grads, tag):
    """OBS_EAGER + OBS_REPLAYED steps of the reduction under
    ``set_sync_debug_mode("warn")``: returns the synchronizations the
    steps raised (warnings) and the replay counters' moves."""
    import warnings
    rep = hvd.global_state().engine.replay
    before = (rep.captured_streams, rep.replayed_steps, rep.fallbacks)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(OBS_EAGER + OBS_REPLAYED):
                obs_reduction(torch, hvd, grads, f"{tag}.{i}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the sync debug mode's warning for each synchronizing call (its
    # notice that the mode is a prototype is not one)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    moved = tuple(a - b for a, b in zip(
        (rep.captured_streams, rep.replayed_steps, rep.fallbacks), before))
    return syncs, moved


def run_observability_checks(torch, hvd, shapes, dev, log):
    """Phase 19's checks on the main process's card: the synchronization
    count with the instruments on against off, and the instrumented run's
    outputs (timeline, wire bytes, memory gauge, flight dump)."""
    import tempfile
    from horovod_tpu_torch.trace import load_trace_file
    gen = torch.Generator(device=dev).manual_seed(19)
    grads = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    nbytes = sum(g.nbytes for g in grads)
    out = {"tensors": len(grads), "grad_bytes": nbytes}
    with tempfile.TemporaryDirectory() as tmp:
        with obs_world(hvd, "on", tmp, dev) as gs:
            snap0 = hvd.metrics_snapshot()
            syncs_on, moved = obs_counted_steps(torch, hvd, grads, "obs.on")
            snap1 = hvd.metrics_snapshot()
            native = gs.timeline.native_active
            # the memory gauge against the allocator's own numbers, read
            # at the same sample (nothing allocates between the two)
            torch.cuda.synchronize()
            stats = gs.hbm_sampler.sample()
            mem = torch.cuda.memory_stats(dev)
            gauge = {k: v for labels, v in hvd.metrics_snapshot()[
                "gauges"]["hvd_tpu_hbm_bytes"]["values"]
                for k in (labels["kind"],)}
            dump = gs._dump_flight_ring()
            dumped = load_trace_file(dump)
        events = json.load(open(os.path.join(tmp, "timeline.json")))
        jsonl = open(os.path.join(tmp, "metrics.jsonl")).read().splitlines()

    def wire(snap):
        ent = snap["counters"]["hvd_tpu_wire_bytes_total"]["values"]
        return sum(v for labels, v in ent
                   if labels["kind"] == "grouped_allreduce")

    steps = OBS_EAGER + OBS_REPLAYED
    check(moved == (1, OBS_REPLAYED, 0),
          f"phase 19: replay counters moved {moved}, expected "
          f"(1, {OBS_REPLAYED}, 0)")
    replayed = moved[1]
    eager = steps - replayed
    out["counters"] = moved
    out["wire_bytes"] = wire(snap1) - wire(snap0)
    check(out["wire_bytes"] == nbytes * steps,
          f"phase 19: wire bytes {out['wire_bytes']}, expected "
          f"{nbytes} x {steps}")
    out["native_timeline"] = native
    check(native, "phase 19: the native timeline writer did not load")
    names = [e.get("name") for e in events]
    spans = {"GROUPED_ALLREDUCE": names.count("GROUPED_ALLREDUCE"),
             "XLA_DISPATCH": names.count("XLA_DISPATCH"),
             "REPLAY": names.count("REPLAY"),
             "XLA_REPLAY_DISPATCH": names.count("XLA_REPLAY_DISPATCH"),
             "REPLAY_CAPTURE": names.count("REPLAY_CAPTURE"),
             "REPLAY_REPLAY": names.count("REPLAY_REPLAY")}
    out["timeline_events"] = len(events)
    out["timeline_spans"] = spans
    check(spans["GROUPED_ALLREDUCE"] == len(grads) * eager
          and spans["XLA_DISPATCH"] == len(grads) * eager
          and spans["REPLAY"] == replayed
          and spans["XLA_REPLAY_DISPATCH"] == replayed,
          f"phase 19: timeline spans {spans} for {eager} eager and "
          f"{replayed} replayed steps of {len(grads)} tensors")
    depth = {}
    for e in events:
        if e.get("ph") in ("B", "E"):
            depth[e["tid"]] = depth.get(e["tid"], 0) + (
                1 if e["ph"] == "B" else -1)
    check(not any(depth.values()) and {e.get("pid") for e in events} == {0},
          "phase 19: the timeline's spans are not balanced on pid 0")
    out["hbm"] = {k: gauge.get(k) for k in ("in_use", "peak", "limit")}
    want = {"in_use": mem["allocated_bytes.all.current"],
            "peak": mem["allocated_bytes.all.peak"],
            "limit": torch.cuda.get_device_properties(dev).total_memory}
    check(stats is not None and all(out["hbm"][k] == float(want[k])
                                    for k in want),
          f"phase 19: hvd_tpu_hbm_bytes {out['hbm']} against "
          f"torch.cuda.memory_stats {want}")
    out["flight_dump_events"] = len(dumped)
    check(any(e.get("name") == "REPLAY" for e in dumped)
          and any(e.get("name") == "GROUPED_ALLREDUCE" for e in dumped),
          "phase 19: the flight dump holds no reduction span")
    out["metrics_jsonl_records"] = len(jsonl)
    check(len(jsonl) >= 1 and "hvd_tpu_wire_bytes_total" in json.loads(
        jsonl[-1])["metrics"]["counters"],
          "phase 19: the metrics file holds no final record")
    out["syncs_on"] = len(syncs_on)
    out["sync_samples"] = syncs_on[:3]
    log(f"  instrumented: replay counters moved {moved}, wire bytes "
        f"{out['wire_bytes']} = {nbytes} x {steps}, native timeline "
        f"{native}, {len(events)} timeline events, spans {spans}, "
        f"hvd_tpu_hbm_bytes {out['hbm']} = memory_stats, flight dump "
        f"{len(dumped)} events, {len(jsonl)} metrics record(s)")
    log(f"  synchronizations of its {steps} steps under the sync debug "
        f"mode: {len(syncs_on)}")
    return out


def obs_child(torch, hvd, tm, ResNet50, dev, arm, shapes, log):
    """One overhead process of phase 19 (``--obs-arm ARM``, launched with
    the arm's knobs already in its environment): the LM's tokens/s,
    ResNet-50's img/s and the host ms of phase 15's reduction eager and
    replayed. Prints one JSON line as its last."""
    hvd.init()
    try:
        lm_cfg, lm, lm_step = make_lm_trainer(torch, hvd, tm, dev, 4)
        tokens = 4 * lm_cfg.max_seq
        _, tok_s, tok_rates = train(torch, lm_step, tokens, 2,
                                    LM_WINDOW_STEPS, OBS_LM_WINDOWS,
                                    lambda *a: None)
        del lm, lm_step
        torch.cuda.empty_cache()
        _, step = make_trainer(torch, hvd, ResNet50, dev, 64)
        _, img_s, img_rates = train(torch, step, 64, 3, 10,
                                    OBS_RESNET_WINDOWS, lambda *a: None)
        del step
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(19)
        grads = [torch.randn(s, device=dev, generator=gen) for s in shapes]
        eng = hvd.global_state().engine
        # the warm-up and the first replays, counting synchronizations
        syncs, moved = obs_counted_steps(torch, hvd, grads, "obs.w")
        host = {True: [], False: []}
        for i in range(OBS_HOST_TIMED):
            for on in (False, True):
                eng.config.step_replay = on
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                obs_reduction(torch, hvd, grads, f"obs.t{i}")
                host[on].append(1e3 * (time.perf_counter() - t0))
        eng.config.step_replay = True
        torch.cuda.synchronize()
        armed = eng.replay.captured_streams > 0
    finally:
        hvd.shutdown()
    print(json.dumps({
        "arm": arm, "tokens_per_s": tok_s, "tokens_per_s_windows": tok_rates,
        "img_per_s": img_s, "img_per_s_windows": img_rates,
        "host_ms_eager": statistics.median(host[False]),
        "host_ms_replayed": statistics.median(host[True]),
        "host_ms_eager_range": (min(host[False]), max(host[False])),
        "host_ms_replayed_range": (min(host[True]), max(host[True])),
        "armed": armed, "replay_counters": moved, "syncs": len(syncs),
        "sync_samples": syncs[:3]}), flush=True)
    return 0


def run_observability_overhead(log):
    """Phase 19's overhead: OBS_ROUNDS rounds of one fresh process per arm
    (each arm's turn rotating round to round), each running ``obs_child``
    with the arm's knobs; the medians and ranges of each arm. The knobs
    are read at init, so each arm needs its own process."""
    import tempfile
    rows = {arm: [] for arm in OBS_ARMS}
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(OBS_ROUNDS):
            order = OBS_ARMS[r % 3:] + OBS_ARMS[:r % 3]
            for arm in order:
                env = {k: v for k, v in os.environ.items()
                       if k not in OBS_KNOBS}
                env.update(obs_env(arm, tmp))
                t0 = time.perf_counter()
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--obs-arm", arm], env=env, capture_output=True,
                    text=True, timeout=600)
                check(res.returncode == 0,
                      f"phase 19: the {arm} process exited "
                      f"{res.returncode}:\n{res.stdout[-2000:]}"
                      f"{res.stderr[-3000:]}")
                row = json.loads(res.stdout.strip().splitlines()[-1])
                row["process_s"] = time.perf_counter() - t0
                rows[arm].append(row)
                log(f"  round {r} {arm}: {json.dumps(row)}")
    summary = {}
    for arm, rs in rows.items():
        ent = {}
        for key in ("tokens_per_s", "img_per_s", "host_ms_eager",
                    "host_ms_replayed"):
            vals = [x[key] for x in rs]
            ent[key] = statistics.median(vals)
            ent[key + "_range"] = (min(vals), max(vals))
        ent["armed"] = [x["armed"] for x in rs]
        ent["syncs"] = [x["syncs"] for x in rs]
        summary[arm] = ent
    base = summary["off"]
    check(all(n <= min(base["syncs"]) for arm in ("defaults", "all")
              for n in summary[arm]["syncs"]),
          f"phase 19: the instruments added synchronizations: "
          f"{ {arm: s['syncs'] for arm, s in summary.items()} }")
    for arm in ("defaults", "all"):
        s = summary[arm]
        s["tokens_per_s_vs_off"] = s["tokens_per_s"] / base["tokens_per_s"] - 1
        s["img_per_s_vs_off"] = s["img_per_s"] / base["img_per_s"] - 1
        s["host_ms_eager_added"] = s["host_ms_eager"] - base["host_ms_eager"]
        s["host_ms_replayed_added"] = (s["host_ms_replayed"]
                                       - base["host_ms_replayed"])
    for arm, s in summary.items():
        log(f"  {arm}: tokens/s {s['tokens_per_s']:.1f} "
            f"({s['tokens_per_s_range'][0]:.1f}-"
            f"{s['tokens_per_s_range'][1]:.1f}), img/s "
            f"{s['img_per_s']:.1f} ({s['img_per_s_range'][0]:.1f}-"
            f"{s['img_per_s_range'][1]:.1f}), host ms eager "
            f"{s['host_ms_eager']:.3f} ({s['host_ms_eager_range'][0]:.3f}-"
            f"{s['host_ms_eager_range'][1]:.3f}), replayed "
            f"{s['host_ms_replayed']:.3f} "
            f"({s['host_ms_replayed_range'][0]:.3f}-"
            f"{s['host_ms_replayed_range'][1]:.3f}), armed {s['armed']}, "
            f"synchronizations of {OBS_EAGER + OBS_REPLAYED} steps "
            f"{s['syncs']}")
    return {"arms": summary, "rounds": OBS_ROUNDS, "rows": rows}


def _sync_count(torch, fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``: its result and the
    synchronizing calls it made."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]


def _adamw(torch, params):
    # optax.adamw(3e-4)'s settings, as phase 5
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _finite_falling(losses) -> bool:
    return (all(v == v and abs(v) != float("inf") for v in losses)
            and losses[-1] < losses[0])


def run_moe_path(torch, hvd, K, tm, dev, smi, log):
    """Phase 20: the tensor axis's paths on one card at world size 1, on
    the flagship LM's widths (``LM_DIMS``, batch ``MOE_BATCH``, bf16 on
    fp32 parameters, AdamW, ``attention="flash"``) with the MoE FFN of
    ``MOE_EXPERTS`` experts at capacity factor ``MOE_FACTOR``:

    (a) ``make_moe_ep_train_step`` from the same weights ``MOE_STEPS``
        steps with replay off, then as many with it on (``MOE_WARM``
        warm-up steps, then every exchange a replayed CUDA graph): the
        losses finite and falling, the replayed run's bitwise the eager
        one's; K6's launches (one of each kernel a layer and step) and the
        graph launches of a replayed step (4·L); the host synchronizations
        of a replayed step; the routing skew; tokens/s of the replayed
        steps; peak memory;
    (b) ``make_train_step`` on the (1, 1, 1) mesh with the MoE FFN: the
        losses finite and falling, its first within 2e-2 of (a)'s (fp32
        logits against (a)'s bf16 ones);
    (c) the dense flagship through ``make_train_step`` on (1, 1, 1)
        against ``DistributedOptimizer`` on the same loss from the same
        weights: the parameters bitwise, or within 1e-6 of each one's
        largest entry; then the dense step of ``lean_lm_loss`` timed for
        ``moe_ep_vs_dense`` (bench.py:1029-1032: the dense step's time
        over the MoE-EP step's at matched active parameters, one d_ff FFN
        a token).

    Returns the phase's summary and its K6 and K1 launches."""
    from horovod_tpu_torch.parallel.mesh import training_mesh
    t_phase = time.perf_counter()
    eng = hvd.global_state().engine
    check(hvd.size() == 1, "phase 20 needs a size-1 world")
    cfg = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                               use_moe=True, n_experts=MOE_EXPERTS,
                               moe_capacity_factor=MOE_FACTOR, **LM_DIMS)
    L, T, B = cfg.n_layers, cfg.max_seq, MOE_BATCH
    gen = torch.Generator(device=dev).manual_seed(20)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), device=dev,
                           generator=gen)
    x, y = tokens[:, :-1], tokens[:, 1:]
    model = tm.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if n.endswith((".w1", ".w2")))
    shared, expert = tm.moe_ep_partition(model, 0, 1, cfg)
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    log(f"  MoE LM: {n_params / 1e9:.3f} G parameters ({n_expert / 1e9:.3f}"
        f" G in the experts; {len(shared)} shared and {len(expert)} expert "
        f"leaves), B{B} T{T}, E{MOE_EXPERTS} top-1, capacity factor "
        f"{MOE_FACTOR} ({smi})")
    out = {"parameters": n_params, "expert_parameters": n_expert,
           "card": smi}
    counts = {}

    def ep_run(replay):
        model.load_state_dict(state0)
        eng.config.step_replay = replay
        eng.replay.invalidate_all(f"phase 20 ({'replay' if replay else 'eager'})")
        opt = _adamw(torch, model.parameters())
        step = tm.make_moe_ep_train_step(eng, cfg, opt)
        losses, ms, marks = [], [], []
        for _ in range(MOE_STEPS):
            d0, r0 = eng.dispatch_count, eng.replay.replayed_steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(model, x, y)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            marks.append((eng.dispatch_count - d0,
                          eng.replay.replayed_steps - r0))
        return step, losses, ms, marks

    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    _, eager, eager_ms, _ = ep_run(False)
    counts["eager"] = K.launch_counts()
    K.reset_launch_counts()
    step, replayed, rep_ms, marks = ep_run(True)
    counts["replay"] = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # one more replayed step, its synchronizations counted
    d0 = eng.dispatch_count
    loss, syncs = _sync_count(torch, lambda: step(model, x, y))
    sync_dispatches = eng.dispatch_count - d0
    eng.config.step_replay = True
    log(f"  (a) MoE-EP eager losses {' '.join(f'{v:.4f}' for v in eager)} "
        f"({smi})")
    log(f"      replayed losses     "
        f"{' '.join(f'{v:.4f}' for v in replayed)}; dispatches and "
        f"replayed exchanges a step {marks}")
    check(_finite_falling(eager), f"phase 20 (a): eager losses {eager}")
    check(replayed == eager, f"phase 20 (a): the replayed run's losses "
          f"{replayed} are not bitwise the eager run's {eager}")
    rounds = 4 * L
    check(all(m == (rounds, rounds) for m in marks[MOE_WARM:]),
          f"phase 20 (a): replayed steps' dispatches {marks}, expected "
          f"{rounds} graph launches a step")
    check(sync_dispatches == rounds, f"phase 20 (a): the counted step "
          f"dispatched {sync_dispatches}")
    for run in ("eager", "replay"):
        for name in FLASH_KERNELS:
            check(counts[run][name] == L * MOE_STEPS,
                  f"phase 20 (a) {run}: {name} launched "
                  f"{counts[run][name]}, expected {L * MOE_STEPS}")
    snap = hvd.metrics_snapshot()
    skew = {lab.get("layer"): v for lab, v in snap.get("gauges", {}).get(
        "hvd_tpu_moe_dispatch_skew", {}).get("values", [])}
    check(sorted(skew) == [str(i) for i in range(L)]
          and all(v >= 1.0 for v in skew.values()),
          f"phase 20 (a): routing skew gauges {skew}")
    steady = statistics.median(rep_ms[MOE_WARM:])
    moe_tok_s = B * T / (steady / 1e3)
    log(f"      step ms eager {' '.join(f'{v:.1f}' for v in eager_ms)}; "
        f"replayed {' '.join(f'{v:.1f}' for v in rep_ms)} (median of the "
        f"replayed {steady:.2f} ms, {moe_tok_s:.1f} tokens/s); "
        f"synchronizations a replayed step {len(syncs)}: {syncs}; skew "
        f"{skew}; peak {peak:.2f} GiB ({smi})")
    out["ep"] = {"eager_losses": eager, "replayed_losses": replayed,
                 "bitwise": replayed == eager, "eager_ms": eager_ms,
                 "replayed_ms": rep_ms, "marks": marks,
                 "graphs_per_step": rounds, "syncs_per_step": len(syncs),
                 "syncs": syncs, "skew": skew, "tokens_per_s": moe_tok_s,
                 "step_ms": steady, "peak_gib": peak,
                 "k6_launches_per_step": {
                     n: counts["replay"][n] // MOE_STEPS
                     for n in FLASH_KERNELS}}
    del step
    # (b) make_train_step on the (1, 1, 1) mesh with the MoE FFN
    mesh = training_mesh({"data": 1, "seq": 1, "tensor": 1})
    model.load_state_dict(state0)
    K.reset_launch_counts()
    tp_step = tm.make_train_step(mesh, cfg, _adamw(torch, model.parameters()))
    tp_losses = [float(tp_step(model, x, y)) for _ in range(MOE_TP_STEPS)]
    counts["tp_moe"] = K.launch_counts()
    log(f"  (b) make_train_step (1, 1, 1), MoE FFN: losses "
        f"{' '.join(f'{v:.4f}' for v in tp_losses)} ({smi})")
    check(_finite_falling(tp_losses), f"phase 20 (b): losses {tp_losses}")
    check(abs(tp_losses[0] - eager[0]) <= 2e-2 * abs(eager[0]),
          f"phase 20 (b): first loss {tp_losses[0]} against (a)'s "
          f"{eager[0]}")
    for name in FLASH_KERNELS:
        check(counts["tp_moe"][name] == L * MOE_TP_STEPS,
              f"phase 20 (b): {name} launched {counts['tp_moe'][name]}")
    out["tp_moe_losses"] = tp_losses
    del tp_step, model, state0
    torch.cuda.empty_cache()
    # (c) the dense flagship: make_train_step against DistributedOptimizer
    dcfg = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                                **LM_DIMS)
    dense = tm.Transformer(dcfg, generator=torch.Generator().manual_seed(0))
    dense.to(dev)
    dstate = {k: v.detach().clone() for k, v in dense.state_dict().items()}
    K.reset_launch_counts()
    tp_step = tm.make_train_step(mesh, dcfg, _adamw(torch, dense.parameters()))
    tp_dense = [float(tp_step(dense, x, y)) for _ in range(MOE_TP_STEPS)]
    counts["tp_dense"] = K.launch_counts()
    got = {n: p.detach().clone() for n, p in dense.named_parameters()}
    del tp_step
    dense.load_state_dict(dstate)
    opt = hvd.DistributedOptimizer(_adamw(torch, dense.parameters()),
                                   op=hvd.Sum)
    plain = []
    for _ in range(MOE_TP_STEPS):
        opt.zero_grad()
        total, count = tm._local_loss(dense, x, y)
        loss = total / count
        loss.backward()
        opt.step()
        plain.append(float(loss.detach()))
    worst, bitwise = 0.0, True
    for n, p in dense.named_parameters():
        p = p.detach()
        bitwise = bitwise and torch.equal(p, got[n])
        worst = max(worst, float((p - got[n]).abs().max()
                                 / p.abs().max().clamp_min(1e-30)))
    log(f"  (c) dense make_train_step (1, 1, 1) losses "
        f"{' '.join(f'{v:.4f}' for v in tp_dense)}; DistributedOptimizer "
        f"{' '.join(f'{v:.4f}' for v in plain)}; parameters bitwise "
        f"{bitwise}, largest difference {worst:.3g} of the largest entry "
        f"({smi})")
    check(_finite_falling(tp_dense), f"phase 20 (c): losses {tp_dense}")
    check(bitwise or worst <= 1e-6, f"phase 20 (c): parameters {worst:.3g} "
          "of the largest entry apart")
    for name in FLASH_KERNELS:
        check(counts["tp_dense"][name] == dcfg.n_layers * MOE_TP_STEPS,
              f"phase 20 (c): {name} launched {counts['tp_dense'][name]}")
    # the dense step of lean_lm_loss, timed as (a)'s replayed steps
    dense.load_state_dict(dstate)
    opt = hvd.DistributedOptimizer(_adamw(torch, dense.parameters()),
                                   op=hvd.Average)
    dense_ms = []
    for _ in range(MOE_DENSE_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        tm.lean_lm_loss(dense, x, y).backward()
        opt.step()
        torch.cuda.synchronize()
        dense_ms.append((time.perf_counter() - t0) * 1e3)
    dense_step = statistics.median(dense_ms[1:])
    ratio = dense_step / steady
    log(f"  moe_ep_vs_dense {ratio:.4f}: the dense step {dense_step:.2f} ms "
        f"({B * T / (dense_step / 1e3):.1f} tokens/s) against MoE-EP "
        f"{steady:.2f} ms ({moe_tok_s:.1f} tokens/s) ({smi})")
    out.update(tp_dense_losses=tp_dense, plain_losses=plain,
               tp_dense_bitwise=bitwise, tp_dense_max_rel=worst,
               dense_step_ms=dense_step, dense_ms=dense_ms,
               dense_tokens_per_s=B * T / (dense_step / 1e3),
               moe_ep_vs_dense=ratio)
    del dense, dstate, got, opt
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20: {out['seconds']:.1f} s ({smi})")
    total = {name: sum(c.get(name, 0) for c in counts.values())
             for name in FLASH_KERNELS + ("pack",)}
    return out, total


def run_pipeline_path(torch, hvd, K, tm, dev, smi, log, dense_tok_s):
    """Phase 21: the pipelined flagship at pipe 1 on one card (world size
    1, every hop a copy), the flagship LM's widths (``LM_DIMS``, bf16 on
    fp32 parameters, AdamW, ``attention="flash"``), batch 4 in
    ``PP_MICRO`` microbatches:

    (a) ``make_pp_train_step`` interleaved with each of ``PP_VIRTUAL``
        chunks, ``PP_CHECKED`` steps from the same weights: the losses and
        the parameters bitwise alike, finite and falling; each K6 kernel's
        launches (the forward of the F slots and of each B slot's
        recompute, the backward once a layer and microbatch); then
        ``PP_TIMED`` timed steps (v=2) and one with its synchronizations
        counted, then ``PP_PROFILED`` traced (device time by layer, busy
        share, launches a step);
    (b) the first loss within 1e-3 of ``make_train_step``'s on the (1, 1,
        1) mesh from the same weights (its fp32-logit loss);
    (c) ``zb`` and ``1f1b`` at pipe 1 raise the reference's errors;
    (d) ``make_pp_engine_train_step`` (v=2) through
        ``DistributedOptimizer(sharded=True)``, ``PP_ENGINE`` steps with
        replay off, then as many with it on from the same weights: the
        losses bitwise, one dispatch a replayed step, a replayed step's
        synchronizations.

    Returns the phase's summary and its K6 and K1 launches."""
    import copy
    from horovod_tpu_torch.parallel.mesh import training_mesh
    t_phase = time.perf_counter()
    eng = hvd.global_state().engine
    check(hvd.size() == 1, "phase 21 needs a size-1 world")
    cfg = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                               **LM_DIMS)
    L, T, B, m = cfg.n_layers, cfg.max_seq, 4, PP_MICRO
    gen = torch.Generator(device=dev).manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), device=dev,
                           generator=gen)
    x, y = tokens[:, :-1], tokens[:, 1:]
    pristine = tm.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    pristine.to(dev)
    mesh = training_mesh({"pipe": 1})
    out = {"card": smi, "microbatches": m, "batch": B}
    counts = {}
    torch.cuda.reset_peak_memory_stats(dev)

    def fwd_per_step(v):
        # F of chunks 0..v-2, then every chunk's recompute in its B slot
        return m * L * (2 * v - 1) // v

    # (a) interleaved at v = 2 and 4 from the same weights
    runs = {}
    for v in PP_VIRTUAL:
        model = copy.deepcopy(pristine)
        step = tm.make_pp_train_step(mesh, cfg, _adamw(
            torch, model.parameters()), m, schedule="interleaved",
            n_virtual=v)
        K.reset_launch_counts()
        losses = [float(step(model, x, y)) for _ in range(PP_CHECKED)]
        counts[f"v{v}"] = K.launch_counts()
        runs[v] = (losses, {n: p.detach().clone()
                            for n, p in model.named_parameters()})
        for name in FLASH_KERNELS:
            want = PP_CHECKED * (fwd_per_step(v) if name == "flash_fwd"
                                 else m * L)
            check(counts[f"v{v}"][name] == want,
                  f"phase 21 (a) v={v}: {name} launched "
                  f"{counts[f'v{v}'][name]}, expected {want}")
        if v == PP_VIRTUAL[0]:
            ms = []
            for _ in range(PP_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step(model, x, y))
                ms.append((time.perf_counter() - t0) * 1e3)
            _, syncs = _sync_count(torch, lambda: step(model, x, y))
            prof = profile_steps(torch, lambda: step(model, x, y),
                                 PP_PROFILED, log)
        del step, model
        torch.cuda.empty_cache()
    (l2, p2), (l4, p4) = runs[2], runs[4]
    bitwise = l2 == l4 and all(torch.equal(p2[n], p4[n]) for n in p2)
    log(f"  (a) make_pp_train_step interleaved v=2 losses "
        f"{' '.join(f'{v:.4f}' for v in l2)}; v=4 "
        f"{' '.join(f'{v:.4f}' for v in l4)}; bitwise {bitwise} ({smi})")
    check(_finite_falling(l2), f"phase 21 (a): losses {l2}")
    check(bitwise, "phase 21 (a): v=2 and v=4 are not bitwise alike")
    check(not syncs, f"phase 21 (a): a step synchronized {syncs}")
    del runs, p2, p4
    step_ms = statistics.median(ms)
    tok_s = B * T / (step_ms / 1e3)
    ratio = tok_s / dense_tok_s
    k6 = {n: counts["v2"][n] // PP_CHECKED for n in FLASH_KERNELS}
    log(f"      step ms {' '.join(f'{v:.2f}' for v in ms)} (median "
        f"{step_ms:.2f}, {tok_s:.1f} tokens/s, {ratio:.4f} of phase 5's "
        f"{dense_tok_s:.1f}); K6 a step {k6}; synchronizations a step "
        f"{len(syncs)} ({smi})")
    # (b) the first loss against make_train_step's
    model = copy.deepcopy(pristine)
    tp_step = tm.make_train_step(
        training_mesh({"data": 1, "seq": 1, "tensor": 1}), cfg,
        _adamw(torch, model.parameters()))
    first = float(tp_step(model, x, y))
    del tp_step, model
    torch.cuda.empty_cache()
    rel = abs(l2[0] - first) / abs(first)
    log(f"  (b) make_train_step's first loss {first:.6f}, the pipeline's "
        f"{l2[0]:.6f} ({rel:.3g} relative)")
    check(rel <= 1e-3, f"phase 21 (b): first loss {l2[0]} against "
          f"make_train_step's {first}")
    # (c) the schedules one stage cannot run, as the reference refuses them
    refused = {}
    for sched, exc, text in (("zb", RuntimeError, "stalled (zb, p=1"),
                             ("1f1b", ValueError, "n_stages >= 2")):
        step = tm.make_pp_train_step(mesh, cfg, None, m, schedule=sched)
        try:
            step(pristine, x, y)
            refused[sched] = None
        except exc as e:
            refused[sched] = str(e)
        check(refused[sched] is not None and text in refused[sched],
              f"phase 21 (c): {sched} at pipe 1: {refused[sched]}")
    log(f"  (c) refused at pipe 1: {refused}")
    # (d) the engine step, eager then replayed
    warm = eng.config.step_replay_warmup
    engine_runs = {}
    for replay in (False, True):
        model = copy.deepcopy(pristine)
        eng.config.step_replay = replay
        eng.replay.invalidate_all(f"phase 21 ({replay})")
        opt = hvd.DistributedOptimizer(_adamw(torch, model.parameters()),
                                       op=hvd.Sum, sharded=True)
        step = tm.make_pp_engine_train_step(mesh, cfg, opt, m,
                                            schedule="interleaved",
                                            n_virtual=2)
        K.reset_launch_counts()
        losses, marks, ems = [], [], []
        for _ in range(PP_ENGINE):
            d0, r0 = eng.dispatch_count, eng.replay.replayed_steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(model, x, y)))
            ems.append((time.perf_counter() - t0) * 1e3)
            marks.append((eng.dispatch_count - d0,
                          eng.replay.replayed_steps - r0))
        counts[f"engine_{'replay' if replay else 'eager'}"] = \
            K.launch_counts()
        if replay:
            d0 = eng.dispatch_count
            _, esyncs = _sync_count(torch, lambda: step(model, x, y))
            sync_dispatches = eng.dispatch_count - d0
        engine_runs[replay] = (losses, marks, ems)
        del step, opt, model
        torch.cuda.empty_cache()
    eng.config.step_replay = True
    eager, _, eager_ms = engine_runs[False]
    replayed, marks, rep_ms = engine_runs[True]
    log(f"  (d) make_pp_engine_train_step eager losses "
        f"{' '.join(f'{v:.4f}' for v in eager)}; replayed "
        f"{' '.join(f'{v:.4f}' for v in replayed)}; dispatches and replayed "
        f"steps a step {marks}; synchronizations a replayed step "
        f"{len(esyncs)}; ms eager {' '.join(f'{v:.1f}' for v in eager_ms)}, "
        f"replayed {' '.join(f'{v:.1f}' for v in rep_ms)} ({smi})")
    check(_finite_falling(eager), f"phase 21 (d): losses {eager}")
    check(replayed == eager, f"phase 21 (d): the replayed losses {replayed} "
          f"are not bitwise the eager ones {eager}")
    check(all(mk == (1, 1) for mk in marks[warm:]) and sync_dispatches == 1,
          f"phase 21 (d): replayed steps' dispatches {marks}, counted "
          f"{sync_dispatches}")
    check(not esyncs, f"phase 21 (d): a replayed step synchronized {esyncs}")
    for run in ("engine_eager", "engine_replay"):
        for name in FLASH_KERNELS:
            want = PP_ENGINE * (fwd_per_step(2) if name == "flash_fwd"
                                else m * L)
            check(counts[run][name] == want, f"phase 21 (d) {run}: {name} "
                  f"launched {counts[run][name]}, expected {want}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del pristine
    torch.cuda.empty_cache()
    out.update(losses_v2=l2, losses_v4=l4, bitwise=bitwise, step_ms=step_ms,
               timed_ms=ms, tokens_per_s=tok_s, vs_dense=ratio,
               dense_tokens_per_s=dense_tok_s, syncs_per_step=len(syncs),
               k6_launches_per_step=k6, first_loss_train_step=first,
               first_loss_rel=rel, refused=refused, profile=prof,
               engine={"eager_losses": eager, "replayed_losses": replayed,
                       "bitwise": replayed == eager, "marks": marks,
                       "eager_ms": eager_ms, "replayed_ms": rep_ms,
                       "step_ms": statistics.median(rep_ms[warm:]),
                       "syncs_per_step": len(esyncs)},
               peak_gib=peak)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  peak {peak:.2f} GiB; phase 21: {out['seconds']:.1f} s ({smi})")
    total = {name: sum(c.get(name, 0) for c in counts.values())
             for name in FLASH_KERNELS + ("pack", "pack_out")}
    return out, total


def _stall_seconds(hvd):
    """(sum, count) of ``hvd_tpu_ckpt_snapshot_stall_seconds``."""
    snap = hvd.metrics_snapshot().get("histograms", {}).get(
        "hvd_tpu_ckpt_snapshot_stall_seconds", {"values": []})
    vals = [v for _, v in snap["values"]]
    return (sum(v["sum"] for v in vals), sum(v["count"] for v in vals))


def _ckpt_arm(torch, hvd, step, tokens, mgr):
    """CKPT_STEPS steps in windows of CKPT_WINDOW, each step bracketed by
    ``hvd.step()`` (at size 1 the optimizer brackets nothing, and the
    bracket's end is the engine's step hook). Returns the losses, the
    tokens/s of the windows after the first, and for each of them whether
    a snapshot was pending or being written at its start and end."""
    losses, rates, busy = [], [], []
    for _ in range(CKPT_STEPS // CKPT_WINDOW):
        torch.cuda.synchronize()
        b0 = mgr is not None and not mgr.wait_idle(0)
        t0 = time.perf_counter()
        for _ in range(CKPT_WINDOW):
            with hvd.step():
                losses.append(step())
        torch.cuda.synchronize()
        rates.append(tokens * CKPT_WINDOW / (time.perf_counter() - t0))
        busy.append([b0, mgr is not None and not mgr.wait_idle(0)])
    return [float(v) for v in losses], rates[1:], busy[1:]


def _ckpt_tensors(tree) -> dict:
    """A training_state tree's tensors by name (``model.<name>``,
    ``opt.<index>.<key>``)."""
    out = {f"model.{k}": v for k, v in tree["model"].items()}
    for i, st in tree["opt"]["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


def _ckpt_rates(stages) -> dict:
    """A generation's seconds by stage and GB/s of the stream's bytes."""
    b = stages["bytes"]
    return {**{f"{k}_s": v for k, v in stages.items() if k != "bytes"},
            "bytes": b,
            **{f"{k}_gb_s": b / v / 1e9 for k, v in stages.items()
               if k in ("d2h", "checksum", "files", "wall") and v > 0}}


def _meminfo_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def run_checkpoint_path(torch, hvd, K, tm, dev, smi, log):
    """Phase 22: durable checkpointing of the flagship LM (``LM_DIMS``,
    bf16 on fp32 parameters, AdamW, batch 4 x 2048) at world size 1:

    (a) the off arm: CKPT_STEPS steps with no checkpoint directory;
    (b) the on arm, in a world re-initialized with
        ``HOROVOD_TPU_CHECKPOINT_DIR`` (a fresh temporary directory) and
        an interval of CKPT_INTERVAL: a registered provider returns
        ``training_state(model, opt)`` and the engine's step hook
        snapshots it every CKPT_INTERVAL steps; the host seconds inside
        ``snapshot()`` (the stall histogram), each stamp's device ms (CUDA
        events around the hook), tokens/s of the windows with a write in
        flight beside the off arm's, peak memory against the off arm's,
        the generations written and skipped, and one generation's seconds
        by stage; then the same generation again, stamped behind
        CKPT_SLEEP_CYCLES of device spinning with every synchronizing call
        counted: ``snapshot()`` returns before the card gets to it;
    (c) restore: a fresh ``CheckpointManager`` on the directory restores
        into a fresh model and AdamW: parameters and moments bitwise a
        device copy taken at the snapshot's step, then CKPT_RESUMED steps
        whose losses are held to the uninterrupted run's (bitwise, else
        the gap is recorded and only a non-finite loss fails);
    (d) ZeRO-1: phase 16's sharded LM after CKPT_ZERO1_STEPS steps through
        ``checkpoint_payload()`` and ``snapshot_zero1``, restored by
        ``restore_from_durable`` into a fresh sharded LM: the shards, the
        moments and the parameters bitwise;
    (e) the failpoints: ``checkpoint.write=1*drop()`` leaves no committed
        generation, ``checkpoint.restore`` surfaces its error.

    Fails, with the bytes it saw, where the disk or host memory cannot
    hold the generations. Returns the summary and the phase's launches."""
    import shutil
    import tempfile
    import warnings
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                              CheckpointRestoreError,
                                              load_training_state,
                                              training_state,
                                              training_template)
    from horovod_tpu_torch.common import env as env_mod
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    t_phase = time.perf_counter()
    check(hvd.size() == 1, "phase 22 needs a size-1 world")
    batch = 4
    tokens = batch * LM_DIMS["max_seq"]
    knobs = (env_mod.HOROVOD_TPU_CHECKPOINT_DIR,
             env_mod.HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS)
    root = tempfile.mkdtemp(prefix="hvd_ckpt_")
    out = {"card": smi, "interval": CKPT_INTERVAL, "batch": batch}
    K.reset_launch_counts()
    lm_steps = 0
    try:
        # (a) the off arm
        torch.cuda.reset_peak_memory_stats(dev)
        _, model, step = make_lm_trainer(torch, hvd, tm, dev, batch)
        n_params = sum(p.numel() for p in model.parameters())
        state_bytes = 3 * 4 * n_params
        free, avail = shutil.disk_usage(root).free, _meminfo_available()
        # three generations exist at once until the GC after the third;
        # the host holds the pinned buffer and a restore's shard bytes,
        # stream and leaves
        need_disk, need_ram = 3 * state_bytes + 2**30, 4 * state_bytes
        log(f"  {n_params / 1e6:.1f} M parameters, {state_bytes / 1e9:.3f} "
            f"GB of state a generation; {free / 1e9:.1f} GB free under "
            f"{root} (need {need_disk / 1e9:.1f}), {avail / 1e9:.1f} GB of "
            f"host memory available (need {need_ram / 1e9:.1f})")
        check(free >= need_disk, f"phase 22: {free} bytes free under {root}, "
              f"{need_disk} needed for the generations")
        check(avail >= need_ram, f"phase 22: {avail} bytes of host memory "
              f"available, {need_ram} needed")
        off_losses, off_rates, _ = _ckpt_arm(torch, hvd, step, tokens, None)
        lm_steps += CKPT_STEPS
        off_peak = torch.cuda.max_memory_allocated(dev)
        del model, step
        torch.cuda.empty_cache()

        # (b) the on arm: the manager is built at init from the knobs
        ckdir = os.path.join(root, "ckpt")
        hvd.shutdown()
        os.environ[knobs[0]] = ckdir
        os.environ[knobs[1]] = str(CKPT_INTERVAL)
        hvd.init()
        gs = hvd.global_state()
        mgr, eng = gs.checkpoint_manager, gs.engine
        check(mgr is not None and mgr.interval_steps == CKPT_INTERVAL
              and eng.on_step_complete == mgr.on_step,
              "phase 22: the world built no checkpoint manager from "
              "HOROVOD_TPU_CHECKPOINT_DIR, or did not hook it to the steps")
        torch.cuda.reset_peak_memory_stats(dev)
        _, model, step = make_lm_trainer(torch, hvd, tm, dev, batch)
        opt = step.opt
        mgr.register_provider(lambda: (training_state(model, opt),
                                       eng.step_index))
        stamps = []

        def hooked(i):
            if i % CKPT_INTERVAL:
                return mgr.on_step(i)
            s0 = _stall_seconds(hvd)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            mgr.on_step(i)
            hook_s = time.perf_counter() - t0
            e1.record()
            s1 = _stall_seconds(hvd)
            stamps.append((i, e0, e1, s1[0] - s0[0], s1[1] - s0[1], hook_s))

        eng.on_step_complete = hooked
        written0 = mgr.last_written_step
        on_losses, on_rates, busy = _ckpt_arm(torch, hvd, step, tokens, mgr)
        lm_steps += CKPT_STEPS
        on_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.synchronize()
        want = {k: v.detach().clone() for k, v in
                _ckpt_tensors(training_state(model, opt)).items()}
        check(mgr.wait_idle(300), "phase 22: the snapshots did not drain in "
              "300 s")
        stages_on = mgr.last_write_stages
        reg = hvd.metrics_snapshot()["counters"]
        outcomes = {o: int(sum(v for lab, v in
                               reg["hvd_tpu_ckpt_snapshots_total"]["values"]
                               if lab.get("outcome") == o))
                    for o in ("written", "skipped", "failed")}
        check([s[0] for s in stamps] == list(range(
            CKPT_INTERVAL, CKPT_STEPS + 1, CKPT_INTERVAL))
              and all(s[4] == 1 for s in stamps),
              f"phase 22: snapshots at {[s[0] for s in stamps]}, expected "
              f"every {CKPT_INTERVAL} steps, one snapshot() each")
        check(mgr.last_written_step == CKPT_STEPS and
              outcomes["failed"] == 0,
              f"phase 22: last written generation {mgr.last_written_step} "
              f"(from {written0}), outcomes {outcomes}")
        stall_ms = [s[3] * 1e3 for s in stamps]
        stamp_ms = [s[1].elapsed_time(s[2]) for s in stamps]
        check(all(v == v and abs(v) != float("inf") for v in on_losses),
              f"phase 22: non-finite losses on the on arm: {on_losses}")
        # the same generation again, stamped behind the card spinning:
        # snapshot() issues its copies and returns before the card
        # reaches them, with no synchronizing call
        tree = training_state(model, opt)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.cuda._sleep(CKPT_SLEEP_CYCLES)
                t0 = time.perf_counter()
                mgr.snapshot(tree, CKPT_STEPS)
                snap_s = time.perf_counter() - t0
                after = torch.cuda.Event()
                after.record()
                ahead = not after.query()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        check(not syncs and ahead, f"phase 22: snapshot() synchronized "
              f"({syncs}) or returned after the card caught up "
              f"({snap_s * 1e3:.3f} ms)")
        del tree
        check(mgr.wait_idle(300), "phase 22: the snapshot did not drain")
        stages = mgr.last_write_stages
        check(mgr.last_written_step == CKPT_STEPS, "phase 22: the second "
              f"write of generation {CKPT_STEPS} failed")
        gen_bytes = sum(os.path.getsize(os.path.join(dp, f))
                        for dp, _, fs in os.walk(ckdir) for f in fs)
        # the uninterrupted run's next steps
        ref_losses = [float(step()) for _ in range(CKPT_RESUMED)]
        lm_steps += CKPT_RESUMED
        mgr.register_provider(None)
        del model, step, opt
        torch.cuda.empty_cache()

        # (c) restore into a fresh model and AdamW through a fresh manager
        _, fresh, fstep = make_lm_trainer(torch, hvd, tm, dev, batch)
        rm = CheckpointManager(ckdir)
        try:
            t0 = time.perf_counter()
            res = rm.restore_latest(template=training_template(fresh,
                                                               fstep.opt))
            load_training_state(res.tree, fresh, fstep.opt)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        finally:
            rm.close(flush=False)
        got = _ckpt_tensors(training_state(fresh, fstep.opt))
        check(res.step == CKPT_STEPS and got.keys() == want.keys(),
              f"phase 22: restored generation {res.step} with "
              f"{len(got)} tensors, expected {CKPT_STEPS} and {len(want)}")
        differ = [k for k in want if not (
            got[k].device == want[k].device and torch.equal(got[k], want[k]))]
        check(not differ, f"phase 22: restored tensors differ from the "
              f"copy at the snapshot's step: {differ[:5]}")
        del res, want, got
        resumed = [float(fstep()) for _ in range(CKPT_RESUMED)]
        lm_steps += CKPT_RESUMED
        check(all(v == v and abs(v) != float("inf") for v in resumed),
              f"phase 22: non-finite resumed losses {resumed}")
        resumed_bitwise = resumed == ref_losses
        del fresh, fstep
        torch.cuda.empty_cache()
        eng.on_step_complete = mgr.on_step
        shutil.rmtree(ckdir, ignore_errors=True)

        # (d) ZeRO-1 through checkpoint_payload()
        _, zmodel, zstep = make_lm_trainer(torch, hvd, tm, dev, batch,
                                           sharded=True)
        for _ in range(CKPT_ZERO1_STEPS):
            zstep()
        lm_steps += CKPT_ZERO1_STEPS
        shards, leaves, layout = zstep.opt.checkpoint_payload()
        zdir = os.path.join(root, "zero1")
        zm = CheckpointManager(zdir)
        try:
            t0 = time.perf_counter()
            zm.snapshot_zero1(shards, leaves, layout, step=CKPT_ZERO1_STEPS)
            zsnap_s = time.perf_counter() - t0
            check(zm.wait_idle(300), "phase 22: the ZeRO-1 snapshot did not "
                  "drain")
            zstages = zm.last_write_stages
            check(zm.last_written_step == CKPT_ZERO1_STEPS,
                  "phase 22: the ZeRO-1 generation was not written")
            t0 = time.perf_counter()
            zres = zm.restore_latest()
            _, zfresh, zfstep = make_lm_trainer(torch, hvd, tm, dev, batch,
                                                sharded=True)
            zfstep.opt.restore_from_durable(zres.tree)
            torch.cuda.synchronize()
            zrestore_s = time.perf_counter() - t0
        finally:
            zm.close(flush=False)
        check(zres.mode == "zero1", f"phase 22: restored mode {zres.mode}")
        del zres
        g_shards, g_leaves, g_layout = zfstep.opt.checkpoint_payload()
        check(g_layout == layout and len(g_shards) == len(shards)
              and len(g_leaves) == len(leaves)
              and all(torch.equal(a, b) for a, b in zip(
                  shards + leaves, g_shards + g_leaves))
              and all(torch.equal(a, b) for a, b in zip(
                  zmodel.parameters(), zfresh.parameters())),
              "phase 22: the ZeRO-1 restore is not bitwise the payload")
        n_shards, n_leaves = len(shards), len(leaves)
        del shards, leaves, g_shards, g_leaves
        zlosses = [float(zstep()), float(zfstep())]
        lm_steps += 2
        zero1_next_bitwise = zlosses[0] == zlosses[1] and all(
            torch.equal(a, b) for a, b in zip(zmodel.parameters(),
                                              zfresh.parameters()))
        del zmodel, zstep, zfresh, zfstep
        torch.cuda.empty_cache()

        # (e) the failpoints, on a small tree on the card
        small = {"w": torch.randn(256, 256, device=dev)}
        fdir = os.path.join(root, "failpoints")
        fm = CheckpointManager(fdir)
        try:
            faults.arm("checkpoint.write=1*drop()")
            fm.snapshot(small, step=1)
            check(fm.wait_idle(60) and fm.latest_generation() is None,
                  "phase 22: a dropped write committed a generation")
            try:
                fm.restore_latest()
                raised = None
            except CheckpointRestoreError as e:
                raised = e
            check(raised is not None, "phase 22: restore found a generation "
                  "after the dropped write")
            faults.disarm()
            fm.snapshot(small, step=2)
            check(fm.wait_idle(60) and fm.latest_generation()[0] == 2,
                  "phase 22: the write after the drop did not commit")
            faults.arm("checkpoint.restore=1*raise(HorovodInternalError)")
            try:
                fm.restore_latest()
                raised = None
            except HorovodInternalError as e:
                raised = e
            check(raised is not None, "phase 22: checkpoint.restore's "
                  "raise did not surface")
        finally:
            faults.disarm()
            fm.close(flush=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if any(k in os.environ for k in knobs):
            hvd.shutdown()
            for k in knobs:
                os.environ.pop(k, None)
            hvd.init()
    counts = K.launch_counts()
    for name in FLASH_KERNELS:
        check(counts[name] == LM_DIMS["n_layers"] * lm_steps,
              f"{name} launched {counts[name]} in phase 22, expected "
              f"{LM_DIMS['n_layers'] * lm_steps}")
    check(counts["pack_out"] >= 1, "K1's out= form launched no time in the "
          "ZeRO-1 arm of phase 22")
    off_tok = statistics.mean(off_rates)
    on_tok = statistics.mean(on_rates)
    out.update({
        "n_params": n_params, "state_bytes": state_bytes,
        "off_tokens_per_s": off_tok, "off_windows": off_rates,
        "on_tokens_per_s": on_tok, "on_windows": on_rates,
        "on_vs_off": on_tok / off_tok, "windows_busy": busy,
        "stall_ms": stall_ms, "stall_ms_mean": statistics.mean(stall_ms),
        "stall_ms_max": max(stall_ms), "stamp_device_ms": stamp_ms,
        "hook_ms": [s[5] * 1e3 for s in stamps],
        "snapshot_behind_sleep_ms": snap_s * 1e3, "syncs": len(syncs),
        "off_peak_gib": off_peak / 2**30, "on_peak_gib": on_peak / 2**30,
        "outcomes": outcomes, "generation": _ckpt_rates(stages),
        "generation_in_training": _ckpt_rates(stages_on),
        "disk_bytes": gen_bytes, "restore_s": restore_s,
        "losses_off": off_losses, "losses_on": on_losses,
        "arms_bitwise": on_losses == off_losses,
        "losses_uninterrupted": ref_losses, "losses_resumed": resumed,
        "resumed_bitwise": resumed_bitwise,
        "zero1": {"shards": n_shards, "state_leaves": n_leaves,
                  "snapshot_ms": zsnap_s * 1e3,
                  "generation": _ckpt_rates(zstages),
                  "restore_s": zrestore_s, "bitwise": True,
                  "next_step_bitwise": zero1_next_bitwise,
                  "next_losses": zlosses},
        "failpoints": "ok", "phase_s": time.perf_counter() - t_phase})
    gen = out["generation"]
    log(f"  tokens/s off {off_tok:.1f} (windows "
        f"{', '.join(f'{r:.1f}' for r in off_rates)}), on {on_tok:.1f} "
        f"(windows {', '.join(f'{r:.1f}' for r in on_rates)}; a write "
        f"pending or in flight at each window's start and end: {busy}); "
        f"on/off {on_tok / off_tok:.4f}")
    log(f"  snapshot() host ms (stall histogram) "
        f"{', '.join(f'{v:.3f}' for v in stall_ms)}: mean "
        f"{out['stall_ms_mean']:.3f}, max {out['stall_ms_max']:.3f}; the "
        f"hook with the provider {', '.join(f'{v:.3f}' for v in out['hook_ms'])}"
        f"; the stamp's device ms {', '.join(f'{v:.3f}' for v in stamp_ms)}"
        f"; behind {CKPT_SLEEP_CYCLES} cycles of spinning snapshot() took "
        f"{snap_s * 1e3:.3f} ms, 0 synchronizing calls")
    log(f"  one generation ({gen['bytes'] / 1e9:.3f} GB): d2h "
        f"{gen['d2h_s']:.3f} s ({gen.get('d2h_gb_s', 0):.2f} GB/s), encode "
        f"{gen['encode_s']:.4f} s, checksum {gen['checksum_s']:.3f} s "
        f"({gen.get('checksum_gb_s', 0):.2f} GB/s), files {gen['files_s']:.3f}"
        f" s ({gen.get('files_gb_s', 0):.2f} GB/s), in all {gen['wall_s']:.3f}"
        f" s ({gen.get('wall_gb_s', 0):.2f} GB/s); written during training:"
        f" {out['generation_in_training']}; {gen_bytes / 1e9:.3f} GB on "
        f"disk; snapshots {outcomes}; peak {on_peak / 2**30:.2f} GiB on "
        f"against {off_peak / 2**30:.2f} off")
    log(f"  restore {restore_s:.2f} s, bitwise the copy at step {CKPT_STEPS}"
        f"; resumed losses {resumed} against the uninterrupted "
        f"{ref_losses}: {'bitwise' if resumed_bitwise else 'NOT bitwise'}")
    log(f"  ZeRO-1: {n_shards} shards and {n_leaves} state leaves, "
        f"snapshot_zero1 {zsnap_s * 1e3:.3f} ms, generation "
        f"{out['zero1']['generation']}, restore {zrestore_s:.2f} s, bitwise;"
        f" next step {'bitwise' if zero1_next_bitwise else 'NOT bitwise'} "
        f"({zlosses}); failpoints ok; phase {out['phase_s']:.1f} s")
    return out, counts


def _timed_state(TPUState, torch, marks):
    """A ``TPUState`` whose save, restore, sync and on_reset record their
    host seconds (after a device synchronize) in ``marks``."""
    class TimedState(TPUState):
        def _mark(self, what, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                marks.append((what, t0, time.perf_counter()))

        def save(self):
            return self._mark("save", super().save)

        def restore(self):
            return self._mark("restore", super().restore)

        def sync(self):
            return self._mark("sync", super().sync)

        def on_reset(self):
            marks.append(("on_reset", time.perf_counter(), None))
            return super().on_reset()

    return TimedState


def _ms(marks, what) -> list:
    return [(t1 - t0) * 1e3 for w, t0, t1 in marks if w == what]


def _wait_exit(pid: int, timeout: float) -> bool:
    """Wait for process ``pid`` (not a child of this one) to exit; kill it
    if it has not after ``timeout`` seconds. Returns whether it exited."""
    import signal
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except OSError:
            return True
        time.sleep(0.1)
    try:
        os.kill(pid, signal.SIGKILL)
    except OSError:
        pass
    return False


def run_elastic_path(torch, hvd, K, tm, dev, smi, log):
    """Phase 23: elastic training of the flagship LM (``LM_DIMS``, bf16 on
    fp32 parameters, AdamW, batch 4 x 2048) at world size 1:

    (a) in process: ELASTIC_STEPS steps uninterrupted, then a fresh model
        from the same seed under ``@hvd.elastic.run`` with
        ``TPUState(params=model, opt_state=opt, step=0)``, committing every
        ELASTIC_COMMIT steps. After step ELASTIC_FAIL_AT the training
        function raises ``HorovodInternalError`` (at size 1 the optimizer
        reduces nothing, so no failpoint of the engine is reached): the
        run loop restores the commit, resets the world (``hvd.shutdown()``
        and ``hvd.init()`` on NCCL in this process) and syncs. After step
        ELASTIC_NOTIFY_AT a real ``WorkerNotificationClient`` pushes an
        ADDED host update to the worker's notification service; the next
        ``commit()`` raises ``HostsUpdatedInterrupt(skip_sync=True)`` and
        the world is reset without a sync. The losses of every step after
        each reset must be bitwise the uninterrupted run's, the world
        version must move forward and the engine be a new object at each
        reset, replay's graphs must be invalidated before each process
        group is destroyed, and K6a-d must launch on the steps after each
        reset. It records commit(), restore() and sync() ms, the reset
        seconds and the peak memory.
    (b) a killed worker: ``python -m horovod_tpu_torch.runner --elastic
        -np 1`` with a discovery script that prints ``localhost:1`` runs
        this script with ``--elastic-worker`` (HOROVOD_TPU_CHECKPOINT_DIR
        a temporary directory): the child trains the same LM under
        ``hvd.elastic.run``, every commit a durable snapshot; after the
        commit of step ELASTIC_KILL_AFTER is written it dies hard
        (``os._exit(137)``, once: a marker file). The driver relaunches
        the slot, the new process restores that generation through the
        durable tier and trains the rest. The launcher must exit 0, the
        relaunched losses must be bitwise the uninterrupted run's, and the
        child must have run K6. It records the seconds from the kill to
        the new process's first step and the restore seconds.

    Returns the summary and (a)'s launches."""
    import shutil
    import stat
    import subprocess
    import tempfile
    import torch.distributed as dist
    from horovod_tpu_torch.common import env as env_mod
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.core.replay import StepReplay
    from horovod_tpu_torch.elastic import (HostUpdateResult, TPUState,
                                           WorkerNotificationClient,
                                           notification_manager)
    from horovod_tpu_torch.runner.http_server import KVStoreServer
    t_phase = time.perf_counter()
    check(hvd.size() == 1, "phase 23 needs a size-1 world")
    for knob in (env_mod.HOROVOD_TPU_CHECKPOINT_DIR,
                 env_mod.HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS):
        check(knob not in os.environ, f"phase 23: {knob} is set")
    batch = 4
    out = {"card": smi, "steps": ELASTIC_STEPS, "commit": ELASTIC_COMMIT,
           "batch": batch}

    # (a) the uninterrupted run, then the same from the same seed under
    # the elastic run loop
    _, model, step = make_lm_trainer(torch, hvd, tm, dev, batch)
    want = [float(step()) for _ in range(ELASTIC_STEPS)]
    check(all(math.isfinite(v) for v in want),
          f"phase 23: non-finite losses {want}")
    del model, step
    torch.cuda.empty_cache()

    kv = KVStoreServer()
    kv.start()
    manager = notification_manager()
    manager.init(rendezvous_addr="127.0.0.1", rendezvous_port=kv.port,
                 rank=0, hostname="127.0.0.1")
    addr = kv.snapshot()["worker_addresses"]["0"].decode()
    order = []
    real_invalidate = StepReplay.invalidate_all
    real_destroy = dist.destroy_process_group

    def invalidate_all(self, reason, *a, **kw):
        order.append(f"invalidate:{reason}")
        return real_invalidate(self, reason, *a, **kw)

    def destroy_process_group(*a, **kw):
        order.append("destroy")
        return real_destroy(*a, **kw)

    marks = []
    lives = []
    got = []
    version0 = os.environ.get(env_mod.HOROVOD_TPU_WORLD_VERSION)
    StepReplay.invalidate_all = invalidate_all
    dist.destroy_process_group = destroy_process_group
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        _, model, step = make_lm_trainer(torch, hvd, tm, dev, batch)
        state = _timed_state(TPUState, torch, marks)(
            params=model, opt_state=step.opt, step=0)
        K.reset_launch_counts()

        @hvd.elastic.run
        def train(state):
            eng = hvd._engine()
            lives.append(dict(engine=eng, version=eng.world_version,
                              device=hvd.device(), start=state.step,
                              counts=dict(K.launch_counts()),
                              order=len(order)))
            while state.step < ELASTIC_STEPS:
                loss = float(step())
                state.step += 1
                got.append((len(lives), state.step, loss))
                if state.step == ELASTIC_FAIL_AT and len(lives) == 1:
                    raise HorovodInternalError(
                        f"phase 23: injected after step {state.step}")
                if state.step == ELASTIC_NOTIFY_AT and len(lives) == 2:
                    WorkerNotificationClient(addr).notify_hosts_updated(
                        int(time.time() * 1e6), HostUpdateResult.ADDED)
                    deadline = time.monotonic() + 10
                    while state._host_messages.empty() and \
                            time.monotonic() < deadline:
                        time.sleep(0.01)
                    check(not state._host_messages.empty(),
                          "phase 23: the host update never reached the "
                          "state")
                if state.step % ELASTIC_COMMIT == 0:
                    state.commit()
            return state.step

        check(train(state) == ELASTIC_STEPS, "phase 23: train ended early")
        peak = torch.cuda.max_memory_allocated(dev)
        final_counts = dict(K.launch_counts())
        final_engine = hvd._engine()
    finally:
        StepReplay.invalidate_all = real_invalidate
        dist.destroy_process_group = real_destroy
        manager.shutdown()
        kv.stop()
        if version0 is None:
            os.environ.pop(env_mod.HOROVOD_TPU_WORLD_VERSION, None)
        else:
            os.environ[env_mod.HOROVOD_TPU_WORLD_VERSION] = version0
    check(len(lives) == 3, f"phase 23: {len(lives)} lives of the training "
          "function, expected 3 (the start, the recovery, the host update)")
    check([life["start"] for life in lives] ==
          [0, ELASTIC_COMMIT, 2 * ELASTIC_COMMIT],
          f"phase 23: the lives started at steps "
          f"{[life['start'] for life in lives]}")
    versions = [life["version"] for life in lives]
    check(versions[0] < versions[1] < versions[2],
          f"phase 23: world versions {versions} did not move forward")
    check(lives[0]["engine"] is not lives[1]["engine"]
          and lives[1]["engine"] is not lives[2]["engine"]
          and lives[2]["engine"] is final_engine,
          "phase 23: a reset kept its engine")
    check(all(life["device"] == dev for life in lives),
          f"phase 23: a reset moved the world off {dev}: "
          f"{[str(life['device']) for life in lives]}")
    # each reset: replay's graphs invalidated, then the process group gone
    resets = [order[lives[i]["order"]:lives[i + 1]["order"]]
              for i in range(2)]
    for r in resets:
        check(r.count("destroy") == 1 and "invalidate:shutdown" in
              r[:r.index("destroy")],
              f"phase 23: teardown order {r}, expected replay's "
              "invalidation before the process group's destruction")
    after_fail = [(s, v) for life, s, v in got if life == 2]
    after_notify = [(s, v) for life, s, v in got if life == 3]
    check([s for s, _ in after_fail] ==
          list(range(ELASTIC_COMMIT + 1, 2 * ELASTIC_COMMIT + 1)) and
          [s for s, _ in after_notify] ==
          list(range(2 * ELASTIC_COMMIT + 1, ELASTIC_STEPS + 1)),
          f"phase 23: steps after the resets {after_fail}, {after_notify}")
    bitwise_fail = all(v == want[s - 1] for s, v in after_fail)
    bitwise_notify = all(v == want[s - 1] for s, v in after_notify)
    check(bitwise_fail and bitwise_notify,
          f"phase 23: losses after the resets {after_fail} and "
          f"{after_notify}, the uninterrupted run's {want}")
    ends = [life["counts"] for life in lives[1:]] + [final_counts]
    layers = LM_DIMS["n_layers"]
    launches = {name: 0 for name in FLASH_KERNELS}
    for i, life in enumerate(lives[1:]):
        n = ELASTIC_COMMIT
        for name in FLASH_KERNELS:
            d = ends[i + 1][name] - life["counts"][name]
            check(d == layers * n,
                  f"phase 23: {name} launched {d} times in the {n} steps "
                  f"after reset {i + 1}, expected {layers * n}")
    for name in FLASH_KERNELS:
        launches[name] = final_counts[name]
    saves = _ms(marks, "save")
    restore_ms = _ms(marks, "restore")
    syncs = _ms(marks, "sync")
    ev = {w: [(t0, t1) for x, t0, t1 in marks if x == w]
          for w in ("save", "restore", "on_reset")}
    # reset seconds: the failure's restore, or the host update's save, to
    # the state's on_reset after the world is back
    def before(what, t):
        return max(t1 for t0, t1 in ev[what] if t1 <= t)

    reset_s = [ev["on_reset"][0][0] - before("restore", ev["on_reset"][0][0]),
               ev["on_reset"][1][0] - before("save", ev["on_reset"][1][0])]
    state_bytes = 3 * 4 * sum(p.numel() for p in model.parameters())
    del model, step, state, lives, final_engine, train
    torch.cuda.empty_cache()
    out["in_process"] = {
        "losses_uninterrupted": want, "losses_after_failure": after_fail,
        "losses_after_host_update": after_notify,
        "bitwise_after_failure": bitwise_fail,
        "bitwise_after_host_update": bitwise_notify,
        "world_versions": versions, "teardown_order": resets,
        "commit_ms": saves, "restore_ms": restore_ms, "sync_ms": syncs,
        "reset_s": reset_s, "peak_gib": peak / 2**30,
        "state_bytes": state_bytes, "host_copy": "pageable",
        "launches": launches}
    log(f"  (a) losses after the failure {after_fail} and after the host "
        f"update {after_notify}: bitwise the uninterrupted run's; world "
        f"versions {versions}; teardown {resets}")
    log(f"  (a) commit() ms {', '.join(f'{v:.1f}' for v in saves)} "
        f"({state_bytes / 1e9:.3f} GB to host, pageable); restore() ms "
        f"{', '.join(f'{v:.1f}' for v in restore_ms)}; sync() ms "
        f"{', '.join(f'{v:.1f}' for v in syncs)}; reset s "
        f"{', '.join(f'{v:.3f}' for v in reset_s)}; peak "
        f"{peak / 2**30:.2f} GiB; K6 launches {launches}")

    # (b) a killed worker, relaunched by the driver, restored from the
    # durable tier
    root = tempfile.mkdtemp(prefix="hvd_elastic_")
    try:
        script = os.path.join(root, "hosts.sh")
        with open(script, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\n")
        os.chmod(script, os.stat(script).st_mode | stat.S_IXUSR)
        env = {k: v for k, v in os.environ.items()
               if k not in (env_mod.HOROVOD_TPU_WORLD_VERSION,
                            env_mod.HOROVOD_TPU_COORDINATOR,
                            env_mod.HOROVOD_TPU_NUM_PROCESSES,
                            env_mod.HOROVOD_TPU_PROCESS_ID)}
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(hvd.__file__)))
        env.update({
            env_mod.HOROVOD_TPU_CHECKPOINT_DIR: os.path.join(root, "ckpt"),
            env_mod.HOROVOD_ELASTIC_FAILURE_BACKOFF: "0.5",
            env_mod.HOROVOD_TPU_SHUTDOWN_TIMEOUT: "30",
            "ELASTIC_SMOKE_OUT": root,
            "PYTHONPATH": os.pathsep.join(
                [pkg_root, env.get("PYTHONPATH", "")]),
        })
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "--elastic",
               "-np", "1", "--min-np", "1", "--max-np", "1",
               "--host-discovery-script", script, sys.executable,
               os.path.abspath(__file__), "--elastic-worker"]
        if pkg_root != os.path.dirname(os.path.abspath(__file__)):
            cmd += ["--package-root", pkg_root]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=ELASTIC_CHILD_TIMEOUT)
        job_s = time.perf_counter() - t0
        tail = (res.stdout + res.stderr)[-6000:]
        check(res.returncode == 0,
              f"phase 23: the elastic launcher exited {res.returncode}:\n"
              f"{tail}")
        check(os.path.exists(os.path.join(root, "killed.marker")),
              f"phase 23: the worker never died:\n{tail}")
        lives_b = []
        for n in (1, 2):
            path = os.path.join(root, f"life{n}.json")
            check(os.path.exists(path), f"phase 23: no {path}:\n{tail}")
            with open(path) as f:
                lives_b.append(json.load(f))
        # the driver ends the job when the worker reports its success; the
        # worker's process then shuts its world down and exits
        exited = _wait_exit(lives_b[1]["pid"], 60.0)
        check(exited, f"phase 23: the relaunched worker (pid "
              f"{lives_b[1]['pid']}) had not exited 60 s after its job")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first, second = lives_b
    first_losses = {int(k): v for k, v in first["losses"].items()}
    resumed = {int(k): v for k, v in second["losses"].items()}
    check(sorted(resumed) == list(range(ELASTIC_KILL_AFTER + 1,
                                        ELASTIC_STEPS + 1)),
          f"phase 23: the relaunched worker ran steps {sorted(resumed)}")
    child_bitwise = all(first_losses[s] == want[s - 1]
                        for s in first_losses)
    resumed_bitwise = all(v == want[s - 1] for s, v in resumed.items())
    check(resumed_bitwise,
          f"phase 23: the relaunched worker's losses {resumed} against "
          f"the uninterrupted run's {want[ELASTIC_KILL_AFTER:]} (its first "
          f"life's steps bitwise this process's: {child_bitwise})")
    check(second["entered_at"] == ELASTIC_KILL_AFTER
          and second["restored_generation"] ==
          ELASTIC_KILL_AFTER // ELASTIC_COMMIT
          and second["durable_recoveries"] == 1,
          f"phase 23: the relaunched worker entered at step "
          f"{second['entered_at']} with {second['durable_recoveries']} "
          "durable recoveries")
    for name in FLASH_KERNELS:
        want_n = LM_DIMS["n_layers"] * (ELASTIC_STEPS - ELASTIC_KILL_AFTER)
        check(second["counts"][name] == want_n,
              f"phase 23: the relaunched worker launched {name} "
              f"{second['counts'][name]} times, expected {want_n}")
    kill_to_first = second["t_first_step"] - first["t_kill"]
    out["killed_worker"] = {
        "launcher_exit": res.returncode, "job_s": job_s,
        "kill_to_first_step_s": kill_to_first,
        "relaunch_to_init_s": second["t_init"] - first["t_kill"],
        "restore_s": second["restore_s"],
        "restore_stages_s": second["restore_stages"],
        "init_to_model_s": second["t_model"] - second["t_init"],
        "restored_generation": second["restored_generation"],
        "first_life_losses": first_losses, "resumed_losses": resumed,
        "first_life_bitwise": child_bitwise,
        "resumed_bitwise": resumed_bitwise,
        "child_launches": second["counts"],
        "child_peak_gib": [first["peak_gib"], second["peak_gib"]]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  (b) the launcher exited 0 in {job_s:.1f} s; kill to the new "
        f"process's first step {kill_to_first:.2f} s (to its init "
        f"{out['killed_worker']['relaunch_to_init_s']:.2f} s, its model "
        f"{out['killed_worker']['init_to_model_s']:.2f} s after), durable "
        f"restore {second['restore_s']:.2f} s (by stage "
        f"{second['restore_stages']}; generation "
        f"{second['restored_generation']}, step {ELASTIC_KILL_AFTER}'s "
        f"commit); resumed losses {resumed}: bitwise; "
        f"the first life's {'bitwise' if child_bitwise else 'NOT bitwise'}"
        f" this process's; child K6 launches {second['counts']}; phase "
        f"{out['phase_s']:.1f} s")
    return out, launches


def elastic_child(torch, hvd, K, tm, log) -> int:
    """One life of phase 23 (b)'s worker (``--elastic-worker``, launched by
    the port's elastic launcher): the flagship LM under
    ``hvd.elastic.run``, a commit and a durable snapshot every
    ELASTIC_COMMIT steps. On its first life it dies hard after the commit
    of step ELASTIC_KILL_AFTER is written. Writes ``life<n>.json`` into
    ``$ELASTIC_SMOKE_OUT``: its losses by step, its wall-clock marks, its
    restore seconds and its K6 launches."""
    from horovod_tpu_torch.checkpoint import manager as ckpt_manager
    from horovod_tpu_torch.elastic import TPUState
    out_dir = os.environ["ELASTIC_SMOKE_OUT"]
    marker = os.path.join(out_dir, "killed.marker")
    life = 2 if os.path.exists(marker) else 1
    rec = {"life": life, "t_start": time.time(), "losses": {}}
    hvd.init()
    rec["t_init"] = time.time()
    dev = hvd.device()
    mgr = hvd.global_state().checkpoint_manager
    check(mgr is not None, "the elastic worker has no checkpoint manager")
    _, model, step = make_lm_trainer(torch, hvd, tm, dev, 4)
    rec["t_model"] = time.time()
    marks = []
    state = _timed_state(TPUState, torch, marks)(
        params=model, opt_state=step.opt, step=0)
    K.reset_launch_counts()
    # the durable restore's stages: discovery, the optimizer's template,
    # the generation's read and decode (restore_latest)
    stages = rec["restore_stages"] = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                stages[name] = stages.get(name, 0.0) + \
                    time.perf_counter() - t0
        return run

    mgr.latest_generation = timed("discovery", mgr.latest_generation)
    mgr.restore_latest = timed("restore_latest", mgr.restore_latest)
    ckpt_manager.optimizer_template = timed(
        "template", ckpt_manager.optimizer_template)

    def write():
        rec["counts"] = {k: K.launch_counts()[k] for k in FLASH_KERNELS}
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        rec["pid"] = os.getpid()
        with open(os.path.join(out_dir, f"life{life}.json"), "w") as f:
            json.dump(rec, f)

    @hvd.elastic.run
    def train(state):
        rec["entered_at"] = state.step
        rec["restored_generation"] = state._durable_step
        while state.step < ELASTIC_STEPS:
            rec.setdefault("t_first_step", time.time())
            rec["losses"][state.step + 1] = float(step())
            state.step += 1
            if state.step % ELASTIC_COMMIT:
                continue
            state.commit()
            if life == 1 and state.step == ELASTIC_KILL_AFTER:
                check(mgr.wait_idle(120),
                      "the generation before the kill was not written")
                rec["t_kill"] = time.time()
                write()
                with open(marker, "w") as f:
                    f.write(str(os.getpid()))
                os._exit(137)   # a hard crash: no teardown, no flush
        # the record before the run loop reports this worker's success:
        # the driver may end the job as soon as it hears of it
        restores = [(t1 - t0) for w, t0, t1 in marks if w == "restore"]
        rec["restore_s"] = restores[0] if restores else None
        snap = hvd.metrics_snapshot()["counters"].get(
            "hvd_tpu_elastic_recoveries_total", {"values": []})["values"]
        rec["durable_recoveries"] = sum(
            v for labels, v in snap if dict(labels).get("kind") == "durable")
        write()
        return state.step

    train(state)
    hvd.shutdown()
    return 0


# the telemetry publishers' knobs an arm of phase 24 (a) may set, cleared
# before each arm sets its own
CP_KNOBS = ("HOROVOD_KV_ENDPOINTS", "HOROVOD_TPU_METRICS_INTERVAL",
            "HOROVOD_TPU_TRACE_INTERVAL")
CP_TELEMETRY = ("metrics", "trace", "stall")   # the publishers' KV scopes


def _cp_arm(torch, hvd, K, tm, dev, name, env, interval, log):
    """One arm of phase 24 (a) in a fresh world: the flagship LM over the
    windows of phase 5, then LM_WINDOW_STEPS steps counted under the sync
    debug mode. ``interval`` also paces the stall inspector's publish (it
    has no knob: its watch thread reads the attribute each tick)."""
    hvd.shutdown()
    saved = {k: os.environ.pop(k, None) for k in CP_KNOBS}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        hvd.init()
        gs = hvd.global_state()
        if interval and gs.stall_inspector is not None:
            gs.stall_inspector.check_interval = interval
        wired = {"metrics": gs.metrics_emitter is not None
                 and gs.metrics_emitter.kv is not None,
                 "trace": gs.trace_publisher is not None,
                 "stall": gs.stall_inspector is not None
                 and gs.stall_inspector.kv is not None}
        cfg, model, step = make_lm_trainer(torch, hvd, tm, dev, 4)
        K.reset_launch_counts()
        losses, tok_s, rates = train(torch, step, 4 * cfg.max_seq, 3,
                                     LM_WINDOW_STEPS, 3, log)
        _, syncs = _sync_count(
            torch, lambda: [step() for _ in range(LM_WINDOW_STEPS)])
        counts = K.launch_counts()
        del model, step
        t1 = time.perf_counter()
        hvd.shutdown()      # the publishers' final flushes
        shutdown_s = time.perf_counter() - t1
    finally:
        for k in env:
            os.environ.pop(k, None)
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    torch.cuda.empty_cache()
    n_steps = 3 + 3 * LM_WINDOW_STEPS + LM_WINDOW_STEPS
    for k6 in FLASH_KERNELS:
        check(counts[k6] == LM_DIMS["n_layers"] * n_steps,
              f"phase 24 ({name}): {k6} launched {counts[k6]} times, "
              f"expected {LM_DIMS['n_layers'] * n_steps}")
    return {"losses": losses, "tokens_per_s": tok_s, "windows": rates,
            "syncs": len(syncs), "sync_samples": syncs[:3],
            "wired": wired, "wall_s": time.perf_counter() - t0,
            "shutdown_s": shutdown_s, "launches": counts}


def _scrape(port):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


# one sample line of a Prometheus scrape, and one label pair of it
PROM_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _prom_samples(text):
    """(name, labels, value) of each sample line of a Prometheus scrape;
    an unparseable line fails the phase."""
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = PROM_SAMPLE.match(line)
        check(m is not None, f"phase 24: unparseable scrape line {line!r}")
        name, labels, value = m.groups()
        out.append((name, dict(PROM_LABEL.findall(labels or "")),
                    float("inf") if value == "+Inf" else float(value)))
    return out


def _check_rank0_scrape(kv, what):
    """The KV's ``GET /metrics`` parses, and every counter and gauge series
    of rank 0's stored snapshot renders there with ``rank="0"``; returns
    how many series that is."""
    stored = kv.snapshot("metrics").get("metrics", {})
    check("0" in stored, f"phase 24 ({what}): no metrics/0 in the KV "
          f"({sorted(stored)})")
    snap = json.loads(stored["0"])
    want = {(fam, tuple(sorted(labels.items())))
            for kind in ("counters", "gauges")
            for fam, ent in snap.get(kind, {}).items()
            for labels, _ in ent["values"]}
    got = {(n, tuple(sorted((k, v) for k, v in ls.items() if k != "rank")))
           for n, ls, _ in _prom_samples(_scrape(kv.port))
           if ls.get("rank") == "0"}
    check(want <= got, f"phase 24 ({what}): rank 0's series missing from "
          f"GET /metrics: {sorted(want - got)[:5]}")
    return len(want)


def _read_line(proc, want, timeout):
    """The first line of ``proc``'s stdout holding ``want`` (its earlier
    lines are skipped), waiting at most ``timeout`` seconds."""
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            if not sel.select(timeout=max(0.0, deadline - time.monotonic())):
                break
            line = proc.stdout.readline()
            check(line, f"phase 24: the primary exited (code "
                  f"{proc.poll()}) before it printed {want!r}")
            if want in line:
                return line
    finally:
        sel.close()
    check(False, f"phase 24: the primary printed no {want!r} in {timeout} s")


def run_control_plane_path(torch, hvd, K, tm, dev, smi, log):
    """Phase 24: the survivable control plane on the flagship LM.

    (a) what the KV telemetry costs the step: the flagship LM (phase 5's
        model, batch, windows) in three fresh worlds: no KV; a standalone
        port KV server named by ``HOROVOD_KV_ENDPOINTS`` with the
        publishers at their defaults; the same server with the metrics,
        trace and stall intervals at CP_INTERVAL. Every arm's losses must
        be bitwise the first arm's, each wired publisher must have written
        to the server (the final flush at least; at world size 1 the stall
        inspector publishes nothing, the reference's rule), ``GET
        /metrics`` must parse and hold rank 0's snapshot, and a counted
        run of steps may synchronize no more often than the first arm's.
        It records tokens/s against the first arm, the publishers' bytes a
        second and each arm's teardown seconds.
    (b) a worker that outlives a SIGKILL of its driver and its KV primary:
        the primary is a subprocess (``--cp-primary``: a replicated
        ``ElasticRendezvousServer``, role primary, and a journaled
        ``ElasticDriver`` over a hosts file ``localhost:1``); this process
        holds the standby (a replica, role standby, and a
        ``DriverStandby``), whose lease clock starts once the primary is
        up; the worker (``--cp-worker``) trains the flagship LM under
        ``@hvd.elastic.run`` for CP_STEPS steps, committing every
        CP_COMMIT, its rendezvous address the comma spec of both replicas,
        the publishers at CP_INTERVAL. After its step CP_KILL_AFTER the
        primary is SIGKILLed. Both tiers of the standby must promote, the
        journal hold no gap, the worker finish in its first life with no
        restore and no relaunch, losses bitwise the first arm's, K6 in
        every step; the promoted driver must hold its result and finish;
        the survivor's scrape must carry the failover and promotion
        counters and the worker's post-kill snapshot; ``arm_from_kv``
        must arm through the survivor. It records the seconds from the
        kill to each promotion, the worker's step times, the publishes
        that failed over and the bytes shed.

    Returns the summary and K6's launches of (a) and (b)."""
    import shutil
    import signal
    import tempfile
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.common import env as env_mod
    from horovod_tpu_torch.core.backend import COORDINATOR_VIA_RENDEZVOUS
    from horovod_tpu_torch.elastic.discovery import HostDiscoveryScript
    from horovod_tpu_torch.elastic.failover import DriverStandby
    from horovod_tpu_torch.elastic.rendezvous import ElasticRendezvousServer
    from horovod_tpu_torch.runner.http_client import put_data_into_kvstore
    from horovod_tpu_torch.runner.http_server import (KVStoreServer,
                                                      find_free_port)
    from horovod_tpu_torch.runner.replication import ReplicationConfig
    t_phase = time.perf_counter()
    check(hvd.size() == 1, "phase 24 needs a size-1 world")
    out = {"card": smi, "interval_s": CP_INTERVAL}

    # (a) three arms, each a fresh world
    kv = KVStoreServer(("127.0.0.1", 0))
    kv.start()
    arms = {}
    try:
        spec = f"127.0.0.1:{kv.port}"
        for name, env, interval in (
                ("no_kv", {}, 0.0),
                ("kv_defaults", {"HOROVOD_KV_ENDPOINTS": spec}, 0.0),
                ("kv_fast", {"HOROVOD_KV_ENDPOINTS": spec,
                             "HOROVOD_TPU_METRICS_INTERVAL": str(CP_INTERVAL),
                             "HOROVOD_TPU_TRACE_INTERVAL": str(CP_INTERVAL)},
                 CP_INTERVAL)):
            before = kv.request_stats()
            arm = arms[name] = _cp_arm(torch, hvd, K, tm, dev, name, env,
                                       interval, log)
            after = kv.request_stats()
            puts = {}
            for scope in CP_TELEMETRY:
                n0, b0 = before.get(("put", scope), (0, 0))
                n1, b1 = after.get(("put", scope), (0, 0))
                puts[scope] = (n1 - n0, b1 - b0)
            arm["puts"] = puts
            arm["bytes_per_s"] = sum(b for _, b in puts.values()) \
                / arm["wall_s"]
            if name != "no_kv":
                for scope in ("metrics", "trace"):
                    check(arm["wired"][scope] and puts[scope][0] > 0,
                          f"phase 24 ({name}): the {scope} publisher wrote "
                          f"nothing to the KV ({puts})")
                check(arm["wired"]["stall"] and puts["stall"][0] == 0,
                      f"phase 24 ({name}): the stall inspector published "
                      f"at world size 1 ({puts})")
                arm["rank0_series"] = _check_rank0_scrape(kv, name)
            else:
                check(not any(arm["wired"].values()),
                      f"phase 24: the no-KV arm wired {arm['wired']}")
            log(f"  (a) {name}: {arm['tokens_per_s']:.1f} tokens/s "
                f"(windows {', '.join(f'{r:.1f}' for r in arm['windows'])})"
                f", {arm['syncs']} synchronizations in {LM_WINDOW_STEPS} "
                f"steps, KV puts {puts}, {arm['bytes_per_s']:.0f} B/s, "
                f"teardown {arm['shutdown_s']:.3f} s")
    finally:
        kv.stop()
        if not hvd.is_initialized():
            hvd.init()
    base = arms["no_kv"]
    for name in ("kv_defaults", "kv_fast"):
        check(arms[name]["losses"] == base["losses"],
              f"phase 24: {name}'s losses {arms[name]['losses']} are not "
              f"bitwise the no-KV arm's {base['losses']}")
        check(arms[name]["syncs"] <= base["syncs"],
              f"phase 24: {name} synchronized {arms[name]['syncs']} times "
              f"in {LM_WINDOW_STEPS} steps, the no-KV arm "
              f"{base['syncs']}: {arms[name]['sync_samples']}")
        arms[name]["tokens_per_s_ratio"] = \
            arms[name]["tokens_per_s"] / base["tokens_per_s"]
    out["telemetry"] = {
        name: {k: a[k] for k in ("tokens_per_s", "windows", "syncs",
                                 "puts", "bytes_per_s", "shutdown_s",
                                 "wall_s", "wired")
               if k in a} | ({"tokens_per_s_ratio": a["tokens_per_s_ratio"]}
                             if "tokens_per_s_ratio" in a else {})
        for name, a in arms.items()}
    log(f"  (a) losses bitwise across the arms; tokens/s against no KV: "
        f"defaults {arms['kv_defaults']['tokens_per_s_ratio']:.4f}, every "
        f"interval {CP_INTERVAL} s "
        f"{arms['kv_fast']['tokens_per_s_ratio']:.4f}")
    want = base["losses"][:CP_STEPS]

    # (b) the primary killed under a training worker
    root = tempfile.mkdtemp(prefix="hvd_cp_")
    hosts = os.path.join(root, "hosts")
    with open(hosts, "w") as f:
        f.write("localhost:1\n")
    p1, p2 = find_free_port(), find_free_port()
    reps = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    rdv_spec = ",".join(reps)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        hvd.__file__)))
    base_env = {k: v for k, v in os.environ.items()
                if k not in (env_mod.HOROVOD_TPU_WORLD_VERSION,
                             env_mod.HOROVOD_TPU_COORDINATOR,
                             env_mod.HOROVOD_TPU_NUM_PROCESSES,
                             env_mod.HOROVOD_TPU_PROCESS_ID,
                             env_mod.HOROVOD_TPU_FAULTS) + CP_KNOBS}
    base_env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root, base_env.get("PYTHONPATH", "")])
    me = [sys.executable, os.path.abspath(__file__)]
    pkg_args = (["--package-root", pkg_root]
                if pkg_root != os.path.dirname(os.path.abspath(__file__))
                else [])
    standby_server = ElasticRendezvousServer(("127.0.0.1", p2))
    standby_server.start()
    spawned = []
    standby = primary = worker = None
    primary_log = open(os.path.join(root, "primary.log"), "w")
    worker_log = open(os.path.join(root, "worker.log"), "w")
    try:
        primary = subprocess.Popen(
            me + ["--cp-primary", str(p1), str(p2), hosts] + pkg_args,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=primary_log, env=base_env, text=True)
        _read_line(primary, "REPL", 120)
        # the standby's lease clock starts now, with the primary serving
        standby_server.enable_replication(
            reps[1], reps, role="standby", config=ReplicationConfig.from_env())
        standby = DriverStandby(
            standby_server, HostDiscoveryScript(f"cat {hosts}"), min_np=1,
            max_np=1, timeout=60.0, create_worker_fn=spawned.append)
        standby.start()
        primary.stdin.write("GO\n")
        primary.stdin.flush()
        _read_line(primary, "V1", 60)
        wenv = dict(base_env, **{
            env_mod.HOROVOD_ELASTIC: "1",
            env_mod.HOROVOD_HOSTNAME: "localhost",
            env_mod.HOROVOD_LOCAL_RANK: "0",
            env_mod.HOROVOD_TPU_COORDINATOR: COORDINATOR_VIA_RENDEZVOUS,
            env_mod.HOROVOD_GLOO_RENDEZVOUS_ADDR: rdv_spec,
            env_mod.HOROVOD_GLOO_RENDEZVOUS_PORT: str(p1),
            env_mod.HOROVOD_TPU_METRICS_INTERVAL: str(CP_INTERVAL),
            env_mod.HOROVOD_TPU_TRACE_INTERVAL: str(CP_INTERVAL),
            env_mod.HOROVOD_TPU_SHUTDOWN_TIMEOUT: "30",
            "CP_SMOKE_OUT": root})
        t_spawn = time.time()
        worker = subprocess.Popen(me + ["--cp-worker"] + pkg_args,
                                  stdout=worker_log,
                                  stderr=subprocess.STDOUT, env=wenv)
        marker = os.path.join(root, f"step{CP_KILL_AFTER}")
        deadline = time.monotonic() + CP_CHILD_TIMEOUT
        while not os.path.exists(marker) and worker.poll() is None and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        check(os.path.exists(marker),
              f"phase 24: the worker never reached step {CP_KILL_AFTER} "
              f"(exit {worker.poll()})")
        t_kill = time.time()
        os.kill(primary.pid, signal.SIGKILL)
        primary.wait(timeout=30)
        t_kv = t_drv = None
        deadline = time.monotonic() + CP_PROMOTE_TIMEOUT
        while time.monotonic() < deadline and (t_kv is None or
                                               t_drv is None):
            if t_kv is None and standby_server.replication.is_primary():
                t_kv = time.time()
            if t_drv is None and standby.driver is not None:
                t_drv = time.time()
            time.sleep(0.005)
        check(t_kv is not None, "phase 24: the standby's KV replica never "
              f"promoted: {standby_server.replication.status()}")
        check(t_drv is not None, "phase 24: the standby's driver tier never "
              "promoted")
        rc = worker.wait(timeout=CP_CHILD_TIMEOUT)
        t_exit = time.time()
        promoted = standby.driver
        deadline = time.monotonic() + 30
        while not promoted.finished() and time.monotonic() < deadline:
            time.sleep(0.05)
        worker_log.flush()
        with open(os.path.join(root, "worker.log")) as f:
            tail = f.read()[-6000:]
        check(rc == 0, f"phase 24: the worker exited {rc}:\n{tail}")
        res_path = os.path.join(root, "cp_result.json")
        check(os.path.exists(res_path), f"phase 24: no worker result:\n{tail}")
        with open(res_path) as f:
            res = json.load(f)
        audit = standby_server.replication.audit_journal()
        check(audit["gaps"] == [], f"phase 24: journal gaps {audit}")
        check(promoted.finished() and promoted.error_message is None,
              f"phase 24: the promoted driver did not finish "
              f"({promoted.error_message}); results {promoted.get_results()}")
        results = promoted.get_results()
        check(results.get("localhost:0", (None, None))[1] == 0,
              f"phase 24: the promoted driver holds {results}")
        check(res["lives"] == 1 and res["restores"] == 0 and not spawned,
              f"phase 24: the worker ran {res['lives']} lives with "
              f"{res['restores']} restores; relaunched {spawned}")
        got = [res["losses"][str(s)] for s in range(1, CP_STEPS + 1)]
        bitwise = got == want
        check(bitwise, f"phase 24: the worker's losses {got} against the "
              f"uninterrupted run's {want}")
        for k6 in FLASH_KERNELS:
            check(res["counts"][k6] == LM_DIMS["n_layers"] * CP_STEPS,
                  f"phase 24: the worker launched {k6} {res['counts'][k6]} "
                  f"times, expected {LM_DIMS['n_layers'] * CP_STEPS}")
        # the survivor's scrape: the failover and promotion counters (the
        # standby's own registry renders as rank="driver") and the
        # worker's snapshot published after the kill (its failovers)
        samples = _prom_samples(_scrape(p2))
        names = {n for n, _, _ in samples}
        for fam in ("hvd_tpu_kv_failover_total",
                    "hvd_tpu_kv_promotions_total",
                    "hvd_tpu_driver_promotions_total"):
            check(fam in names, f"phase 24: the survivor's scrape lacks "
                  f"{fam}")
        check(any(n == "hvd_tpu_kv_failover_total" and ls.get("rank") == "0"
                  and v > 0 for n, ls, v in samples),
              "phase 24: the survivor holds no snapshot of rank 0 "
              "published after the kill")
        # a recovery of kind driver_failover counts a promotion over an
        # in-flight resize (the reference's rule); none was in flight
        fo = [v for n, ls, v in samples
              if n == "hvd_tpu_elastic_recoveries_total"
              and ls.get("kind") == "driver_failover"]
        check(not promoted.resume_needed(),
              "phase 24: the promoted driver holds a pending resize")
        put_data_into_kvstore(rdv_spec, None, "faults", "spec",
                              b"test.cp_post=1*noop()", timeout=10)
        armed = faults.arm_from_kv(rdv_spec, timeout=10)
        faults.disarm()
        check(armed is True, "phase 24: arm_from_kv failed through the "
              "survivor")
    finally:
        faults.disarm()
        for proc in (primary, worker):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if standby is not None:
            standby.stop()
        standby_server.stop()
        primary_log.close()
        worker_log.close()
        shutil.rmtree(root, ignore_errors=True)
    steps = [res["step_s"][str(s)] for s in range(1, CP_STEPS + 1)]
    kill_step = next((s for s in range(1, CP_STEPS + 1)
                      if res["t_step_end"][str(s)] >= t_kill), None)
    # the others past the first (the first warms cuBLAS and the allocator)
    others = [t for s, t in enumerate(steps, 1)
              if s not in (1, kill_step)]
    med = statistics.median(others)
    out["failover"] = {
        "kill_to_kv_promotion_s": t_kv - t_kill,
        "kill_to_driver_promotion_s": t_drv - t_kill,
        "spawn_to_kill_s": t_kill - t_spawn, "kill_to_exit_s": t_exit - t_kill,
        "lease_timeout_s": ReplicationConfig.from_env().lease_timeout,
        "step_s": steps, "step_spanning_kill": kill_step,
        "step_median_s": med, "step_max_s": max(steps),
        "step_max_other_s": max(others),
        "losses": got, "bitwise": bitwise, "lives": res["lives"],
        "restores": res["restores"], "relaunches": len(spawned),
        "worker_failovers": res["failovers"], "worker_shed": res["shed"],
        "worker_trace_publish_failures": res["trace_publish_failures"],
        "worker_shutdown_s": res["shutdown_s"],
        "kill_to_train_end_s": res["t_train_end"] - t_kill,
        "driver_failover_recoveries": fo, "journal": audit,
        "launches": res["counts"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  (b) kill -> KV promotion {t_kv - t_kill:.3f} s, -> driver "
        f"promotion {t_drv - t_kill:.3f} s; the worker finished "
        f"{CP_STEPS} steps in its first life (0 restores, 0 relaunches), "
        f"losses bitwise; step s {', '.join(f'{t:.3f}' for t in steps)} "
        f"(step {kill_step} spans the kill; median of steps 2-"
        f"{CP_STEPS} but that one {med:.3f}, max {max(others):.3f}; the "
        f"last step ended {res['t_train_end'] - t_kill:.3f} s after the "
        f"kill); requests failed over {res['failovers']}, trace publishes "
        f"failed {res['trace_publish_failures']}, shed {res['shed']}; the "
        f"worker's teardown "
        f"{res['shutdown_s']:.3f} s; journal {audit['entries']} entries, "
        f"no gap; K6 {res['counts']}; phase {out['phase_s']:.1f} s")
    # K6's launches on the phase's main path: the arms' in this process
    # and the worker's
    launches = {k: sum(a["launches"][k] for a in arms.values())
                + res["counts"][k] for k in FLASH_KERNELS}
    return out, launches


def cp_primary(argv) -> int:
    """Phase 24 (b)'s primary (``--cp-primary P1 P2 HOSTS``): a replicated
    ``ElasticRendezvousServer`` on port P1 (role primary, P2 the standby)
    and, once the parent writes a line, a journaled ``ElasticDriver`` over
    ``cat HOSTS`` whose worker the parent spawns. Prints REPL, then V1 once
    the first world is active, then serves until it is killed."""
    from horovod_tpu_torch.elastic.discovery import HostDiscoveryScript
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.elastic.failover import DriverJournal
    from horovod_tpu_torch.elastic.rendezvous import ElasticRendezvousServer
    from horovod_tpu_torch.runner.replication import ReplicationConfig
    p1, p2, hosts = int(argv[0]), int(argv[1]), argv[2]
    reps = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    server = ElasticRendezvousServer(("127.0.0.1", p1))
    server.start()
    server.enable_replication(reps[0], reps, role="primary",
                              config=ReplicationConfig.from_env())
    print("REPL", flush=True)
    sys.stdin.readline()
    driver = ElasticDriver(server, HostDiscoveryScript(f"cat {hosts}"),
                           min_np=1, max_np=1, timeout=60)
    server.set_driver(driver)
    driver.attach_journal(DriverJournal(server))
    # the parent spawns the worker, so it outlives this process's SIGKILL
    # as a worker on another host outlives its driver's
    driver.start(1, lambda slot: print(f"START {slot.hostname}:"
                                       f"{slot.local_rank}", flush=True))
    print("V1", flush=True)
    while True:
        time.sleep(1)


def cp_child(torch, hvd, K, tm, log) -> int:
    """Phase 24 (b)'s worker (``--cp-worker``): the flagship LM under
    ``@hvd.elastic.run``, CP_STEPS steps, a commit every CP_COMMIT; after
    step CP_KILL_AFTER it leaves a marker file for the parent, which kills
    the primary. Writes ``cp_result.json`` into ``$CP_SMOKE_OUT``: losses
    and step seconds by step, the lives of the training function, the
    restores, its K6 launches, its KV failovers and shed bytes, and its
    teardown seconds."""
    from horovod_tpu_torch.elastic import TPUState
    from horovod_tpu_torch.metrics import counter_total, registry
    out_dir = os.environ["CP_SMOKE_OUT"]
    rec = {"losses": {}, "step_s": {}, "t_step_end": {}, "lives": 0,
           "restores": 0}
    hvd.init()
    dev = hvd.device()
    _, model, step = make_lm_trainer(torch, hvd, tm, dev, 4)

    class _State(TPUState):
        def restore(self):
            rec["restores"] += 1
            super().restore()

    state = _State(params=model, opt_state=step.opt, step=0)
    K.reset_launch_counts()

    @hvd.elastic.run
    def train(state):
        rec["lives"] += 1
        while state.step < CP_STEPS:
            t0 = time.perf_counter()
            loss = float(step())
            state.step += 1
            rec["step_s"][state.step] = time.perf_counter() - t0
            rec["t_step_end"][state.step] = time.time()
            rec["losses"][state.step] = loss
            if state.step % CP_COMMIT == 0:
                state.commit()
            if state.step == CP_KILL_AFTER:
                open(os.path.join(out_dir, f"step{state.step}"), "w").close()
        rec["counts"] = {k: K.launch_counts()[k] for k in FLASH_KERNELS}
        rec["t_train_end"] = time.time()
        return state.step

    train(state)
    t0 = time.perf_counter()
    hvd.shutdown()
    rec["shutdown_s"] = time.perf_counter() - t0
    # the KV client's and the publishers' counters over the whole life:
    # the result report and the final flushes ran after the kill
    snap = registry().snapshot()
    rec["failovers"] = {
        json.dumps(labels, sort_keys=True): v for labels, v in
        snap["counters"].get("hvd_tpu_kv_failover_total",
                             {"values": []})["values"]}
    rec["shed"] = counter_total(snap, "hvd_tpu_kv_shed_bytes_total")
    rec["trace_publish_failures"] = counter_total(
        snap, "hvd_tpu_trace_publish_failures_total")
    with open(os.path.join(out_dir, "cp_result.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _est_layout_bytes(cfg) -> int:
    """Bytes of one estimator checkpoint's tensors: the fp32 parameters
    (the tied embedding, each layer's norms, projections and FFN, the final
    norm) and AdamW's two moments of each."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    params = cfg.vocab_size * d + L * (4 * d * d + 2 * d * f + 2 * d) + d
    return 3 * 4 * params


def run_estimator_path(torch, hvd, K, tm, dev, smi, log, dense_tok_s):
    """Phase 25: the estimator layer on the flagship LM (``LM_DIMS``, bf16
    on fp32 parameters, ``attention="flash"``, AdamW with phase 5's
    settings, batch 4 x 2048) at world size 1. The data: EST_TRAIN_SEQS
    sequences of 2049 tokens from a seed, written as a ``ShardedNpzDataset``
    of EST_SHARDS files (``x`` the first 2048 tokens, ``y`` the last), and
    EST_VAL_SEQS validation sequences, in a temporary directory the phase
    removes, after ``shutil.disk_usage`` showed room for two generations.

    (a) run A: ``Estimator.fit`` for EST_EPOCHS epochs, no store, a
        ``loss`` metric on the validation sequences;
    (b) run B: ``fit`` of 1 epoch into a ``LocalStore``, then a new
        ``Estimator`` of EST_EPOCHS epochs on the same store resumes at
        epoch 1: its history is that epoch alone, the store's steps [0,
        1], its train and validation losses and every final parameter
        bitwise run A's; run A's epoch 1 below its epoch 0, every loss
        finite; ``predict`` on one sequence gives float32 logits (1, 2048,
        vocab), finite;
    (c) the callbacks: a fresh model through EST_EPOCHS x EST_CB_STEPS
        steps of a hand loop under one ``CallbackList``
        (``BroadcastGlobalVariablesCallback(0)``,
        ``LearningRateWarmupCallback`` over ``scaled_lr(AdamW)`` wrapped
        by ``DistributedOptimizer``, ``MetricAverageCallback``,
        ``BestModelCheckpoint``, ``CommitStateCallback`` over a
        ``TPUState`` every EST_CB_STEPS batches): each step's lr the
        warm-up table x 3e-4, ``set_lr_scale`` with no host
        synchronization, EST_EPOCHS commits, the best file on rank 0.

    Records the estimator's tokens/s (a step's period: CUDA events the
    loss function records at each step's start, gaps within an epoch)
    against phase 5's, the steps' median ms, ``save_checkpoint``'s and
    ``load_checkpoint``'s seconds and the bytes on disk, the resume's
    seconds (``fit``'s start to its first step), peak memory and the
    phase's seconds. Every K6 kernel once a layer and training step, the
    forward once more a layer and validation or ``predict`` call. Returns
    the summary and K6's launches."""
    import shutil
    import tempfile
    import numpy as np
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch.data import ShardedNpzDataset
    from horovod_tpu_torch.elastic import TPUState
    from horovod_tpu_torch.estimator import Estimator
    from horovod_tpu_torch.store import CHECKPOINT_FILE, LocalStore
    t_phase = time.perf_counter()
    check(hvd.size() == 1 and hvd.device() == dev,
          "phase 25 needs a size-1 world on the card")
    batch, seq = 4, LM_DIMS["max_seq"]
    cfg = tm.TransformerConfig(dtype=torch.bfloat16, attention="flash",
                               **LM_DIMS)
    root = tempfile.mkdtemp(prefix="hvd_est_")
    out = {"card": smi, "batch": batch}
    K.reset_launch_counts()
    try:
        gen_bytes = _est_layout_bytes(cfg)
        tokens = np.random.RandomState(25).randint(
            0, cfg.vocab_size, (EST_TRAIN_SEQS + EST_VAL_SEQS, seq + 1))
        shard_bytes = 2 * EST_TRAIN_SEQS * seq * tokens.itemsize
        free = shutil.disk_usage(root).free
        need = 2 * gen_bytes + shard_bytes + 2**30
        log(f"  {gen_bytes / 1e9:.3f} GB a generation; {free / 1e9:.1f} GB "
            f"free under {root} (need {need / 1e9:.1f})")
        check(free >= need, f"phase 25: {free} bytes free under {root}, "
              f"{need} needed for two generations and the shards")
        train = tokens[:EST_TRAIN_SEQS]
        ds = ShardedNpzDataset.write_shards(os.path.join(root, "shards"),
                                            train[:, :-1], train[:, 1:],
                                            EST_SHARDS)
        val = (tokens[EST_TRAIN_SEQS:, :-1], tokens[EST_TRAIN_SEQS:, 1:])

        class TimedStore(LocalStore):
            """The estimator's store, its saves and loads timed."""
            save_s, load_s = [], []

            def save_checkpoint(self, run_id, step, tree):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = super().save_checkpoint(run_id, step, tree)
                self.save_s.append(time.perf_counter() - t0)
                return path

            def load_checkpoint(self, run_id, step=None):
                t0 = time.perf_counter()
                tree = super().load_checkpoint(run_id, step)
                self.load_s.append(time.perf_counter() - t0)
                return tree

        def estimator(epochs, store, marks):
            def loss_fn(model, x, y):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((time.perf_counter(), ev))
                return tm.lean_lm_loss(model, x, y)
            return Estimator(
                init_fn=lambda g: tm.Transformer(cfg, generator=g),
                forward_fn=lambda m, t: m.forward_aux(
                    t, logits_f32=False)[0],
                loss_fn=loss_fn, optimizer=lambda ps: _adamw(torch, ps),
                store=store, run_id="lm", epochs=epochs, batch_size=batch,
                metric_fns={"loss": tm.lean_lm_loss})

        steps_per_epoch = EST_TRAIN_SEQS // batch
        # (a) run A, uninterrupted
        torch.cuda.reset_peak_memory_stats(dev)
        marks_a = []
        t0 = time.perf_counter()
        run_a = estimator(EST_EPOCHS, None, marks_a).fit(ds, val_data=val)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        hist_a = run_a.history
        check(sum(p.numel() for p in run_a.params.parameters()) * 12
              == gen_bytes, "phase 25: the generation's byte count is not "
              "the model's")
        check([h["epoch"] for h in hist_a] == list(range(EST_EPOCHS))
              and len(marks_a) == EST_EPOCHS * steps_per_epoch,
              f"phase 25 (a): history {hist_a}, {len(marks_a)} steps")
        losses = [h[k] for h in hist_a for k in ("train_loss", "val_loss")]
        check(all(math.isfinite(v) for v in losses)
              and hist_a[1]["train_loss"] < hist_a[0]["train_loss"],
              f"phase 25 (a): losses {hist_a}")
        gaps = [marks_a[i][1].elapsed_time(marks_a[i + 1][1])
                for i in range(len(marks_a) - 1)
                if (i + 1) % steps_per_epoch]
        step_ms = statistics.median(gaps)
        tok_s = batch * seq / (step_ms / 1e3)
        log(f"  (a) {EST_EPOCHS} epochs of {steps_per_epoch} steps in "
            f"{fit_s:.2f} s (the model's build included); losses "
            f"{[(h['train_loss'], h['val_loss']) for h in hist_a]}; a step "
            f"{step_ms:.2f} ms (median of {len(gaps)}, range "
            f"{min(gaps):.2f}-{max(gaps):.2f}), {tok_s:.1f} tokens/s, "
            f"{tok_s / dense_tok_s:.4f} of phase 5's; peak {peak:.2f} GiB")

        # (b) run B: one epoch into the store, then resumed
        store = TimedStore(os.path.join(root, "store"))
        estimator(1, store, []).fit(ds, val_data=val)
        check(store.checkpoint_steps("lm") == [0],
              f"phase 25 (b): steps {store.checkpoint_steps('lm')}")
        marks_b = []
        t0 = time.perf_counter()
        run_b = estimator(EST_EPOCHS, store, marks_b).fit(ds, val_data=val)
        resume_s = marks_b[0][0] - t0
        hist_b = run_b.history
        check([h["epoch"] for h in hist_b] == [1]
              and store.checkpoint_steps("lm") == [0, 1],
              f"phase 25 (b): history {hist_b}, steps "
              f"{store.checkpoint_steps('lm')}")
        check((hist_b[0]["train_loss"], hist_b[0]["val_loss"])
              == (hist_a[1]["train_loss"], hist_a[1]["val_loss"]),
              f"phase 25 (b): the resumed epoch's losses {hist_b[0]} are "
              f"not run A's {hist_a[1]}")
        a_state, b_state = (r.params.state_dict() for r in (run_a, run_b))
        differ = [k for k in a_state if not torch.equal(a_state[k],
                                                       b_state[k])]
        check(not differ, f"phase 25 (b): parameters not bitwise run A's: "
              f"{differ}")
        logits = run_b.predict(val[0][:1])
        check(logits.dtype == np.float32
              and logits.shape == (1, seq, cfg.vocab_size)
              and np.isfinite(logits).all(),
              f"phase 25 (b): predict gave {logits.dtype} {logits.shape}")
        disk = [os.path.getsize(os.path.join(store._step_dir("lm", s),
                                             CHECKPOINT_FILE))
                for s in (0, 1)]
        log(f"  (b) resumed at epoch 1 in {resume_s:.2f} s (fit's start to "
            f"its first step: the model's build, the load "
            f"{store.load_s[-1]:.2f} s, load_state_dict); the epoch's losses "
            f"and {len(a_state)} tensors bitwise run A's; save_checkpoint "
            f"{', '.join(f'{t:.2f}' for t in store.save_s)} s, "
            f"{', '.join(str(b) for b in disk)} bytes on disk; predict "
            f"{logits.dtype} {logits.shape}")
        out.update(
            run_a=hist_a, run_b=hist_b, fit_s=fit_s, step_ms=step_ms,
            step_ms_range=[min(gaps), max(gaps)], steps_timed=len(gaps),
            tokens_per_s=tok_s, tokens_per_s_of_phase5=tok_s / dense_tok_s,
            peak_gib=peak, save_s=list(store.save_s),
            load_s=list(store.load_s), disk_bytes=disk, resume_s=resume_s,
            bitwise=True)
        del run_a, run_b, a_state, b_state, logits
        torch.cuda.empty_cache()

        # (c) the callbacks over a hand loop
        model = tm.Transformer(cfg, generator=torch.Generator().manual_seed(
            0)).to(dev)
        inner = _adamw(torch, model.parameters())
        opt = hvd.DistributedOptimizer(cb.scaled_lr(inner), op=hvd.Average)
        loop = cb.TrainLoopState(params=model, opt_state=opt)
        elastic_state = TPUState(params=model, opt_state=opt, batch=0)
        best = os.path.join(root, "best.pt")
        callbacks = cb.CallbackList([
            cb.BroadcastGlobalVariablesCallback(0),
            cb.LearningRateWarmupCallback(warmup_epochs=EST_EPOCHS,
                                          steps_per_epoch=EST_CB_STEPS,
                                          size=EST_CB_SIZE),
            cb.MetricAverageCallback(),
            cb.BestModelCheckpoint(best, monitor="loss"),
            cb.CommitStateCallback(elastic_state,
                                   batches_per_commit=EST_CB_STEPS)])
        callbacks.on_train_begin(loop)
        lrs, syncs, epoch_losses = [], [], []
        for epoch in range(EST_EPOCHS):
            loop.epoch = epoch
            callbacks.on_epoch_begin(loop)
            step_losses = []
            batches = iter(ds.iter_batches(0, 1, batch, seed=epoch))
            for b in range(EST_CB_STEPS):
                bx, by = next(batches)
                _, s = _sync_count(torch,
                                   lambda: callbacks.on_batch_begin(loop, b))
                syncs += s
                lrs.append(inner.param_groups[0]["lr"])
                x = torch.from_numpy(bx).to(dev)
                y = torch.from_numpy(by).to(dev)
                opt.zero_grad()
                loss = tm.lean_lm_loss(model, x, y)
                loss.backward()
                opt.step()
                step_losses.append(loss.detach())
                callbacks.on_batch_end(loop, b)
            batches.close()
            logs = {"loss": float(torch.stack(step_losses).mean())}
            callbacks.on_epoch_end(loop, logs)
            epoch_losses.append(logs["loss"])

        def warm(frac):
            return (1.0 / EST_CB_SIZE) * (
                min(frac / EST_EPOCHS, 1.0) * (EST_CB_SIZE - 1) + 1.0)
        want = [3e-4 * warm(e + b / EST_CB_STEPS)
                for e in range(EST_EPOCHS) for b in range(EST_CB_STEPS)]
        commits = getattr(elastic_state, "_commit_count", 0)
        saved = torch.load(best, map_location="cpu", weights_only=True)
        check(all(math.isclose(g, w, rel_tol=1e-12)
                  for g, w in zip(lrs, want)) and len(lrs) == len(want),
              f"phase 25 (c): lrs {lrs}, the warm-up table x 3e-4 {want}")
        check(not syncs, f"phase 25 (c): set_lr_scale synchronized: {syncs}")
        check(commits == EST_EPOCHS, f"phase 25 (c): {commits} commits, "
              f"expected {EST_EPOCHS}")
        check(saved["loss"] == min(epoch_losses)
              and set(saved["params"]) == set(model.state_dict()),
              f"phase 25 (c): the best file holds {saved.get('loss')} of "
              f"{epoch_losses}")
        check(all(math.isfinite(v) for v in epoch_losses),
              f"phase 25 (c): losses {epoch_losses}")
        log(f"  (c) lrs {', '.join(f'{v:.6g}' for v in lrs)} (the warm-up "
            f"table x 3e-4); {commits} commits; no synchronization in "
            f"set_lr_scale; the best file at epoch {saved['epoch']} "
            f"(loss {saved['loss']:.4f}); epoch losses {epoch_losses}")
        out["callbacks"] = {"lrs": lrs, "commits": commits,
                            "epoch_losses": epoch_losses,
                            "best_epoch": saved["epoch"]}
        del model, inner, opt, loop, elastic_state, saved
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    counts = K.launch_counts()
    steps = (EST_EPOCHS + 1 + 1) * steps_per_epoch + EST_EPOCHS * EST_CB_STEPS
    forwards = EST_EPOCHS + 1 + 1 + 1   # validations and predict
    for name in FLASH_KERNELS:
        want_n = cfg.n_layers * (steps + (forwards if name == "flash_fwd"
                                          else 0))
        check(counts[name] == want_n, f"phase 25: {name} launched "
              f"{counts[name]} times, expected {want_n}")
    out["launches"] = {name: counts[name] for name in FLASH_KERNELS}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  K6 {out['launches']}; phase {out['phase_s']:.1f} s ({smi})")
    return out, out["launches"]


def resnet_only(torch, hvd, K, ResNet50, dev, args, smi, log):
    """Phase 2 alone, with the profile: ResNet-50's img/s, busy share and
    kernel launches per step, as a JSON last line (``--resnet-only``; with
    ``--package-root`` of a parent checkout, its numbers in the same
    call)."""
    try:
        hvd.init()
        model, step = make_trainer(torch, hvd, ResNet50, dev, args.batch)
        K.reset_launch_counts()
        losses, img_s, rates = train(torch, step, args.batch, args.warmup,
                                     args.steps, args.windows, log)
        check(all(v == v and abs(v) != float("inf") for v in losses)
              and losses[-1] < losses[0], "ResNet-50's loss did not fall")
        prof = profile_steps(torch, step, max(args.profile, 1), log)
        n_steps = (args.warmup + args.windows * args.steps
                   + max(args.profile, 1))
        counts = K.launch_counts()
        check(counts["bn_stats"] == 53 * n_steps
              and counts["bn_bwd_stats"] == 53 * n_steps,
              f"BN kernels launched {counts['bn_stats']} and "
              f"{counts['bn_bwd_stats']} times, expected {53 * n_steps}")
    finally:
        hvd.shutdown()
    log(f"  {img_s:.1f} img/s (windows: "
        f"{', '.join(f'{r:.1f}' for r in rates)})")
    print(smi)
    print(json.dumps({"resnet_only": dict(img_per_s=img_s,
                                          img_per_s_windows=rates,
                                          losses=losses, **prof)}))
    return 0


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
    ap.add_argument("--profile", type=int, default=3, metavar="N",
                    help="after the timed steps of ResNet-50 and of the LM, "
                         "trace N more with torch.profiler and print device "
                         "time by layer, the busy share and the kernel "
                         "launches per step")
    ap.add_argument("--resnet-only", action="store_true",
                    help="build, then only train and profile ResNet-50 "
                         "(phase 2) and print its img/s, busy share and "
                         "launches per step as the last line")
    ap.add_argument("--trace-probe", type=int, default=0, metavar="N",
                    help="build, then only trace phase 4's K6 D640 step N "
                         "times unpadded and N times padded and print how "
                         "many traces lost its kernels as the last line")
    ap.add_argument("--obs-arm", choices=OBS_ARMS, default=None,
                    help="build, then only run one overhead process of "
                         "phase 19 (its knobs already in the environment) "
                         "and print its numbers as the last line")
    ap.add_argument("--elastic-worker", action="store_true",
                    help="build, then only run one life of phase 23's "
                         "elastic worker (launched by the port's elastic "
                         "launcher, $ELASTIC_SMOKE_OUT set)")
    ap.add_argument("--replay-trace", action="store_true",
                    help="build, then only trace phase 15's replayed "
                         "reduction in this fresh process and print the "
                         "trace as the last line")
    ap.add_argument("--cp-primary", nargs=3, default=None,
                    metavar=("P1", "P2", "HOSTS"),
                    help="run phase 24's KV primary and journaled driver "
                         "(no card, no build) until killed")
    ap.add_argument("--cp-worker", action="store_true",
                    help="build, then only run phase 24's elastic worker "
                         "($CP_SMOKE_OUT set)")
    ap.add_argument("--package-root", default=None, metavar="DIR",
                    help="import horovod_tpu_torch from DIR (a parent "
                         "checkout, measured with --resnet-only in the same "
                         "call) instead of this script's directory")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.package_root) if args.package_root
                    else os.path.dirname(os.path.abspath(__file__)))
    if args.cp_primary:
        return cp_primary(args.cp_primary)
    # the repo's kernel configuration of the main path: the pack kernel on
    # (read once at init, as in the reference)
    os.environ["HOROVOD_PALLAS_PACK"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.engine import bucket_by_size
    from horovod_tpu_torch.models import transformer as tm
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.models.vit import ViT_B16, ViT_Tiny
    from horovod_tpu_torch.ops import adasum as adasum_ops
    from horovod_tpu_torch.ops import build, kernels as K
    from horovod_tpu_torch.ops.fused_batch_norm import FusedBatchNorm
    from horovod_tpu_torch.ops.sync_batch_norm import SyncBatchNorm
    from horovod_tpu_torch.parallel import flash_attention, ring_attention

    def log(msg):
        print(msg, flush=True)

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"from {os.path.dirname(hvd.__file__)}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    if args.resnet_only:
        return resnet_only(torch, hvd, K, ResNet50, dev, args, smi, log)
    if args.trace_probe:
        return trace_probe(torch, K, dev, args.trace_probe, smi, log)
    if args.elastic_worker:
        return elastic_child(torch, hvd, K, tm, log)
    if args.cp_worker:
        return cp_child(torch, hvd, K, tm, log)
    if args.replay_trace:
        return replay_trace_child(torch, hvd, K, ResNet50, bucket_by_size,
                                  dev, args.batch)
    if args.obs_arm:
        return obs_child(torch, hvd, tm, ResNet50, dev, args.obs_arm,
                         [tuple(p.shape) for p in ResNet50(
                             num_classes=1000, fused_bn=True).parameters()],
                         log)
    ptxas = attention_ptxas(build, log)
    check(all(r["spill_bytes"] == 0 for r in ptxas.values()),
          f"an attention kernel spills: {ptxas}")
    bn_regs = bn_ptxas(build, log)
    check(bn_regs["spill_bytes"] == 0, f"a BN kernel spills: {bn_regs}")

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
        bn_floor = bn_measure_floor(torch, K, dev, flush, args.reps, log)
        check_bn_inputs(torch, K, dev, log)
        bn_launches = bn_module_launches(torch, FusedBatchNorm, dev, log)
        param_shapes = [tuple(p.shape) for p in ResNet50(
            num_classes=1000, fused_bn=True).parameters()]
        pack_row, pack_grads = check_pack_kernel(
            torch, K, bucket_by_size, dev, param_shapes, flush, args.reps,
            log)
        check(pack_row["buckets"] == 2,
              f"{pack_row['buckets']} buckets at 64 MB, expected 2")
        pack_out_row = check_pack_out_kernel(torch, K, bucket_by_size, dev,
                                             pack_grads, flush, args.reps,
                                             log)
        del pack_grads
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
        resnet_profile = (profile_steps(torch, step, args.profile, log)
                          if args.profile else None)
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
        flash_rows, fp32_entries, attention = check_flash_kernels(
            torch, K, dev, flush, args.reps, log)
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

        log(f"phase 12: ViT_Tiny (head dim 16) in fp32 through the Hopper "
            f"tf32 forward, dk/dv and dq, batch "
            f"{TINY_BATCH}, {TINY_IMAGE} px, {TINY_STEPS} steps")
        tiny, tiny_counts = run_vit_tiny(torch, hvd, ViT_Tiny, K, dev, log)
        torch.cuda.empty_cache()

        log("phase 13: attention above head dim 128 through "
            "flash_attention_local and the zig-zag ring (the wide kernels)")
        K.reset_launch_counts()
        wide = run_wide_path(torch, K, ring_attention, flash_attention, dev,
                             log)
        wide_counts = K.launch_counts()
        log(f"  launches on the wide path: {wide_counts}")
        for name in WIDE_KERNELS:
            check(wide_counts[f"{name}_sm90_wide"] >= 1,
                  f"{name}_sm90_wide launched no time on the wide path")
        # the fp32 path: every kernel on the Hopper tf32 route, by its
        # counters and its trace
        for name in K6_ROUTED:
            check(wide_counts[f"{name}_sm90_tf32"] >= 1,
                  f"{name}_sm90_tf32 launched no time on the wide path")
        fp32 = [p for p in wide if p["dtype"] == "float32"]
        check(fp32 and all(p["routes"][name] == "sm90_tf32"
                           for p in fp32 for name in K6_ROUTED),
              "an fp32 launch ran off the Hopper tf32 route on the wide "
              "path")
        # no path ran an mma.sync kernel (flash_attn.cu builds none)
        check(not any("_mma_kernel" in k for p in wide
                      for k in p["traced_kernels"]),
              "a launch ran an mma.sync kernel on the wide path")
        torch.cuda.empty_cache()

        log(f"phase 14: SyncBatchNorm over ResNet-50's 53 BN layers, batch "
            f"{args.batch}, bf16 channels_last, forward and backward")
        sync_bn, sync_bn_counts = run_sync_bn_path(
            torch, K, SyncBatchNorm, FusedBatchNorm, dev, args.batch, log)
        torch.cuda.empty_cache()

        log(f"phase 15: step replay of ResNet-50's gradient reduction, "
            f"batch {args.batch}")
        replay, replay_counts = run_replay_path(
            torch, hvd, K, ResNet50, bucket_by_size, dev, args.batch, log)
        check(replay_counts["bn_stats"] == 53 * replay["steps"]
              and replay_counts["bn_bwd_stats"] == 53 * replay["steps"],
              f"BN kernels launched {replay_counts['bn_stats']} and "
              f"{replay_counts['bn_bwd_stats']} times in phase 15, expected "
              f"{53 * replay['steps']}")
        torch.cuda.empty_cache()

        log(f"phase 16: ZeRO-1, the flagship LM through "
            f"DistributedOptimizer(sharded=True) against the dense one, "
            f"batch 4 x {LM_DIMS['max_seq']} tokens")
        sharded, sharded_counts = run_sharded_path(torch, hvd, K, tm, dev,
                                                   log)
        torch.cuda.empty_cache()

        log("phase 17: the wire codecs' flat reduction of the flagship LM's "
            "gradients (int8, fp8, bf16) on the NCCL world of one")
        codec, codec_counts = run_codec_path(torch, hvd, K, tm,
                                             bucket_by_size, dev, log)
        torch.cuda.empty_cache()

        log("phase 18: the collective algorithms on the NCCL world of one: "
            "ResNet-50's gradients through the engine under each "
            "HOROVOD_TPU_COLLECTIVE_ALGO, the flagship LM's through the "
            "tree and the ladder, the two-phase alltoall")
        algo, algo_counts = run_algo_path(torch, hvd, K, tm, ResNet50,
                                          bucket_by_size, dev, log)
        torch.cuda.empty_cache()

        log("phase 19: observability: ResNet-50's reduction with every "
            "instrument on and off (synchronizations, the timeline, wire "
            "bytes, the memory gauge, the flight dump), then the overhead "
            f"in {OBS_ROUNDS} rounds of fresh processes per arm "
            f"({', '.join(OBS_ARMS)})")
        # the instruments are wired at init: the phase re-initialises
        hvd.shutdown()
        observability = run_observability_checks(torch, hvd, param_shapes,
                                                 dev, log)
        observability["overhead"] = run_observability_overhead(log)
        off_syncs = observability["overhead"]["arms"]["off"]["syncs"]
        check(observability["syncs_on"] <= min(off_syncs),
              f"phase 19: the instrumented world synchronized "
              f"{observability['syncs_on']} times, the bare ones "
              f"{off_syncs}")
        hvd.init()

        log(f"phase 20: the tensor axis's paths on the flagship LM's widths "
            f"at world size 1: the MoE-EP step (E{MOE_EXPERTS}, capacity "
            f"factor {MOE_FACTOR}) eager and replayed, make_train_step on "
            f"(1, 1, 1) with the MoE FFN and dense against "
            f"DistributedOptimizer")
        moe, moe_counts = run_moe_path(torch, hvd, K, tm, dev, smi, log)
        torch.cuda.empty_cache()

        log(f"phase 21: the pipelined flagship at pipe 1 (every hop a copy): "
            f"make_pp_train_step interleaved v={PP_VIRTUAL}, "
            f"{PP_MICRO} microbatches, against make_train_step, zb and "
            f"1f1b refused, make_pp_engine_train_step eager and replayed")
        pipeline, pp_counts = run_pipeline_path(torch, hvd, K, tm, dev, smi,
                                                log, tok_s)
        torch.cuda.empty_cache()

        log(f"phase 22: durable checkpointing of the flagship LM: AdamW "
            f"steps with no checkpoint directory, then snapshots every "
            f"{CKPT_INTERVAL} steps through the engine's step hook, a "
            f"restore into a fresh model and optimizer, the ZeRO-1 payload, "
            f"the failpoints")
        ckpt, ckpt_counts = run_checkpoint_path(torch, hvd, K, tm, dev, smi,
                                                log)
        torch.cuda.empty_cache()

        log(f"phase 23: elastic training of the flagship LM: "
            f"@hvd.elastic.run with TPUState, a commit every "
            f"{ELASTIC_COMMIT} steps, an injected HorovodInternalError after "
            f"step {ELASTIC_FAIL_AT} and a host update after step "
            f"{ELASTIC_NOTIFY_AT}, each reset a new NCCL world in this "
            f"process; then a worker killed after step {ELASTIC_KILL_AFTER}, "
            f"relaunched by the port's elastic launcher and restored from "
            f"the durable tier")
        elastic, elastic_counts = run_elastic_path(torch, hvd, K, tm, dev,
                                                   smi, log)
        torch.cuda.empty_cache()

        log(f"phase 24: the survivable control plane on the flagship LM: "
            f"the KV telemetry's cost in three fresh worlds (no KV, the "
            f"publishers at their defaults, every interval {CP_INTERVAL} "
            f"s), then a worker of {CP_STEPS} steps under a replicated "
            f"rendezvous whose primary (KV and driver) is SIGKILLed after "
            f"step {CP_KILL_AFTER}")
        control_plane, cp_counts = run_control_plane_path(
            torch, hvd, K, tm, dev, smi, log)
        torch.cuda.empty_cache()

        log(f"phase 25: the estimator on the flagship LM: Estimator.fit on "
            f"a ShardedNpzDataset of {EST_SHARDS} shards, {EST_EPOCHS} "
            f"epochs uninterrupted, then 1 into a LocalStore and resumed "
            f"(bitwise), predict; the training callbacks over a hand loop")
        estimator, est_counts = run_estimator_path(torch, hvd, K, tm, dev,
                                                   smi, log, tok_s)
    finally:
        hvd.shutdown()

    def kind(name):
        return "fwd" if name.endswith("_fwd") else "bwd"

    def wide_shape(name, row):
        """The phase-4 (K6) or phase-8 (K7) shape whose numbers the row
        ``<name>_<row>`` of an instance above head dim 128 carries."""
        return WIDE_ROWS[kind(name)][row][int(name.startswith("flash_seg"))]

    def wide_entry(name, row):
        shape = wide_shape(name, row)
        rows = seg_rows if name.startswith("flash_seg") else flash_rows
        return next(e for e in rows[name]["shapes"] if e["what"] == shape)

    def wide_launches(name, row):
        """The launches of the instance in phase 13 (checks, timing and
        trace): its route's counter over the 16-bit paths at the head dims
        it takes."""
        def takes(path):
            dp = K._flash_dim(path["shape"][3])
            return {"sm90_wide": dp <= 256, "sm90_d320": dp == 320,
                    "sm90_split": 320 < dp <= 512,
                    "sm90_deep": dp > DEEP_ABOVE[kind(name)]}[row]
        n = sum(p["path_launches"].get(f"{name}_sm90_wide", 0) for p in wide
                if takes(p))
        check(n >= 1, f"{name}_{row} launched no time on the wide path")
        return n

    def wide_work(name, row):
        shape = wide_shape(name, row)
        if name.startswith("flash_seg"):
            _, b, h, t, d, _, _ = next(x for x in SEG_SHAPES
                                       if x[0] == shape)
            text = f"bf16 D{d}, the FULL half-segment B{b} H{h} S{t // 2}"
        else:
            _, b, h, tq, _, d, _, _ = next(x for x in FLASH_SHAPES
                                           if x[0] == shape)
            text = f"bf16 D{d}, B{b} H{h} T{tq} causal"
        return text + "; launches: phase 13"

    def wide_row(name, row, line, source):
        entry = wide_entry(name, row)
        rows = seg_rows if name.startswith("flash_seg") else flash_rows
        # the deep kernels' other head dims
        deep = ({"shapes": [e for e in rows[name]["shapes"]
                            if e["shape"][-1] > DEEP_ABOVE[kind(name)]
                            and e["dtype"] != "float32"]}
                if row == "sm90_deep" else {})
        return dict(
            name=f"{name}_{row}", route="cuda", source=f"{src}/{source}",
            replaces=(f"horovod_tpu/parallel/ring_attention.py:{line}"
                      if name.startswith("flash_seg") else
                      "horovod_tpu/parallel/flash_attention.py:226"),
            launches=wide_launches(name, row), ok=True,
            work=wide_work(name, row),
            **{key: entry[key] for key in
               ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")},
            **deep, **ptxas[f"{name}_{row}"])

    def tf32_row(row, name, shape, phase):
        """The kernels-line row of an fp32 instance (TF32_ROWS): numbers at
        ``shape``, launches from ``phase``'s counts of the wrapper's Hopper
        tf32 route; the rows at phase 12's shape list every fp32-input
        shape of phases 4 and 8 under "shapes"."""
        entry = fp32_entries[shape][name]
        seg = "flash_seg" + name[len("flash"):]
        shapes = ([fp32_entries[w][name] for w in fp32_entries]
                  + [e for e in seg_rows[seg]["shapes"]
                     if e["dtype"] == "float32"]) if shape == TF32_SHAPE \
            else []
        counts = tiny_counts if phase == 12 else wide_counts
        line = {"flash_fwd": 169, "flash_bwd_dkdv": 188,
                "flash_bwd_dq": 194}[name]
        return dict(
            name=row, route="cuda", source=f"{src}/{flash_source(name)}",
            replaces="horovod_tpu/parallel/flash_attention.py:226 and "
                     f"horovod_tpu/parallel/ring_attention.py:{line}",
            launches=counts[f"{name}_sm90_tf32"], ok=True,
            work=(f"fp32 {shape} (B, H, Tq, Tk, D: {entry['shape']}, "
                  f"{'causal' if entry['causal'] else 'full'}), K6 and K7 "
                  f"alike; launches: phase {phase}"),
            **{key: entry[key] for key in
               ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")},
            **({"shapes": shapes} if shapes else {}),
            **ptxas[f"{name}_sm90_tf32"])

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
             lm_launches=lm_pack,
             replay_launches=replay_counts["pack_graph"],
             sharded_launches=sharded_counts["pack"],
             sharded_graph_launches=sharded_counts["pack_graph"],
             codec_launches=codec_counts["pack"],
             codec_graph_launches=codec_counts["pack_graph"],
             algo_launches=algo_counts["pack"],
             algo_graph_launches=algo_counts["pack_graph"],
             moe_launches=moe_counts["pack"],
             pp_launches=pp_counts["pack"]),
        # K1 into a ZeRO-1 bucket's padded buffer (out=): phase 16's
        # launches, phase 1's numbers
        dict(name="pack_out", route="cuda", source=f"{src}/pack.cu",
             replaces="horovod_tpu/ops/pallas_kernels.py:138",
             launches=sharded_counts["pack_out"],
             graph_launches=sharded_counts["pack_graph"],
             max_abs_err=pack_out_row["max_abs_err"],
             ms=pack_out_row["ms"], host_ms=pack_out_row["host_ms"],
             plain_ms=pack_out_row["plain_ms"],
             bound_ms=pack_out_row["bound_ms"], bound_by="bytes",
             library_ms=pack_out_row["library_ms"], ok=True,
             codec_launches=codec_counts["pack_out"],
             algo_launches=algo_counts["pack_out"],
             pp_launches=pp_counts["pack_out"],
             ckpt_launches=ckpt_counts["pack_out"],
             work=f"ResNet-50 fp32 gradients, 2 buckets at 64 MB, each with "
                  f"{PACK_OUT_TAIL} fp32 after it, into buffers padded for "
                  f"{PACK_OUT_RANKS} ranks; launches: phase 16 "
                  f"(codec_launches: phase 17; algo_launches: phase 18, "
                  f"the tree's and the ladder's buckets)"),
        dict(name="bn_stats", route="cuda", source=f"{src}/bn_stats.cu",
             replaces="horovod_tpu/ops/pallas_kernels.py:223",
             launches=counts["bn_stats"], bound_by="bytes",
             ok=True, work=f"53 BN layers of ResNet-50, batch {args.batch}, "
                           "the epilogue mode (raw_ms: the raw sums)",
             module_launches_per_layer=bn_launches, measure_floor=bn_floor,
             sync_bn_launches=sync_bn_counts["bn_stats"],
             **bn_regs,
             **bn_rows["bn_stats"]),
        dict(name="bn_bwd_stats", route="cuda", source=f"{src}/bn_stats.cu",
             replaces="horovod_tpu/ops/pallas_kernels.py:265",
             launches=counts["bn_bwd_stats"], bound_by="bytes", ok=True,
             work=f"53 BN layers of ResNet-50, batch {args.batch}, the "
                  "epilogue mode (raw_ms: the raw sums)",
             sync_bn_launches=sync_bn_counts["bn_bwd_stats"],
             **bn_regs, **bn_rows["bn_bwd_stats"]),
    ] + [
        # the forward and the custom-VJP backward of the jax library kernel
        # that flash_attention_local calls there
        dict(name=name, route="cuda", source=f"{src}/{flash_source(name)}",
             replaces="horovod_tpu/parallel/flash_attention.py:226",
             launches=lm_counts[name], vit_launches=vit_counts[name],
             moe_launches=moe_counts[name], pp_launches=pp_counts[name],
             ckpt_launches=ckpt_counts[name],
             elastic_launches=elastic_counts[name],
             elastic_child_launches=elastic["killed_worker"][
                 "child_launches"][name],
             control_plane_launches=cp_counts[name],
             estimator_launches=est_counts[name],
             control_plane_worker_launches=control_plane["failover"][
                 "launches"][name], ok=True,
             work="one attention layer of the flagship LM (B4 H16 T2048 "
                  "D128, causal); shapes lists every shape",
             **flash_rows[name], **ptxas[name],
             **({"library_call": "SDPA backward (dq, dk and dv together)"}
                if name in ("flash_bwd_dkdv", "flash_bwd_dq") else {}))
        for name in FLASH_KERNELS] + [
        # fp32 inputs: the Hopper tf32 forward, dk/dv and dq
        tf32_row(*spec) for spec in TF32_ROWS] + [
        # the ring's per-segment kernels: _seg_fwd_pallas and the two
        # library backward kernels _seg_bwd_pallas calls
        dict(name=name, route="cuda", source=f"{src}/{flash_source(name)}",
             replaces=f"horovod_tpu/parallel/ring_attention.py:{line}",
             launches=ring_counts[name], ok=True,
             work="the zig-zag ring's FULL half-segment (B1 H16 S4096 D128); "
                  "shapes lists every shape",
             **seg_rows[name], **ptxas[name],
             **({"library_call": "SDPA backward of the segment (dq, dk "
                                 "and dv together)"}
                if name != "flash_seg_fwd" else {}))
        for name, line in zip(SEG_KERNELS, (169, 188, 194))] + [
        # above head dim 128, K6's and K7's functions: the Hopper kernels
        # at D 192 and 256, the Hopper forward at 320, O's columns split
        # over blocks at 384 to 512 and S summed over the depth's slabs
        # above 512, and the deep dk/dv and dq on bf16 and fp16 above 256
        wide_row(name, row, line, flash_source(name))
        for name, line in zip(WIDE_KERNELS, (0, 0, 0, 169, 188, 194))
        for row in WIDE_ROWS[kind(name)]] + [
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
    log(f"profiler traces refused and taken again: {len(TRACE_LOST)} "
        f"(try, kernel names seen): {TRACE_LOST}")
    print(json.dumps({"kernels": kernels, "img_per_s": img_s,
                      "img_per_s_windows": rates, "batch": args.batch,
                      "tokens_per_s": tok_s, "tokens_per_s_windows":
                      tok_rates, "lm_batch": lm_batch,
                      "lm_peak_gib": lm_peak, "attention": attention,
                      "ring": ring, "adasum": adasum, "vit_tiny": tiny,
                      "wide_attention": wide, "sync_bn": sync_bn,
                      "replay": replay, "sharded": sharded,
                      "codec": codec, "algo": algo,
                      "observability": observability, "moe": moe,
                      "pipeline": pipeline, "checkpoint": ckpt,
                      "elastic": elastic, "control_plane": control_plane,
                      "estimator": estimator,
                      "resnet_profile": resnet_profile}))
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
