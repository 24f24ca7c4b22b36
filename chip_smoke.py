#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``dgraph_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --phase 9    # phases 1, 2 and 9 (e.g. a card a rank)
    python3 chip_smoke.py --phase 11   # phases 1, 2 and 11
    python3 chip_smoke.py --phase 12   # phases 1, 2 and 12
    python3 chip_smoke.py --phase 13   # phases 1, 2 and 13 (e.g. a card a rank)
    python3 chip_smoke.py --phase 14   # phases 1, 2 and 14 (GraphCast)
    python3 chip_smoke.py --phase 15   # phases 1, 2 and 15 (replicas; e.g. four cards)
    python3 chip_smoke.py --phase 16   # phases 1, 2 and 16 (serving over ranks; e.g. four cards)

Phases, each fatal on failure (the script exits non-zero and prints no result):

1. device — require CUDA; print the card's name and power limit (nvidia-smi);
2. build — compile every CUDA source of the port with nvcc (sm_90a), timed,
   and beside them the native host library with g++ (it must load);
   every tensor-core kernel (bf16 forward, dK/dV, dQ; the split-TF32 f32
   forward, dK/dV and dQ) must be there at D = 32, 64, 128, neither
   spilling nor having its wgmma serialized (ptxas -v);
3. kernel parity — each of the eight one-rank kernels against its plain PyTorch
   version on the card, f32 and bf16, two launches with equal bits; timed
   with CUDA events (mean over back-to-back calls after warmup) beside the
   plain version, the one-call PyTorch equivalent where there is one, and
   the bound (bytes over HBM bandwidth or operations over the peak for the
   type, the larger). The five sorted-id kernels at the training shape (the
   arxiv-width GCN plan: E ~ 2.33 M edges, F = 128 per feature chunk,
   N = 169,344 rows; the segment sum also at F in {1, 2, 4, 8, 16, 32} on
   contiguous [E, F] rows, GAT's softmax denominator and SAGE's degree
   count, where it takes its narrow path; there also the bare launch with
   the offsets computed before, beside the wrapper, index_add_ and the
   searchsorted the wrapper pays once per ids tensor), at edge cases
   (padded out-of-range ids, empty segments, a 3000-edge hub, F in {1, 2,
   4, 8, 16, 33, 128, 256}, strided and unaligned column slices); kernels
   1 (weighted), 1a (unweighted) and 2 on their hub route (rows of more
   than HUB_DEGREE edges summed in chunks of HUB_CHUNK, then combined): on
   power-law ids at the same E and N (max degree at least 10,000; F = 1,
   16 and 128) and on the skewed arxiv graph's plan ids (F = 128), timed
   beside index_add_ (kernel 2), the plain version and the bound, every
   call on the hub route, and at the hub edge cases (a row of exactly
   HUB_DEGREE edges and hubs of HUB_DEGREE + 1, of a multiple of HUB_CHUNK
   and one more than that, as the first row and the last real row before
   the padded ids, three in one narrow block; every form of the three
   kernels at F in {1, 2, 4, 8, 16, 33, 128, 256}, contiguous, strided and
   unaligned); the three flash-attention kernels at the lm_flash shape
   (T = 8192, H = 4, D = 128, causal; yardstick
   ``scaled_dot_product_attention``) and at edge cases (D in {32, 64, 128},
   T = 200, a padded tail or every key masked, causal or not); every
   kernel, each being on the tensor cores, also at T in {1, 31, 33, 63, 64,
   65, 127, 128, 129, 200} for every D, causal or not, and at lm_flash with
   q, k and v as column slices of one [T, 3L] tensor (read in place) and as
   slices at an odd element offset (copied first); at lm_flash the bf16
   outputs block by block (BLOCK_REL_TOL), the f32 forward to F32_FWD_TOL
   and the f32 backward to F32_BWD_TOL (of the plain backward evaluated in
   float64; also at the tile edges, against the f32 plain version, and in
   the slices), each against a control that must exceed it; the f32 dK/dV and
   dQ kernels' sum against SDPA's f32 backward; at the graph transformer's
   shape (H = 4, D = 32, non-causal, a key mask with padded slots) at
   T = 16,384, in place and as column slices of one [T, 3L] tensor, f32
   and bf16, with the same limits and controls, then at T = 169,344
   (gt_arxiv's slots, the last one padded), where the plain version cannot
   run (its [H, T, T] scores would take 459 GB): dK/dV and dQ at 512
   sampled rows against the plain backward evaluated there in float64 (f32
   to F32_BWD_TOL, bf16 to GT_BLOCK_REL_TOL, each against its control),
   every real row's against SDPA's gradients, the padded slot's zero, and
   each kernel timed beside SDPA on the 169,343 real rows; then the
   autograd Function's gradients against autograd of the plain version;
4. serve GCN — ``build_serving`` at ogbn-arxiv width (V = 169,343, F = 128,
   H = 256, C = 40, 2 layers, ladder 8..1024), every bucket warmed, 32
   mixed-size requests through the MicroBatcher; served rows must equal
   ``full_logits()`` bit for bit, the fused kernel must launch 4 times per
   forward and no backward kernel at all, and ``full_logits()`` must match
   the same model and graph run on the CPU (plain path) within 1e-4;
   request latency p50/p99 per bucket;
5. serve SAGE — same width, a few requests, the segment-sum kernel's
   launches checked per forward;
6. train bench_gcn — bench.py's GCN training step on the port (random
   arxiv-shaped graph, unweighted, Adam 1e-3): 2 warm-up and 10 timed steps;
   every step launches the fused kernel, its act form, the fused-backward
   kernel and the segment sum 4 times each; step 0's loss and every
   gradient match the CPU plain path within 1e-4; the loss falls; step ms
   p50/p99 and the device-busy share (torch.profiler);
7. train ogb_gcn — ``python -m dgraph_tpu_torch.train``'s ``main`` at arxiv
   width (symmetric-norm weights, Adam 5e-3) with the sorted-row-gather
   kernel on: every step launches it and the segment sum 8 times each and
   the backward pair never; step 0's gradients match the CPU plain path
   within 1e-4;
8. train lm_flash — ``python -m dgraph_tpu_torch.train.lm``'s ``main`` with
   experiments/long_context_lm.py's LM at head width 128 (T = 8192, latent
   512, 4 heads, 2 layers, vocab 64, Adam 3e-3): 2 warm-up and 10 timed
   steps; every step launches the forward, dK/dV and dQ attention kernels
   once a layer and no other kernel; step 0's loss and every gradient match
   the CPU plain path within 1e-4; the loss falls; an eval forward launches
   only the forward kernel; step ms p50/p99 and the device-busy share; then
   the same run in bf16 (``config.default_compute_dtype``, as
   DGRAPH_TPU_COMPUTE_DTYPE=bfloat16 sets it): the same launches, a falling
   loss, step 0's loss within 2e-2 (relative) of the f32 run's on the same
   weights and batch, and its attention projections' gradients within
   BF16_GRAD_TOL, which two controls (dK/dV's first key block, dQ's first
   query block unwritten) must exceed;
9. kernels 5 and 6, the landing check, and train ogb_gcn over 4 ranks —
   the put-discipline verifier's static selftest (the clean protocol GREEN,
   each of the five seeded faults RED on its own rule); then the one-sided
   halo transport (``ops.p2p``) spawned on 4 and on 2 ranks (sharing the
   card through CUDA IPC, or a card each): bit-equal to its plain version
   (the masked send stack through ``all_to_all``), bit patterns compared,
   at the real W = 4 plan's send lists (F = 256, f32 and bf16, the masked
   exchange and the unmasked reverse leg; the same rows fp8-encoded as
   uint8 tiles of F + 4 = 260 bytes, no mask) and at edge cases whose tiles
   hold NaN, -inf and negative values (deltas {1} and {1, 3}, F in {1, 33,
   256}, both directions, with and without a mask, unaligned rows; uint8
   tiles of 260 and 37 bytes a row, aligned and one byte off, where a mask
   must raise), two launches equal; kernel 6 (its fault-seeded copy)
   ``None`` bit-equal to
   kernel 5 and to its plain version at the same cases and at the real
   send lists, each seeded fault (``bad_dst_row``, ``oversize``) bit-equal
   to its plain version at deltas whose landings no two senders share;
   then kernel 6's path, the verifier's landing check
   (``analysis.kernel.audit_landing``, kernel 5 and kernel 6's three forms,
   both directions, f32 and bf16): GREEN on kernel 5 and kernel 6 ``None``,
   RED naming ``dst-rows`` on ``bad_dst_row`` and ``extent`` on
   ``oversize``; kernels 5 and 6 timed beside the exchange's
   barrier-to-barrier wall time, the plain version, the yardstick and the
   bound; the real shape is the W = 4 plan under the training CLI's
   default partition (multilevel, the native host library: it must load).
   Then ``python -m dgraph_tpu_torch.train``'s ``main`` at ``--world_size
   4`` with DGRAPH_TPU_HALO_IMPL=pallas_p2p (the interior/boundary split)
   twice, under ``multilevel`` (the CLI's default) and under ``random``
   (``--phase 9``: four times, random, multilevel, multilevel, random):
   2 warm-up and 10 timed steps each; every rank's every step launches
   kernel 5 four times and kernel 1 eight times (plus 2 and 8 with an
   eval); every rank built the same partition (a digest of it) with the
   native host library loaded; step 0's loss and gradients of every run
   match one 4-rank gloo run on the CPU (random partition; spawned with
   the phase, beside the plan build and kernel 5's checks) within 1e-4;
   the loss falls; the ranks' parameters are bit-equal at the end; per run
   the partition's host seconds, the edge cut, the vertices each rank owns,
   S, the live deltas, the bytes an exchange puts, the interior and
   boundary edges per rank, and per rank step ms p50/p99, the exchange ms
   and the device-busy share;
10. train ogb_gcn --model gt and --model gat — ``python -m
   dgraph_tpu_torch.train``'s ``main`` on phase 7's arxiv-width graph at
   the CLI's defaults (hidden 128, 2 layers, 4 heads, Adam 5e-3; gt_arxiv
   and gat_arxiv of ``train.profile``). The graph transformer, f32: 1
   warm-up and 2 timed steps; every step launches the forward, dK/dV and dQ
   attention kernels once a layer (T = 169,344, D = 32, non-causal, the
   padded slot masked) and kernel 2 three times a layer, an eval forward
   the forward kernel and kernel 2 once a layer; the loss falls; layer 0's
   attention output for 512 query rows (the first 128, the last 128 with
   the padded slot, 256 drawn from a seed) within F32_FWD_TOL of the plain
   attention of those rows over every key in float64, which a TF32 control
   must exceed; step 0's loss and every gradient against the CPU plain path
   within 1e-4 at V = 4096 (the CPU's [H, T, T] scores at full size would
   take 459 GB); then the same run in bf16: the same launches, a falling
   loss, step 0's loss within 2e-2 of the f32 run's. GAT, f32: 2 warm-up
   and 10 timed steps; every step launches kernel 2 six times a head group
   and layer (four groups of one head), an eval forward twice; the loss
   falls; the CLI's model before its first step (``build_training``)
   matches a CPU copy's plain forward at full size within 1e-4, and step 0's loss and gradients match the CPU
   plain path within 1e-4 at V = 16,384. In every run no step after the
   first computes CSR offsets (the sorted kernels' searchsorted runs once
   per ids tensor). Each run reports step ms p50/p99,
   the device-busy share and the peak device memory;
11. train from the OGB raw layout — ``ogbn.export_arxiv_shaped_npz`` (V =
   169,343, F = 128) written in ogbn-arxiv's raw download layout by
   ``ogb_raw.write_node_pred_raw`` and parsed back by
   ``ogbn.load_ogb_arrays`` (every array equal to ``from_npz`` of the
   export; write and parse seconds logged; in a process of its own that the
   whole run starts with phase 10, whose host is idle), then ``python -m
   dgraph_tpu_torch.train``'s ``main`` with ``--data.ogb_name ogbn-arxiv
   --data.root <that layout>`` at the CLI's default partition, one rank,
   3 steps, the sorted-row-gather kernel on (kernels 1, 2 and 3, launches
   checked every step), finite losses;
12. GCN on a degree-skewed arxiv-sized graph — ``synthetic.skewed_arxiv_edges``
   (V = 169,343, 2,332,486 directed edges, largest in-degree 15,001) with
   seeded features [V, 128], 40 classes and arxiv-sized splits, written to
   an npz (deleted after) and trained by ``python -m
   dgraph_tpu_torch.train``'s ``main`` with ``--data.path`` at ogb_gcn's
   settings, the sorted-row-gather kernel on (phase 7's launches; 2 warm-up
   and 10 timed steps), then phase 6's bench_gcn step on the same graph;
   in each, every step runs the hub route on some call of each sorted sum
   (``<kernel>.hub_calls``), no step after the first computes CSR offsets
   or a hub plan, step 0's loss and every gradient match the CPU plain path
   within 1e-4 (bench_gcn's gradients within 1e-4 of each leaf's largest
   magnitude, a limit that must fail a control step with one hub chunk left
   out) and the loss falls; each reports step ms p50/p99, the device-busy
   share and the device ms of the sorted sums and of the hub combine pass.
   On the SBM graph of phases 4-11 no call takes the hub route, except
   where a plan pads more than HUB_DEGREE edges: its src-side ids put every
   padded edge in src row 0 (836 edges in the CLI's one-rank plan), which
   every training phase checks is the only hub of its plans, and records;
13. the halo lowerings over 4 ranks — spawned on the card (or a card a
   rank, NCCL): at the W = 4 multilevel plan's send lists (phase 9's plan;
   S = 36,864, deltas (1, 2, 3)) at F = 256, f32 and bf16, the exchange and
   the reverse sum under all_to_all, ppermute, overlap, pallas_p2p and
   sched (the plan's compiled halo schedule, logged: its id, rounds, each
   round's height and the operand rows it ships): overlap, pallas_p2p and
   sched bit-equal to all_to_all in both legs (the exchange on the rows a
   round lands), ppermute's exchange bit-equal, its x VJP (f32) bit-equal
   to its per-delta sums added in reverse delta order, and its reverse (a
   masked sum a delta) within TOL of all_to_all's, which a control (the
   reverse without the first delta's rounds) must exceed; a second
   control, the schedule with one transfer taken out by hand, must miss
   all_to_all's bits on that transfer's rows; each leg timed barrier to
   barrier (median of LOWERING_REPS; once on a shared card,
   SHARED_CARD_REPS). Before them the wire codecs
   (``dgraph_tpu_torch.wire``) on the card: bf16 and fp8 at f32 and bf16
   activations, rows with zero rows and subnormals, the card's bytes equal
   to the host's and to the numpy reference codec's, decode bit-equal,
   each codec timed at one rank's exchange; after them the same five
   lowerings under each of WIRE_TURNS (bf16 and fp8 wire on f32
   activations, fp8 on bf16), in the same processes, bit-equal to
   all_to_all under the same format in both legs (ppermute's reverse
   within TOL), timed as the turns without a format. Then
   ``python -m dgraph_tpu_torch.train``'s ``main`` at ``--world_size 4``
   at arxiv width, W13_EPOCHS steps each: GCN (kernel 1 on both subsets of
   the split) and GraphSAGE (its split route, kernel 2 on both subsets)
   under DGRAPH_TPU_HALO_IMPL=overlap, GAT (gat_arxiv's width) under
   overlap and under ppermute, GCN (unsplit) under sched, and GCN under
   pallas_p2p with DGRAPH_TPU_WIRE_FORMAT=fp8 (kernel 5 moving the encoded
   uint8 tiles at every put; its step-0 loss within
   ``np_roundtrip_bound('fp8')`` of the f32-wire GCN overlap run's on the
   same plan, no CPU oracle); each run: every
   rank resolved the pin, every
   step launched the pinned kernels, the loss fell, the ranks' parameters
   are bit-equal, and step 0's loss and every rank's gradients match a
   4-rank gloo run of the port on the CPU under the same pin within 1e-4
   (GAT's at V = 16,384, a second training its ranks build beside their
   own; GCN's against phase 9's CPU run when phase 9 ran, under sched too).
   On one card the
   CPU runs go on beside the card's, so its host-staged step times compare
   no lowering. On a host of four cards the CPU runs come first, then GCN
   trains under every lowering (its step timed under each, no profiler),
   and its overlap run profiles W13_TRACE_STEPS more steps after its timed
   ones: how many of kernel 1's launches ran beside an NCCL kernel;
14. GraphCast — ``python -m dgraph_tpu_torch.train.graphcast``'s ``main`` at
   bench_graphcast's configuration (GC_MAIN: the level-6 multimesh on the
   721x1440 grid, 73 channels, latent 256, 16 processor layers, remat; one
   card, f32): the graphs' anchors (GC_ANCHORS), GC_WARMUP + GC_TIMED steps,
   each launching exactly the kernel-2 calls :func:`graphcast_launches`
   derives (forward, recompute and backward) and no other kernel, no step
   after the first computing CSR offsets, the loss falling (the mean of
   the last 4 below the first 4's), the peak memory, then GC_PROF steps
   under torch.profiler (busy share, top kernels); the same on the same
   weights in bf16 (the same launches, step-0 loss within BF16_LOSS_TOL of
   f32's); ``--eval_rollout`` GC_ROLLOUT with the sorted-row-gather kernel
   on (forward launches only, finite RMSE for the raw and EMA tracks);
   kernels 2 and 3 at the three relations' dst ids (F = 256 and 128, f32
   and bf16: bit-equal to the plain versions on exact values, within TOL
   on normal ones, two launches equal, timed beside the plain version, the
   library call and the bound); the level-6 partition at W = 4 (host: each
   relation's halo against its src side); step 0 at GC_SMALL against the
   CPU plain path (GRAD_TOL; a control, kernel 2 leaving out one edge a
   call, must miss it); then GC_W4 ranks at the CLI's defaults under the
   default lowering (with the CLI's microbenchmark) and under pallas_p2p
   (kernel 5), each step-0 loss within GC_W4_TOL of one rank's and the
   ranks' parameters bit-equal, and under pallas_p2p kernel 5 timed at the
   g2m exchange and its reverse after the run. The kernels line's
   GraphCast rows carry the launches counted at each row's exact shape
   (:class:`LaunchesByShape`);
15. replicas — GraphCast over R = 2 replica groups of W = 2 graph ranks
   (``comm.dist.launch(..., num_replicas=2)``; four ranks sharing the card
   over gloo, a card a rank over NCCL on a host of four) through
   ``train.graphcast``'s rank function at GC_R: bench_graphcast's width
   (73 channels, latent 256) on the level-4 181x360 grid, its depth cut to
   4 processor layers so that four ranks on one card fit the time limit.
   Under the default lowering and under pallas_p2p (kernel 5 among each
   replica group's two ranks), GC_R_STEPS steps each: (a) each replica
   group's step-0 loss within GC_W4_TOL relative of a one-rank run on the
   card on that group's sample (``ReplicaSampler(8, 2, seed=0)``; the two
   samples differ), the same seeded weights; (b) the synced gradient on
   global rank 0 within GC_R_GRAD_TOL of each leaf's magnitude of the mean
   of the two one-rank gradients; (c) the four ranks' parameters bit-equal
   after the last step; (d) each step a rank launching exactly what
   :func:`graphcast_want` derives. Kernel 2 timed at the replica path's
   mesh node sum (f32, F = 256), kernel 5 at a replica group's g2m
   exchange and its reverse (replica 0 timing, replica 1 waiting), and the
   gradient all-reduce over the four ranks timed. On a host of four cards
   the runs take GC_R_STEPS_NCCL steps, and R = 1 x W = 4 under all_to_all
   trains beside R = 2 x W = 2 on the same configuration: a step's p50 a
   rank and the all-reduce's time of each;
16. serving over 4 ranks — ``build_serving`` at arxiv width
   (``arxiv_config``: V = 169,343, F = 128, H = 256, C = 40, 2 layers,
   ladder 8..1024, the CLI's random partition) on DistComm ranks started by
   ``comm.dist.launch`` (four sharing the card over gloo, or a card each
   over NCCL), in the same processes one turn a lowering (SERVE_W_TURNS:
   GCN under the CLI's default lowering and under pallas_p2p, GraphSAGE
   under the default; on four cards GCN also under all_to_all, ppermute,
   overlap and sched). Each turn, the launch counts set to 0 just before:
   rank 0 warms every bucket, drives SERVE_W_REQUESTS requests through the
   MicroBatcher and takes ``full_logits()``, the others follow; then (a)
   served rows equal ``full_logits()`` bit for bit, (b) every rank ran each
   forward rank 0 announced and left ``follow()`` at stop, (c) each rank's
   launches a forward are :func:`serve_w_want`'s (GCN: kernel 1 once a
   chunk and layer, twice on the split route, kernel 5 once a layer under
   pallas_p2p; SAGE: kernel 2) and no backward kernel, (d)
   ``full_logits()`` is within SERVE_TOL of the model at one rank on the
   CPU (computed beside the ranks). Request p50/p99 per bucket a turn, the
   ranks' start-up and build seconds. After the counts are read, kernel 1
   (GCN) and kernel 2 (SAGE) at each rank's serving shape and kernel 5 at
   its exchange ([3, S, 256] f32), each against its plain version and
   timed in turn beside it, the library call and the bound; on four cards
   also kernel 5's NVLink bound (the bytes a rank puts over the sum of the
   link speeds ``nvidia-smi nvlink -s`` reports), there and at the
   readings of KERNEL5_NVLINK_READINGS;
then the kernels line (one JSON object) and the device line (last line).
Every progress line carries the seconds since the start, and the end logs
each phase's seconds.

Everything but the two JSON lines and the nvidia-smi line goes out as
``[chip_smoke]`` progress lines; details land in
``chiprun_out/chip_smoke.json``. Weights and data are random, made from
seeds. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
import types

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, the
# non-tensor-core float32 rate, the dense bf16 tensor-core rate, and the
# dense TF32 rate of the split-TF32 f32 attention kernels (three TF32
# products for each f32 one)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TF32_OPS_PER_S = 494.7e12

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the attention kernels sum up to T = 8192 products in another order than
# the plain version; bf16 outputs are rounded once from f32 on both sides
ATT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# ATT_TOL in bf16 is about as large as a typical |O| or |dV| at the
# lm_flash shape (row i's output has a spread of sqrt(e / (i + 1))), so a
# kernel that misses or doubles a tile of keys or queries could pass it
# there. Those outputs are also held to a scale-aware limit: the largest
# error in each block of 128 rows over that block's largest |plain| value
# (block_rel_err). The limit lies between the sound kernels' readings and
# those of a control, the plain version with one key or query tile dropped,
# which phase 3 reads in every run and which must exceed it (PERF.md)
BLOCK_ROWS = 128
BLOCK_REL_TOL = 3e-2
# the f32 forward (split TF32 on the tensor cores) against its plain version
# at the lm_flash shape, O and lse: ten times below ATT_TOL. A control, the
# plain forward on q, k and v truncated to TF32 (the low 13 mantissa bits
# cleared), is read in every run and must exceed it: the limit tells TF32
# from f32 accuracy
F32_FWD_TOL = 1e-5
# the f32 backward (dK/dV and dQ in split TF32) against its plain version at
# the lm_flash shape, dK, dV and dQ: ten times below ATT_TOL. There the
# plain version is evaluated in float64 (plain_bwd_f64): in f32 its own sums
# over 8192 queries are off by up to 1.6e-5 (PERF.md). A control, the plain
# backward on q, k, v and dO truncated to TF32, is read in every run and
# must exceed it
F32_BWD_TOL = 1e-5
LM_T, LM_H, LM_D = 8192, 4, 128  # lm_flash: seq_len 8192, latent 512, 4 heads
# the graph transformer's attention (gt_arxiv: hidden 128, 4 heads) over
# ogbn-arxiv's 169,343 vertices in 169,344 slots, non-causal, the padded
# slot masked; its kernels are held to their plain versions at GT_CHECK_T
# (the plain [H, T, T] scores at GT_T would take 459 GB) and timed at GT_T
GT_T, GT_H, GT_D = 169344, 4, 32
GT_CHECK_T = 16384
GT_REPS = 3  # timed calls at GT_T: an f32 call takes a good part of a second
# at GT_T the bf16 dK/dV and dQ at the sampled rows (gt_rows) against the
# plain backward evaluated in float64 (sampled_bwd_f64), by block_rel_err:
# there a dropped 64-row tile is one of 2,646 and moves a sampled block by
# only about 3 % (PERF.md), as much as BLOCK_REL_TOL, while the bf16
# rounding of the outputs alone reads about 0.3 %. The limit lies between;
# the dropped-tile controls are read in every run and must exceed it
GT_BLOCK_REL_TOL = 1e-2
# kernel 2's narrow widths, timed at the training shape, and the widths of
# every sorted-id kernel's edge cases
NARROW_SWEEP = (1, 2, 4, 8, 16, 32)
EDGE_F = (1, 2, 4, 8, 16, 33, 128, 256)
# kernel 2's skewed case (ops.kernel_ab.power_law_ids): its largest row
# must hold at least MIN_HUB_DEGREE edges
MIN_HUB_DEGREE = 10_000
SERVE_TOL = 1e-4
GRAD_TOL = 1e-4
# lm_flash's bf16 step-0 loss against the f32 run's on the same weights and
# batch: bf16 matmuls and attention round every product's inputs (2^-8
# relative) through two layers
BF16_LOSS_TOL = 2e-2
# ... and its step-0 gradients of the attention projections (qkv, attn_out)
# against the f32 run's: the largest relative Frobenius error of a leaf, or
# of one of qkv's q, k and v row blocks.
# The limit lies between the sound run's reading and those of two controls,
# the same step with the dK/dV kernel leaving its first key block unwritten
# and with the dQ kernel leaving its first query block unwritten, which
# phase 8 reads in every run and which must each exceed it (PERF.md)
BF16_GRAD_TOL = 2e-2
OUT_DIR = "chiprun_out"


_T0 = time.perf_counter()
_PHASE_STARTS: list = []  # (phase, seconds since start) as each phase begins


def log(msg: str) -> None:
    """A progress line, with the seconds since the script started; a line
    "phase N: ..." marks where phase N begins (:func:`phase_seconds`)."""
    t = time.perf_counter() - _T0
    head = msg.split(":", 1)[0]
    if head.startswith("phase ") and head[6:].isdigit() and head[6:] not in dict(_PHASE_STARTS):
        _PHASE_STARTS.append((head[6:], t))
    print(f"[chip_smoke] {t:7.1f} s  {msg}", flush=True)


def phase_seconds() -> dict:
    """Each phase's seconds, from its first line to the next phase's (the
    last to now)."""
    ends = [t for _, t in _PHASE_STARTS[1:]] + [time.perf_counter() - _T0]
    return {p: round(e - t, 1) for (p, t), e in zip(_PHASE_STARTS, ends)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# --- phase 1 ---------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    # float32 matmuls in full f32 on the card (the CPU reference is full f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    return smi[0]


# --- phase 2 ---------------------------------------------------------------


def ptxas_kernels(text: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "serialized"}}
    from nvcc's ``-Xptxas -v`` output; a kernel is named by its function and
    template arguments (``flash_fwd_tc_kernel<bf16, 128>``,
    ``flash_bwd_dkv_tf32x3_kernel<128, true>``); ``serialized``
    is a ptxas note (C7512 for register resources, C7520 for a divergent
    path, ...) that it serialized the kernel's wgmma instructions."""
    import re

    def short(mangled: str) -> str:
        pos = mangled.find("N") + 1  # the nested name: length-prefixed parts
        while pos and (m := re.match(r"\d+", mangled[pos:])):
            pos += m.end()
            name = mangled[pos:pos + int(m.group())]
            pos += len(name)
            if name.endswith("kernel"):
                rest = mangled[pos:]
                dtype = ("float" if rest.startswith("If") else
                         "bf16" if "bfloat16" in rest else None)
                args = [a for a in (dtype, *(("true", "false")[v == "0"] if t == "b" else v
                                             for t, v in re.findall(r"L([ib])(\d+)E", rest)))
                        if a]
                return f"{name}<{', '.join(args)}>"
        return mangled

    out, cur, serialized = {}, None, set()
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = short(m.group(1))
            out[cur] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        m = re.search(r"\(C75\d\d\)[^']*serializ[^']*function '([^']+)'", line)
        if m:
            serialized.add(short(m.group(1)))
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur]["spill_stores"] = max(out[cur]["spill_stores"], int(m.group(1)))
            out[cur]["spill_loads"] = max(out[cur]["spill_loads"], int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    for k, r in out.items():
        r["serialized"] = k in serialized
    return out


# the tensor-core kernels, by name: bf16 (``*_tc_kernel``) and f32 in split
# TF32 (``*_tf32x3_kernel``)
TC_KERNEL_MARKS = ("_tc_kernel", "_tf32x3_kernel")
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel", "flash_bwd_dq_tc_kernel",
              "flash_fwd_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel",
              "flash_bwd_dq_tf32x3_kernel")


def phase_build() -> dict:
    """Every source built; each kernel's registers and spills from the
    ptxas log. The tensor-core kernels (TC_KERNEL_MARKS) must neither spill
    nor have their wgmma serialized. The native host library (g++, the
    multilevel partitioners) builds beside the nvcc builds and must load."""
    import re
    import threading

    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.ops import _build

    host = {}

    def build_host():
        t = time.perf_counter()
        host["ok"] = native.available()
        host["s"] = time.perf_counter() - t

    t0 = time.perf_counter()
    thread = threading.Thread(target=build_host)
    thread.start()
    times = _build.build()
    thread.join()
    total = time.perf_counter() - t0
    if not host["ok"]:
        fail(f"the native host library did not build or load: {native.build_error}")
    log(f"native host library ({native.library_path().name}): built and loaded in "
        f"{host['s']:.2f} s")
    kernels = {}
    for name in times:
        for k, r in ptxas_kernels(_build.build_log(name)).items():
            kernels[f"{name}/{k}"] = r
            log(f"ptxas {name}/{k}: {r['registers']} registers, spill {r['spill_stores']} / "
                f"{r['spill_loads']} bytes{', wgmma serialized' if r['serialized'] else ''}")
    tc = [k for k in kernels if any(m in k for m in TC_KERNEL_MARKS)]
    for name in TC_KERNELS:
        for D in (32, 64, 128):
            if not any(re.search(rf"{name}<(\w+, )?{D}[,>]", k) for k in tc):
                fail(f"phase 2: ptxas reports no {name} at D = {D}")
    bad = [k for k in tc
           if kernels[k]["spill_stores"] or kernels[k]["spill_loads"] or kernels[k]["serialized"]]
    if bad:
        fail(f"tensor-core kernels spill or serialize their wgmma: {bad}")
    log(f"build: {total:.2f} s ({times})")
    return {"build_s": total, "per_source_s": times, "native_host_s": host["s"],
            "ptxas": kernels}


# --- phase 3 ---------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls after warmup, divided by ``reps`` (the host enqueues ahead of
    the card, so launch gaps are amortised)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, dtype_name: str = "float32") -> tuple:
    """Least time for one call (ms): the bytes it must move (each input
    read once, each output written once) over HBM bandwidth, against its
    operations over the card's peak for the input type (f32 outside the
    tensor cores, bf16 on them); the larger wins."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def bits(t):
    """The bit patterns of an f32, bf16 or uint8 tensor: ``-0.0`` and
    ``0.0`` differ, a NaN equals only the same NaN."""
    import torch

    return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[t.element_size()])


def check_close(name, got, want, dtype_name, tols=TOL) -> float:
    import torch

    tol = tols[dtype_name]
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"{tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"{name}: kernel disagrees with plain (max abs err {max_err(got, want)}, tol {tol})")
    return max_err(got, want)


def block_rel_err(got, want) -> float:
    """The largest, over blocks of BLOCK_ROWS rows (the first dimension),
    of the block's largest absolute error over its largest |want|."""
    import torch

    d = (got.float() - want.float()).abs().reshape(want.shape[0], -1)
    w = want.float().abs().reshape(want.shape[0], -1)
    pad = -want.shape[0] % BLOCK_ROWS
    d, w = (torch.nn.functional.pad(t, (0, 0, 0, pad)).view(-1, BLOCK_ROWS * t.shape[1])
            .amax(dim=1) for t in (d, w))
    ratio = torch.where(w > 0, d / w.clamp_min(1e-30), torch.where(d > 0, torch.inf, 0.0))
    return float(ratio.max())


def edge_case_ids(n: int, seed: int = 0):
    """Sorted ids with empty segments, a hub of degree 3000 and padded
    out-of-range ids (the plan's n_owner_pad)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    real = rng.choice(np.arange(0, n, 2), 20000)
    hub = np.full(3000, 8)
    pad = np.full(700, n)
    return np.concatenate([np.sort(np.concatenate([real, hub])), pad]).astype(np.int32)


def kernel_cases(seg, data, ids, bias, n, w, *, g=None, x=None):
    """{kernel: [(label, kernel call, plain call)]} on one set of inputs:
    the five kernels, kernel 1 and its act form weighted and unweighted,
    kernel 2 plain and with the relu input op. ``g`` and ``x`` are the
    vertex-sized operands of kernels 4 and 3 (default: ``bias``)."""
    g = bias if g is None else g
    x = g if x is None else x
    cases = {k: [] for k in seg.KERNELS}
    for ew, tag in ((w, "w"), (None, "unw")):
        for name, wrapper, plain in (
                ("sorted_segment_sum_bias_relu", seg.sorted_segment_sum_bias_relu,
                 seg.sorted_segment_sum_bias_relu_plain),
                ("sorted_segment_sum_act", seg.sorted_segment_sum_act,
                 seg.sorted_segment_sum_act_plain)):
            cases[name].append((tag, lambda f=wrapper, e=ew: f(data, ids, bias, n, edge_weight=e),
                                lambda f=plain, e=ew: f(data, ids, bias, n, edge_weight=e)))
    for op in ("none", "relu"):
        cases["sorted_segment_sum"].append(
            (op, lambda o=op: seg.sorted_segment_sum(data, ids, n, input_op=o),
             lambda o=op: seg.sorted_segment_sum_plain(data, ids, n, input_op=o)))
    cases["fused_bwd_gd"].append(("", lambda: seg.fused_bwd_gd(data, g, bias, ids),
                                  lambda: seg.fused_bwd_gd_plain(data, g, bias, ids)))
    cases["sorted_row_gather"].append(("", lambda: seg.sorted_row_gather(x, ids),
                                       lambda: seg.sorted_row_gather_plain(x, ids)))
    return cases


def main_shape_bytes(kernel, tag, e, e_valid, n, f, b) -> tuple:
    """(bytes, ops) one call must move and compute at the training shape:
    each input read once and each output written once; rows with an
    out-of-range id are read by no kernel, but every output row is written.
    The segment sums (kernels 1, 1a, 2) read the CSR offsets, 8 (n + 1)
    bytes, which their wrappers compute once per ids tensor, and not the
    ids; the hub route's partial rows are that implementation's traffic, not
    the function's, and stay out (:func:`hub_route_cases` logs them). The
    gathers (3, 4) read the ids."""
    weighted = tag == "w"
    row_ptr = 8 * (n + 1)
    if kernel == "sorted_segment_sum_bias_relu":
        return (e_valid * f * b + row_ptr + 2 * n * f * b + 4 * e_valid * weighted,
                e_valid * f * (4 if weighted else 3))
    if kernel == "sorted_segment_sum_act":
        return (e_valid * f * b + row_ptr + n * f * b + 4 * n * f + 4 * e_valid * weighted,
                e_valid * f * (4 if weighted else 3))
    if kernel == "sorted_segment_sum":
        return e_valid * f * b + row_ptr + n * f * b, e_valid * f * (2 if tag == "relu" else 1)
    if kernel == "fused_bwd_gd":
        return 2 * e * f * b + 4 * e + 2 * n * f * b, e_valid * f * 3
    if kernel == "sorted_row_gather":
        return n * f * b + 4 * e + e * f * b, 0
    raise KeyError(kernel)


def library_call(kernel, tag, data, ids, n, e_valid, x):
    """The one PyTorch call that computes the same function, or None:
    ``index_add_`` for kernel 2's plain sum (f32 only: in bf16 it sums in
    bf16) and ``index_select`` on the zero-row-extended table for kernel 3.
    Kernel 1 (both forms) and kernel 4 have none."""
    import torch

    if kernel == "sorted_segment_sum" and tag == "none" and data.dtype == torch.float32:
        ids_v, data_v = ids[:e_valid].long(), data[:e_valid]
        return lambda: torch.zeros(n, data.shape[1], dtype=data.dtype,
                                   device=data.device).index_add_(0, ids_v, data_v)
    if kernel == "sorted_row_gather":
        x_ext = torch.cat([x, x.new_zeros(1, x.shape[1])])
        folded = torch.where((ids >= 0) & (ids < x.shape[0]), ids, x.shape[0]).long()
        return lambda: x_ext.index_select(0, folded)
    return None


def bare_segment_sum(seg, data, ids, n, input_op):
    """Kernel 2's launch alone: its C entry point into a preallocated
    output, the offsets and the hub plan computed before, the workspace
    allocated before (no wrapper, no count). The function's ``out`` is the
    output it writes."""
    import torch

    from dgraph_tpu_torch.ops import _build

    plan = seg._segment_plan(ids, n)
    hub, ws = seg.hub_args(plan.hub, data.shape[1], data.device)
    out = torch.empty(n, data.shape[1], dtype=data.dtype, device=data.device)
    lib = _build.load("sorted_segment")
    args = (data.data_ptr(), seg._row_stride(data), plan.row_ptr.data_ptr(), out.data_ptr(), n,
            data.shape[1], seg._KERNEL_DTYPES[data.dtype], int(input_op == "relu"),
            int(seg._vec_ok(data, out)), seg._stream(), *hub)

    def run():
        _build.check(lib.dg_sorted_segment_sum(*args), "dg_sorted_segment_sum")

    run.out, run.plan, run.ws = out, plan, ws
    return run


def phase_kernels(graph) -> dict:
    """Parity of every kernel with its plain version, its times, and two
    launches with equal bits: at the training shape (the arxiv-width plan's
    owner ids, F = 128) and at edge cases."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = graph.plan.shard(0).to(dev)
    ids = plan.dst_index  # owner-side, sorted, padded with n_pad
    n = plan.n_dst_pad
    w = graph.edge_weight[0].to(dev)
    e_pad = ids.shape[0]
    e_valid = int((ids < n).sum())
    records = []
    worst = {}

    def note(kernel, dtype_name, err):
        key = (kernel, dtype_name)
        worst[key] = max(worst.get(key, 0.0), err)

    # every kernel at F = 128 (a feature chunk), and kernel 2 also at the
    # narrow widths: F = 1 is GAT's softmax denominator at one head a group
    # and SAGE's degree count, 2-8 the denominator at more heads a group
    for (dtype_name, dtype), (F, only) in itertools.product(
            (("float32", torch.float32), ("bfloat16", torch.bfloat16)),
            ((128, None), *((f, ("sorted_segment_sum", "none")) for f in NARROW_SWEEP))):
        data = torch.randn(e_pad, F, generator=gen, device=dev).to(dtype)
        bias = torch.randn(n, F, generator=gen, device=dev).to(dtype)
        g = torch.randn(n, F, generator=gen, device=dev).to(dtype)
        b = data.element_size()
        for kernel, cases in kernel_cases(seg, data, ids, bias, n, w, g=g).items():
            for tag, run, plain in cases:
                if only is not None and (kernel, tag) != only:
                    continue
                name = " ".join(x for x in (kernel, dtype_name, tag, f"F={F}") if x)
                got = run()
                want = plain()
                torch.cuda.synchronize()
                err = check_close(name, got, want, dtype_name)
                note(kernel, dtype_name, err)
                if not torch.equal(got, run()):
                    fail(f"{name}: two launches differ (kernel must be deterministic)")
                del got, want
                nbytes, ops = main_shape_bytes(kernel, tag, e_pad, e_valid, n, F, b)
                b_ms, b_by = bound(nbytes, ops)
                lib = library_call(kernel, tag, data, ids, n, e_valid, g)
                if lib is not None and not torch.allclose(lib().float(), plain().float(),
                                                          rtol=TOL[dtype_name], atol=TOL[dtype_name]):
                    fail(f"{name}: the library yardstick disagrees with plain")
                rec = {
                    "kernel": kernel, "case": name, "dtype": dtype_name, "tag": tag,
                    "E": e_pad, "E_valid": e_valid, "N": n, "F": F, "max_abs_err": err,
                    "ms": time_ms(run),
                    "plain_ms": time_ms(plain, reps=5, warmup=1),
                    "library_ms": None if lib is None else time_ms(lib),
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                if kernel.startswith("sorted_segment_sum"):
                    # the searchsorted the wrappers now pay once per ids tensor
                    rec["row_ptr_ms"] = time_ms(lambda: seg._row_ptr(ids, n))
                if kernel == "sorted_segment_sum":
                    bare = bare_segment_sum(seg, data, ids, n, tag)
                    bare()
                    if not torch.equal(bare.out, run()):
                        fail(f"{name}: the bare launch and the wrapper differ")
                    rec["kernel_ms"] = time_ms(bare)
                    del bare
                records.append(rec)
                log(f"{name}: err {err:.3g} wrapper {rec['ms']:.4f} ms kernel "
                    f"{rec.get('kernel_ms', rec['ms']):.4f} ms plain {rec['plain_ms']:.4f} ms "
                    f"library {rec['library_ms']} ms bound {b_ms:.4f} ms ({b_by}) searchsorted "
                    f"{rec.get('row_ptr_ms')} ms")
        del data, bias, g

    records += skewed_cases(seg, gen, ids, n, e_valid, note)
    records += skewed_graph_cases(seg, gen, note)
    hub_edge_cases(seg, gen, note)

    # edge cases: empty segments, hub, padded ids, F in EDGE_F, contiguous
    # rows at an odd element offset (16-byte loads unaligned: scalar paths),
    # strided column slices (the GCN's bias chunk), an unaligned slice
    # (scalar path). Values are multiples of 1/4 (weights too): exact in
    # bf16, and their sums exact in f32 in any order, so the hub's
    # 3000-term sums compare free of summation-order noise
    n_small = 5000
    ids_small = torch.from_numpy(edge_case_ids(n_small)).to(dev)
    e_small = ids_small.shape[0]
    w_small = quarter_values(gen, e_small, lo=0, hi=5)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for F_ in EDGE_F:
            wide = quarter_values(gen, e_small, F_ + 5).to(dtype)
            table = quarter_values(gen, n_small, 2 * F_ + 1).to(dtype)
            e_rows = wide.flatten()[1:1 + e_small * F_].view(e_small, F_)
            n_rows = table.flatten()[1:1 + 2 * n_small * F_].view(2, n_small, F_)
            views = {"contiguous": (wide[:, :F_].contiguous(), table[:, :F_].contiguous(),
                                    table[:, F_:2 * F_].contiguous()),
                     "shifted": (e_rows, n_rows[0], n_rows[1]),
                     "strided": (wide[:, :F_], table[:, F_:2 * F_], table[:, :F_]),
                     "unaligned": (wide[:, 1:F_ + 1], table[:, 1:F_ + 1], table[:, F_ + 1:])}
            for layout, (d, bvec, gvec) in views.items():
                cases = kernel_cases(seg, d, ids_small, bvec, n_small, w_small, g=gvec)
                for kernel, runs in cases.items():
                    for tag, run, plain in runs:
                        name = f"{kernel} edge {dtype_name} F={F_} {layout} {tag}"
                        got = run()
                        note(kernel, dtype_name, check_close(name, got, plain(), dtype_name))
                        if not torch.equal(got, run()):
                            fail(f"{name}: two launches differ")
    torch.cuda.synchronize()
    log(f"edge cases passed; worst abs err {worst}")
    return {"records": records,
            "worst_abs_err": {f"{k}/{d}": v for (k, d), v in worst.items()}}


# the sorted segment sums that take the hub route, with the case tag of each
# one that phase 3 times on skewed ids (kernel 1 weighted, 1a unweighted)
HUB_KERNELS = (("sorted_segment_sum", "none"), ("sorted_segment_sum_bias_relu", "w"),
               ("sorted_segment_sum_act", "unw"))
SKEW_F = (1, 16, 128)


def quarter_values(gen, *shape, lo=-8, hi=9):
    """Multiples of 1/4 in [lo/4, hi/4): exact in bf16, and their sums exact
    in f32 in any order."""
    import torch

    return torch.randint(lo, hi, shape, generator=gen, device=gen.device).float() / 4


def hub_route_cases(seg, gen, ids, n, e_valid, widths, where, note) -> list:
    """Kernels 1 (weighted), 1a (unweighted) and 2 on the sorted ``ids`` at
    each F of ``widths``, f32 and bf16: against their plain versions, two
    launches with equal bits, the hub route taken (``hub_calls``); timed
    beside the plain version, index_add_ (kernel 2, f32) and the bound (the
    function's bytes; the route's own partial rows, written and read back,
    are logged beside it as ``partial_bytes``)."""
    import numpy as np
    import torch

    plan = seg._segment_plan(ids, n)
    deg = (plan.row_ptr[1:] - plan.row_ptr[:-1]).cpu().numpy()
    n_chunks = plan.hub.n_chunks if plan.hub is not None else 0
    profile = {"max_degree": int(deg.max()), "n_hubs": int((deg > seg.HUB_DEGREE).sum()),
               "n_chunks": n_chunks, "hub_edges": int(deg[deg > seg.HUB_DEGREE].sum())}
    records = []
    for (dtype_name, dtype), F in itertools.product(
            (("float32", torch.float32), ("bfloat16", torch.bfloat16)), widths):
        data = quarter_values(gen, ids.shape[0], F).to(dtype)
        bias = quarter_values(gen, n, F).to(dtype)
        w = quarter_values(gen, ids.shape[0], lo=0, hi=5)
        cases = kernel_cases(seg, data, ids, bias, n, w)
        for kernel, tag in HUB_KERNELS:
            run, plain = next((r, p) for t, r, p in cases[kernel] if t == tag)
            name = f"{kernel} {dtype_name} {tag} F={F} {where}"
            wrapper = seg.KERNELS[kernel].wrapper
            before = wrapper.hub_calls
            got = run()
            err = check_close(name, got, plain(), dtype_name)
            note(kernel, dtype_name, err)
            if not torch.equal(got, run()):
                fail(f"{name}: two launches differ")
            if wrapper.hub_calls != before + 2 * (plan.hub is not None):
                fail(f"{name}: the hub route ran on {wrapper.hub_calls - before} of 2 calls "
                     f"({profile['n_hubs']} hubs)")
            del got
            nbytes, ops = main_shape_bytes(kernel, tag, ids.shape[0], e_valid, n, F,
                                           data.element_size())
            b_ms, b_by = bound(nbytes, ops)
            lib = library_call(kernel, tag, data, ids, n, e_valid, None)
            rec = {"kernel": kernel, "case": name, "dtype": dtype_name, "tag": tag,
                   "E": ids.shape[0], "E_valid": e_valid, "N": n, "F": F, **profile,
                   "max_abs_err": err, "ms": time_ms(run),
                   "plain_ms": time_ms(plain, reps=5, warmup=1),
                   "library_ms": None if lib is None else time_ms(lib),
                   "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
                   "partial_bytes": 2 * n_chunks * F * 4}
            if kernel == "sorted_segment_sum":
                bare = bare_segment_sum(seg, data, ids, n, tag)
                bare()
                if not torch.equal(bare.out, run()):
                    fail(f"{name}: the bare launch and the wrapper differ")
                rec["kernel_ms"] = time_ms(bare)
                del bare
            records.append(rec)
            log(f"{name} (max degree {profile['max_degree']}, {profile['n_hubs']} hubs in "
                f"{n_chunks} chunks): err {err:.3g} wrapper {rec['ms']:.4f} ms kernel "
                f"{rec.get('kernel_ms', rec['ms']):.4f} ms plain {rec['plain_ms']:.4f} ms "
                f"library {rec['library_ms']} ms bound {b_ms:.4f} ms ({b_by}; the route's "
                f"partial rows add {rec['partial_bytes']} bytes to its {nbytes})")
        del data, bias, w, cases
    return records


def skewed_cases(seg, gen, plan_ids, n, e_valid, note) -> list:
    """The hub route at the training shape (the plan's E slots, N rows) on
    power-law ids (``ops.kernel_ab.power_law_ids``: max degree at least
    MIN_HUB_DEGREE) at F in SKEW_F (:func:`hub_route_cases`)."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops.kernel_ab import power_law_ids

    ids_np = power_law_ids(n, e_valid, plan_ids.shape[0])
    max_deg = int(np.bincount(ids_np[:e_valid], minlength=n).max())
    if max_deg < MIN_HUB_DEGREE:
        fail(f"skewed ids: max degree {max_deg} < {MIN_HUB_DEGREE}")
    ids = torch.from_numpy(ids_np).to(plan_ids.device)
    return hub_route_cases(seg, gen, ids, n, e_valid, SKEW_F, "skewed", note)


def skewed_graph_cases(seg, gen, note) -> list:
    """The hub route on the owner ids of bench_gcn's plan of the skewed
    arxiv graph (``ops.kernel_ab.skewed_plan_ids``: largest in-degree
    15,001), at F = 128 (:func:`hub_route_cases`)."""
    import torch

    from dgraph_tpu_torch.ops.kernel_ab import skewed_plan_ids

    ids_np, n = skewed_plan_ids()
    ids = torch.from_numpy(ids_np).to(gen.device)
    return hub_route_cases(seg, gen, ids, n, int((ids < n).sum()), (128,), "skewed graph", note)


def hub_edge_cases(seg, gen, note) -> None:
    """The hub route's edge cases (``ops.kernel_ab.hub_edge_case_ids``: hubs
    of HUB_DEGREE + 1 edges and a row of exactly HUB_DEGREE, hubs of a
    multiple of HUB_CHUNK edges and of one more than that, a hub as the
    first row and as the last real row before the padded ids, three hubs in
    one narrow block) for kernels 1, 1a and 2 in every form, at F in EDGE_F,
    as contiguous rows, strided column slices and unaligned rows, f32 and
    bf16: against the plain versions, two launches equal, every call on the
    hub route."""
    import torch

    from dgraph_tpu_torch.ops.kernel_ab import hub_edge_case_ids

    n = 3000
    ids = torch.from_numpy(hub_edge_case_ids(n, seg.HUB_DEGREE, seg.HUB_CHUNK)).to(gen.device)
    e = ids.shape[0]
    w = quarter_values(gen, e, lo=0, hi=5)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for F in EDGE_F:
            wide = quarter_values(gen, e, F + 5).to(dtype)
            table = quarter_values(gen, n, 2 * F + 1).to(dtype)
            views = {"contiguous": (wide[:, :F].contiguous(), table[:, :F].contiguous()),
                     "strided": (wide[:, :F], table[:, F:2 * F]),
                     "unaligned": (wide[:, 1:F + 1], table[:, 1:F + 1])}
            for layout, (d, bvec) in views.items():
                cases = kernel_cases(seg, d, ids, bvec, n, w)
                for kernel, _ in HUB_KERNELS:
                    wrapper = seg.KERNELS[kernel].wrapper
                    for tag, run, plain in cases[kernel]:
                        name = f"{kernel} hub edge {dtype_name} F={F} {layout} {tag}"
                        before = wrapper.hub_calls
                        got = run()
                        note(kernel, dtype_name, check_close(name, got, plain(), dtype_name))
                        if not torch.equal(got, run()):
                            fail(f"{name}: two launches differ")
                        if wrapper.hub_calls != before + 2:
                            fail(f"{name}: a call left the hub route")
    torch.cuda.synchronize()


def attention_work(kernel, T, H, D, b, pairs) -> tuple:
    """(bytes, ops) of one call: q, k, v (and dO) read once, the outputs
    (and lse, di) once; 2·D operations a pair per product — QKᵀ and PV in
    the forward, QKᵀ, dO Vᵀ, Pᵀ dO and dSᵀ Q for dK/dV, QKᵀ, dO Vᵀ and dS K
    for dQ. (The split-TF32 f32 kernels do three TF32 products for each:
    see attention_bound.)"""
    x = T * H * D * b
    rows = 4 * H * T
    if kernel == "flash_attention_fwd":
        return 3 * x + x + rows, 2 * 2 * D * H * pairs
    if kernel == "flash_attention_bwd_dkv":
        return 4 * x + 2 * rows + 2 * x, 4 * 2 * D * H * pairs
    return 4 * x + 2 * rows + x, 3 * 2 * D * H * pairs


def attention_bound(kernel, dtype_name, nbytes, ops) -> dict:
    """The bound of an attention call, as ``bound`` gives it for its type;
    the f32 kernels run on the tensor cores in split TF32, three TF32
    products for each f32 one, so their bound is the smaller of that
    route's and the CUDA cores' (both kept)."""
    b_ms, b_by = bound(nbytes, ops, dtype_name)
    rec = {"bound_ms": b_ms, "bound_by": b_by}
    if dtype_name == "float32":
        tf_ms, tf_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                           (3 * ops / TF32_OPS_PER_S * 1e3, "operations"))
        rec.update(bound_cuda_cores_ms=b_ms, bound_tf32x3_ms=tf_ms, bound_ms=min(b_ms, tf_ms),
                   bound_by=tf_by if tf_ms <= b_ms else b_by)
    return rec


def tf32_trunc(x):
    """``x`` (f32) truncated to TF32: the low 13 mantissa bits cleared."""
    import torch

    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_control(att, q, k, v, out, lse, causal=True, kv_mask=None) -> float:
    """The plain forward on q, k and v truncated to TF32 against the plain
    forward (``out``, ``lse``): the largest absolute difference over O and
    lse, the reading TF32 products would give."""
    o_t, lse_t = att.flash_attention_fwd_plain(tf32_trunc(q), tf32_trunc(k), tf32_trunc(v),
                                               causal=causal, kv_mask=kv_mask)
    return max(max_err(o_t, out), max_err(lse_t, lse))


def plain_bwd_f64(att, q, k, v, do, lse, di, causal=True, kv_mask=None) -> tuple:
    """The plain backward's formula evaluated in float64 from the same f32
    inputs, lse and di: (dK, dV, dQ) as f64."""
    import torch

    q, k, v, do, lse, di = (t.double() for t in (q, k, v, do, lse, di))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("thd,shd->hts", q, k) * scale
    p = torch.where(att._allowed(q.shape[0], causal, kv_mask, q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    del s
    dv = torch.einsum("hts,thd->shd", p, do)
    ds = (torch.einsum("thd,shd->hts", do, v) - di[..., None]) * p * scale
    del p
    return torch.einsum("hts,thd->shd", ds, q), dv, torch.einsum("hts,shd->thd", ds, k)


def tf32_bwd_control(att, q, k, v, do, ref, causal=True, kv_mask=None) -> float:
    """The plain backward (dK, dV, dQ) on q, k, v and dO truncated to TF32,
    with the plain forward's lse and di, against ``ref`` (plain_bwd_f64 on
    the full inputs): the largest absolute difference, the reading TF32
    products would give."""
    kw = dict(causal=causal, kv_mask=kv_mask)
    out, lse = att.flash_attention_fwd_plain(q, k, v, **kw)
    ins = (*(tf32_trunc(t) for t in (q, k, v, do)), lse, att.row_dot(out, do))
    got = (*att.flash_attention_bwd_dkv_plain(*ins, **kw),
           att.flash_attention_bwd_dq_plain(*ins, **kw))
    return max(max_err(g, w) for g, w in zip(got, ref))


def attention_cases(att, q, k, v, do, kw):
    """{kernel: (kernel call, plain call)} on one set of inputs; the
    backward kernels read the plain forward's lse and di."""
    out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
    di = att.row_dot(out_p, do)
    rest = (q, k, v, do, lse_p, di)
    return {
        "flash_attention_fwd": (lambda: att.flash_attention_fwd(q, k, v, **kw),
                                lambda: att.flash_attention_fwd_plain(q, k, v, **kw)),
        "flash_attention_bwd_dkv": (lambda: att.flash_attention_bwd_dkv(*rest, **kw),
                                    lambda: att.flash_attention_bwd_dkv_plain(*rest, **kw)),
        "flash_attention_bwd_dq": (lambda: att.flash_attention_bwd_dq(*rest, **kw),
                                   lambda: att.flash_attention_bwd_dq_plain(*rest, **kw)),
    }


def check_attention(name, got, want, dtype_name) -> float:
    """Kernel against plain: every output (O and lse; dK and dV; dQ); lse
    is f32 and held to the f32 tolerance."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        dn = "float32" if w.dtype == torch.float32 else dtype_name
        err = max(err, check_close(f"{name} output {i}", g, w, dn, ATT_TOL))
    return err


def block_controls(att, q, k, v, do, causal=True, kv_mask=None) -> dict:
    """{kernel: block_rel_err reading of a fault} from the plain versions
    (at the lm_flash shape, causal; at the graph transformer's, with its
    key mask): the forward reading a stale V tile,
    keys [T - 384, T - 256) in place of [T - 256, T - 128) (a ring stage
    slip that lse does not see, and that only the last two query blocks
    read); dK/dV with the query tile [T/2, T/2 + 64) dropped (its dO and di
    rows zeroed), the smaller reading of dK's and dV's; dQ with the key tile
    [T/2, T/2 + 64) left out of dS K (those K rows zeroed)."""
    T = q.shape[0]
    kw = dict(causal=causal, kv_mask=kv_mask)
    do_full = do
    out, lse = att.flash_attention_fwd_plain(q, k, v, **kw)
    stale = v.clone()
    stale[T - 256:T - 128] = v[T - 384:T - 256]
    fwd = block_rel_err(att.flash_attention_fwd_plain(q, k, stale, **kw)[0], out)
    di = att.row_dot(out, do)
    want = att.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
    do, di = do.clone(), di.clone()
    do[T // 2:T // 2 + 64] = 0
    di[:, T // 2:T // 2 + 64] = 0  # di is [H, T]
    got = att.flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
    dkv = min(block_rel_err(g, w) for g, w in zip(got, want))
    di = att.row_dot(out, do_full)
    want = att.flash_attention_bwd_dq_plain(q, k, v, do_full, lse, di, **kw)
    k_out = k.clone()
    k_out[T // 2:T // 2 + 64] = 0  # those keys' dS is changed too, but meets zero rows
    got = att.flash_attention_bwd_dq_plain(q, k_out, v, do_full, lse, di, **kw)
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dkv": dkv,
            "flash_attention_bwd_dq": block_rel_err(got, want)}


def sdpa_calls(q, k, v, do, causal):
    """``scaled_dot_product_attention`` on the ``[1, H, T, D]`` layout (the
    yardstick, timed here and used nowhere in the port): its forward, and
    its backward, which gives dQ, dK and dV in one call."""
    import torch
    import torch.nn.functional as F

    q4, k4, v4, do4 = (t.permute(1, 0, 2).unsqueeze(0).contiguous() for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    fwd = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    bwd = lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True)
    return fwd, bwd, out.detach()[0].permute(1, 0, 2)


def phase_attention() -> dict:
    """The three flash-attention kernels against their plain versions on
    the card: at the lm_flash shape (T = 8192, H = 4, D = 128, causal, f32
    and bf16, timed beside the plain version, SDPA and the bound) and at edge
    cases (D in {32, 64, 128}, T = 200, no mask / a padded tail / every key
    masked, causal or not), two launches with equal bits each; then the
    autograd Function's gradients against autograd of ``dense_attention``.
    The bf16 outputs at the lm_flash shape (in place and as the LM's column
    slices) are also held to BLOCK_REL_TOL, whose force block_controls shows
    in the same run; the f32 forward's there to F32_FWD_TOL and the f32
    backward's to F32_BWD_TOL, whose force tf32_control and
    tf32_bwd_control show. Every kernel (all run on the tensor cores) also
    runs at the edges of its tiles and in the LM's layout, f32 held to the
    same two limits."""
    import torch

    from dgraph_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    records, worst, block_rel, controls = [], {}, {}, {}
    tc_kernels = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    f32_tol = {"flash_attention_fwd": F32_FWD_TOL, "flash_attention_bwd_dkv": F32_BWD_TOL,
               "flash_attention_bwd_dq": F32_BWD_TOL}
    f32_fwd, f32_bwd, bwd_ref, f64_readings = {}, {}, {}, {}

    def run_case(name, kernel, run, plain, dtype_name, scaled=False, split_tf32=False, ref=None):
        """Kernel against plain, two launches with equal bits; bf16 at
        lm_flash (``scaled``) also to BLOCK_REL_TOL, f32 (``split_tf32``)
        to the kernel's f32_tol, against ``ref`` (the plain outputs
        evaluated in float64) where it is given. Returns the error the
        f32 limit holds."""
        got = run()
        want = plain()
        torch.cuda.synchronize()
        err = check_attention(name, got, want, dtype_name)
        worst[(kernel, dtype_name)] = max(worst.get((kernel, dtype_name), 0.0), err)
        if ref is not None:  # the f32 plain version's own reading beside the kernel's
            outs = [x if isinstance(x, tuple) else (x,) for x in (got, want)]
            err, f64_readings[name] = (max(max_err(o, r) for o, r in zip(x, ref)) for x in outs)
        if split_tf32 and not err <= f32_tol[kernel]:
            fail(f"{name}: kernel disagrees with plain{' (float64)' if ref else ''} by "
                 f"{err:.3g} (limit {f32_tol[kernel]})")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (g, w) in enumerate(zip(got, want) if scaled else ()):
            if w.dtype != torch.float32:  # lse is held to 1e-4 already
                block_rel[f"{name} output {i}"] = r = block_rel_err(g, w)
                if r > BLOCK_REL_TOL:
                    fail(f"{name} output {i}: kernel disagrees with plain by {r:.3g} of a "
                         f"block's largest value (limit {BLOCK_REL_TOL})")
        again = run()
        for a, b in zip(got, again if isinstance(again, tuple) else (again,)):
            if not torch.equal(a, b):
                fail(f"{name}: two launches differ (kernel must be deterministic)")
        return err

    T, H, D = LM_T, LM_H, LM_D
    pairs = T * (T + 1) // 2  # causal, no mask: the work this input needs
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        q, k, v, do = (torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        kw = dict(causal=True)
        if dtype_name == "float32":
            f32_fwd["tf32_control"] = r = tf32_control(
                att, q, k, v, *att.flash_attention_fwd_plain(q, k, v, **kw))
            log(f"f32 forward's TF32 control (plain, lm_flash shape): {r:.3g}")
            if not r > F32_FWD_TOL:
                fail(f"the TF32 control reads {r:.3g}, inside the f32 forward's limit "
                     f"{F32_FWD_TOL}: the check has no force")
            out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
            dk64, dv64, dq64 = plain_bwd_f64(att, q, k, v, do, lse_p, att.row_dot(out_p, do))
            del out_p, lse_p
            bwd_ref = {"flash_attention_bwd_dkv": (dk64, dv64), "flash_attention_bwd_dq": (dq64,)}
            f32_bwd["tf32_control"] = r = tf32_bwd_control(att, q, k, v, do, (dk64, dv64, dq64))
            log(f"f32 backward's TF32 control (plain, lm_flash shape): {r:.3g}")
            if not r > F32_BWD_TOL:
                fail(f"the TF32 backward control reads {r:.3g}, inside the f32 backward's "
                     f"limit {F32_BWD_TOL}: the check has no force")
        if dtype_name == "bfloat16":
            controls = block_controls(att, q, k, v, do)
            log(f"block_rel_err of a dropped tile (plain, lm_flash shape): {controls}")
            for kernel, r in controls.items():
                if not r > BLOCK_REL_TOL:
                    fail(f"{kernel}: a dropped tile reads {r:.3g}, inside the scale-aware "
                         f"limit {BLOCK_REL_TOL}: the check has no force")
        sdpa_fwd, sdpa_bwd, sdpa_out = sdpa_calls(q, k, v, do, True)
        for kernel, (run, plain) in attention_cases(att, q, k, v, do, kw).items():
            name = f"{kernel} {dtype_name} T={T} H={H} D={D} causal"
            ref = bwd_ref.get(kernel) if dtype_name == "float32" else None
            err = run_case(name, kernel, run, plain, dtype_name, scaled=dtype_name == "bfloat16",
                           split_tf32=dtype_name == "float32", ref=ref)
            if dtype_name == "float32" and kernel == "flash_attention_fwd":
                f32_fwd["max_abs_err"] = err
            elif dtype_name == "float32":
                f32_bwd[kernel] = err
            nbytes, ops = attention_work(kernel, T, H, D, q.element_size(), pairs)
            lib = sdpa_fwd if kernel == "flash_attention_fwd" else sdpa_bwd
            rec = {"kernel": kernel, "case": name, "dtype": dtype_name, "T": T, "H": H, "D": D,
                   "causal": True, "pairs": pairs, "max_abs_err": err, "ms": time_ms(run),
                   "plain_ms": time_ms(plain, reps=3, warmup=1), "library_ms": time_ms(lib),
                   "library": "sdpa forward" if lib is sdpa_fwd else "sdpa backward (dQ, dK, dV)",
                   **attention_bound(kernel, dtype_name, nbytes, ops)}
            records.append(rec)
            log(f"{name}: err {err:.3g} kernel {rec['ms']:.3f} ms plain {rec['plain_ms']:.3f} "
                f"ms {rec['library']} {rec['library_ms']:.3f} ms bound {rec['bound_ms']:.3f} ms "
                f"({rec['bound_by']})")
            if dtype_name == "float32" and kernel == "flash_attention_fwd":
                f32_fwd.update(ms=rec["ms"], sdpa_ms=rec["library_ms"],
                               faster_than_sdpa=rec["ms"] < rec["library_ms"])
                log(f"f32 forward (split TF32): {rec['ms']:.3f} ms against SDPA's f32 forward "
                    f"{rec['library_ms']:.3f} ms; err {err:.3g} (limit {F32_FWD_TOL}, TF32 "
                    f"control {f32_fwd['tf32_control']:.3g}); bound {rec['bound_tf32x3_ms']:.3f} "
                    f"ms split TF32, {rec['bound_cuda_cores_ms']:.3f} ms CUDA cores")
            if dtype_name == "float32" and kernel == "flash_attention_bwd_dq":
                dkv = next(r for r in records if r["dtype"] == "float32"
                           and r["kernel"] == "flash_attention_bwd_dkv")
                f32_bwd.update(dkv_ms=dkv["ms"], dq_ms=rec["ms"], sum_ms=dkv["ms"] + rec["ms"],
                               sdpa_bwd_ms=[dkv["library_ms"], rec["library_ms"]],
                               plain_f32_vs_f64={n: f64_readings[n] for n in (dkv["case"], name)})
                f32_bwd["faster_than_sdpa"] = f32_bwd["sum_ms"] < min(f32_bwd["sdpa_bwd_ms"])
                log(f"f32 backward (split TF32): dK/dV {dkv['ms']:.3f} + dQ {rec['ms']:.3f} = "
                    f"{f32_bwd['sum_ms']:.3f} ms against SDPA's f32 backward "
                    f"{dkv['library_ms']:.3f}, {rec['library_ms']:.3f} ms; err "
                    f"{f32_bwd['flash_attention_bwd_dkv']:.3g}, {err:.3g} (limit {F32_BWD_TOL}, "
                    f"TF32 control {f32_bwd['tf32_control']:.3g}; the f32 plain version's own "
                    f"{f64_readings[dkv['case']]:.3g}, {f64_readings[name]:.3g}); bounds "
                    f"split TF32 "
                    f"{dkv['bound_tf32x3_ms']:.3f}, {rec['bound_tf32x3_ms']:.3f} ms, CUDA cores "
                    f"{dkv['bound_cuda_cores_ms']:.3f}, {rec['bound_cuda_cores_ms']:.3f} ms")
        # the yardstick need only compute the same function: held to the
        # bf16 tolerance in both types (its f32 path may round inside)
        want = att.flash_attention_fwd_plain(q, k, v, **kw)[0]
        if not torch.allclose(sdpa_out.float(), want.float(), rtol=ATT_TOL["bfloat16"],
                              atol=ATT_TOL["bfloat16"]):
            fail(f"sdpa {dtype_name}: the library yardstick disagrees with plain "
                 f"(max abs err {max_err(sdpa_out, want)})")
        del q, k, v, do, sdpa_fwd, sdpa_bwd, sdpa_out, want
        bwd_ref = {}
        torch.cuda.empty_cache()

    T = 200
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for D in (32, 64, 128):
            q, k, v, do = (torch.randn(T, 2, D, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            for mask in ("none", "tail", "all"):
                m = None if mask == "none" else torch.ones(T, device=dev)
                if m is not None:
                    m[T - 37 if mask == "tail" else 0:] = 0
                for causal in (False, True):
                    kw = dict(causal=causal, kv_mask=m)
                    for kernel, (run, plain) in attention_cases(att, q, k, v, do, kw).items():
                        run_case(f"{kernel} edge {dtype_name} T={T} D={D} mask={mask} "
                                 f"causal={causal}", kernel, run, plain, dtype_name)

    # every kernel (bf16 and f32, all on the tensor cores) at the edges of
    # its 16-, 32-, 64- and 128-row tiles, every head width; then in the LM's
    # layout, q, k and v as column slices of one [T, 3L] tensor read in
    # place, and as slices at an odd element offset, which _operand copies
    # first
    for T in (1, 31, 33, 63, 64, 65, 127, 128, 129, 200):
        for D in (32, 64, 128):
            for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
                q, k, v, do = (torch.randn(T, 2, D, generator=gen, device=dev).to(dtype)
                               for _ in range(4))
                for causal in (False, True):
                    cases = attention_cases(att, q, k, v, do, dict(causal=causal))
                    for kernel in tc_kernels:
                        run_case(f"{kernel} tile edge {dtype_name} T={T} D={D} causal={causal}",
                                 kernel, *cases[kernel], dtype_name,
                                 split_tf32=dtype_name == "float32")
    T, H, D = LM_T, LM_H, LM_D
    L = H * D
    for dtype_name, dtype, pad in (("bfloat16", torch.bfloat16, 8), ("float32", torch.float32, 4)):
        do = torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
        for off, width in ((0, 3 * L), (3, 3 * L + pad)):
            qkv = torch.randn(T, width, generator=gen, device=dev).to(dtype)
            q, k, v = (qkv[:, off + i * L:off + (i + 1) * L].view(T, H, D) for i in range(3))
            if (att._operand(q) is q) != (off == 0):
                fail(f"_operand: a [T, {width}] {dtype_name} column slice at offset {off} "
                     f"should {'pass in place' if off == 0 else 'be copied'}")
            cases = attention_cases(att, q, k, v, do, dict(causal=True))
            refs = {}
            if dtype_name == "float32":
                out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, causal=True)
                dk64, dv64, dq64 = plain_bwd_f64(att, q, k, v, do, lse_p, att.row_dot(out_p, do))
                refs = {"flash_attention_bwd_dkv": (dk64, dv64), "flash_attention_bwd_dq": (dq64,)}
                del out_p, lse_p, dk64, dv64, dq64
            for kernel in tc_kernels:
                run_case(f"{kernel} qkv slices {dtype_name} offset={off} T={T} H={H} D={D} causal",
                         kernel, *cases[kernel], dtype_name, scaled=dtype_name == "bfloat16",
                         split_tf32=dtype_name == "float32", ref=refs.get(kernel))
            del qkv, q, k, v, cases, refs
        del do
        torch.cuda.empty_cache()

    gt = phase_attention_gt(att, gen, run_case)

    T = 200
    grad_err = 0.0
    q, k, v, cot = (torch.randn(T, 2, 128, generator=gen, device=dev) for _ in range(4))
    for mask in ("none", "tail"):
        m = None if mask == "none" else (torch.arange(T, device=dev) < T - 37).float()
        for causal in (False, True):
            res = []
            for fn in (att.flash_attention, att.dense_attention):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                out = fn(*leaves, causal=causal, kv_mask=m)
                out.backward(cot)
                res.append([out.detach()] + [t.grad for t in leaves])
            for what, a, b in zip(("out", "dq", "dk", "dv"), *res):
                grad_err = max(grad_err, check_close(
                    f"flash_attention autograd {what} mask={mask} causal={causal}", a, b,
                    "float32", ATT_TOL))
    torch.cuda.synchronize()
    log(f"attention edge cases and autograd passed; worst abs err {worst}; autograd vs "
        f"dense_attention {grad_err:.3g}")
    log(f"block_rel_err at the lm_flash shape, bf16 (limit {BLOCK_REL_TOL}): "
        f"{ {k: round(v, 6) for k, v in block_rel.items()} }")
    records += gt.pop("records")
    return {"records": records, "autograd_max_abs_err": grad_err,
            "worst_abs_err": {f"{k}/{d}": v for (k, d), v in worst.items()},
            "block_rel_err": block_rel, "block_rel_err_controls": controls,
            "f32_forward": f32_fwd, "f32_backward": f32_bwd, "gt": gt}


def gt_key_mask(T: int, dev, inner: bool = True):
    """The graph transformer's ``[T]`` key mask: the last slot padded (as
    arxiv's 169,344 slots hold 169,343 vertices) and, with ``inner``, three
    more padded slots inside the tiles."""
    import torch

    m = torch.ones(T, device=dev)
    m[-1] = 0
    if inner:
        m[[1000, 5001, 9999]] = 0
    return m


GT_SAMPLED_ROWS = (128, 256, 128)  # the first rows, rows drawn from the seed, the last rows


def gt_rows(T: int, seed: int = 0):
    """GT_SAMPLED_ROWS of T rows, sorted: the first rows, rows drawn from
    ``seed`` and the last rows (the padded slot among them)."""
    import numpy as np

    head, mid, tail = GT_SAMPLED_ROWS
    drawn = np.random.default_rng(seed).choice(np.arange(head, T - tail), mid, replace=False)
    return np.concatenate([np.arange(head), np.sort(drawn), np.arange(T - tail, T)])


def sampled_bwd_f64(q, k, v, do, lse, di, kv_mask, rows) -> tuple:
    """The plain backward's formula, non-causal with ``kv_mask`` (which
    masks the query rows too, as the kernels read it), evaluated in float64
    at the sampled ``rows`` only: (dK[rows], dV[rows]) over every query and
    dQ[rows] over every key, from the same inputs, lse and di; P and dS are
    rounded to the inputs' dtype before their products, as the kernels
    round them (not at all in f32). One head at a time: [T, rows] f64."""
    import torch

    T, H, D = q.shape
    scale = D ** -0.5
    real = kv_mask > 0
    r = torch.as_tensor(rows, device=q.device)
    to_q = real[r, None] & real[None, :]  # [rows, T]: sampled queries, every key
    to_k = real[:, None] & real[None, r]  # [T, rows]: every query, sampled keys
    rnd = lambda x: x.to(q.dtype).double()  # noqa: E731
    dk, dv, dq = (torch.empty(len(rows), H, D, dtype=torch.float64, device=q.device)
                  for _ in range(3))
    for h in range(H):
        qh, kh, vh, doh = (t[:, h].double() for t in (q, k, v, do))
        lh, dh = lse[h].double(), di[h].double()
        p = torch.where(to_q, torch.exp(qh[r] @ kh.T * scale - lh[r, None]), 0.0)
        dq[:, h] = rnd((doh[r] @ vh.T - dh[r, None]) * p * scale) @ kh
        p = torch.where(to_k, torch.exp(qh @ kh[r].T * scale - lh[:, None]), 0.0)
        dv[:, h] = rnd(p).T @ doh
        dk[:, h] = rnd((doh @ vh[r].T - dh[:, None]) * p * scale).T @ qh
        del p
    return dk, dv, dq


def gt_full_t_grads(q, k, v, do, lse, di, kv_mask, got, sdpa_grads, dtype_name) -> dict:
    """dK/dV (7a) and dQ (7b), ``got`` = (dK, dV, dQ), at T = GT_T, where
    the plain version cannot run: at the sampled rows (gt_rows; dK and dV
    at key rows, dQ at query rows) against the plain backward evaluated in
    float64 from the same inputs, lse and di (sampled_bwd_f64) -- f32 to
    F32_BWD_TOL against a TF32 control, bf16 by block_rel_err to
    GT_BLOCK_REL_TOL against dropped-tile controls (block_controls' faults:
    dK/dV without the query tile [T/2, T/2 + 64), dQ without the key tile
    there); every real row against SDPA's gradients on the real rows
    (``sdpa_grads``, (dQ, dK, dV) as [T - 1, H, D]), f32 to ATT_TOL and bf16
    to BLOCK_REL_TOL; the padded slot's gradients zero. Returns the
    readings; fails after logging them."""
    import torch

    T = q.shape[0]
    rows = gt_rows(T)
    r = torch.as_tensor(rows, device=q.device)
    ref = sampled_bwd_f64(q, k, v, do, lse, di, kv_mask, rows)
    got_rows = [g[r] for g in got]
    names = ("dK", "dV", "dQ")
    if dtype_name == "float32":
        limit = F32_BWD_TOL
        reading = {n: float((g.double() - w).abs().max()) for n, g, w in zip(names, got_rows, ref)}
        ctl = sampled_bwd_f64(*(tf32_trunc(t) for t in (q, k, v, do)), lse, di, kv_mask, rows)
        controls = {"tf32": max(float((c - w).abs().max()) for c, w in zip(ctl, ref))}
    else:
        limit = GT_BLOCK_REL_TOL
        reading = {n: block_rel_err(g, w) for n, g, w in zip(names, got_rows, ref)}
        h = T // 2
        do_out, di_out = do.clone(), di.clone()
        do_out[h:h + 64] = 0
        di_out[:, h:h + 64] = 0  # di is [H, T]
        ctl = sampled_bwd_f64(q, k, v, do_out, lse, di_out, kv_mask, rows)
        k_out = k.clone()
        k_out[h:h + 64] = 0
        controls = {"dkv_query_tile_dropped": min(block_rel_err(c, w)
                                                  for c, w in zip(ctl[:2], ref[:2])),
                    "dq_key_tile_dropped": block_rel_err(
                        sampled_bwd_f64(q, k_out, v, do, lse, di, kv_mask, rows)[2], ref[2])}
        del do_out, di_out, k_out
    del ctl
    by_name = dict(zip(names, got))
    sdpa = {n: (max_err(by_name[n][:-1], w) if dtype_name == "float32"
                else block_rel_err(by_name[n][:-1], w))
            for n, w in zip(("dQ", "dK", "dV"), sdpa_grads)}
    sdpa_limit = ATT_TOL["float32"] if dtype_name == "float32" else BLOCK_REL_TOL
    real = kv_mask > 0
    padded_zero = all(bool((g[~real] == 0).all()) for g in got)
    rec = {"rows": len(rows), "T": T, "reading": reading, "limit": limit, "controls": controls,
           "vs_sdpa": sdpa, "vs_sdpa_limit": sdpa_limit, "padded_rows_zero": padded_zero,
           "max_abs_ref": max(float(w.abs().max()) for w in ref)}
    what = f"gt {dtype_name} T={T} backward"
    log(f"{what}: {len(rows)} sampled rows against float64 {reading} (limit {limit}), controls "
        f"{controls}; every real row against SDPA's gradients {sdpa} (limit {sdpa_limit}); "
        f"padded rows zero: {padded_zero}")
    bad = [f"{n} reads {x:.3g} > {limit}" for n, x in reading.items() if not x <= limit]
    bad += [f"control {n} reads {x:.3g}, inside the limit {limit}: the check has no force"
            for n, x in controls.items() if not x > limit]
    bad += [f"{n} is {x:.3g} from SDPA's (limit {sdpa_limit})" for n, x in sdpa.items()
            if not x <= sdpa_limit]
    bad += [] if padded_zero else ["the padded slot's gradients are not zero"]
    if bad:
        fail(f"{what}: {bad}")
    return rec


def phase_attention_gt(att, gen, run_case) -> dict:
    """Phase 3 at the graph transformer's shape (H = 4, D = 32,
    non-causal, a key mask): the three kernels at T = GT_CHECK_T against
    their plain versions, f32 and bf16, in place and as column slices of
    one [T, 3L] tensor (the model's layout, read in place), through
    ``run_case`` with phase 3's limits: f32 to F32_FWD_TOL and F32_BWD_TOL
    (the backward against the plain backward evaluated in float64), each
    against its TF32 control, bf16 to BLOCK_REL_TOL against the dropped-tile
    controls. Then at T = GT_T (the model's layout, the padded slot
    masked) dK/dV and dQ held at sampled rows to float64 and at every real
    row to SDPA (gt_full_t_grads), and each kernel timed beside SDPA on the
    169,343 real rows, unmasked: the same function on every real row.
    Returns the records and readings."""
    import torch

    dev = torch.device("cuda")
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    H, D = GT_H, GT_D
    L = H * D
    T = GT_CHECK_T
    kw = dict(causal=False, kv_mask=gt_key_mask(T, dev))
    out = {"controls": {}, "max_abs_err": {}, "records": []}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        qkv = torch.randn(T, 3 * L, generator=gen, device=dev).to(dtype)
        do = torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
        slices = [t.view(T, H, D) for t in qkv.split(L, dim=-1)]
        refs = {}
        if dtype_name == "float32":
            q, k, v = slices
            out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
            c_fwd = tf32_control(att, q, k, v, out_p, lse_p, **kw)
            dk64, dv64, dq64 = plain_bwd_f64(att, q, k, v, do, lse_p, att.row_dot(out_p, do),
                                             **kw)
            del out_p, lse_p
            c_bwd = tf32_bwd_control(att, q, k, v, do, (dk64, dv64, dq64), **kw)
            refs = {"flash_attention_bwd_dkv": (dk64, dv64), "flash_attention_bwd_dq": (dq64,)}
            out["controls"]["float32"] = {"forward_tf32": c_fwd, "backward_tf32": c_bwd}
            log(f"gt shape T={T} D={D}: TF32 controls (plain) forward {c_fwd:.3g} (limit "
                f"{F32_FWD_TOL}), backward {c_bwd:.3g} (limit {F32_BWD_TOL})")
            weak = [f"TF32 {what} control {r:.3g} <= {tol}" for what, r, tol in
                    (("forward", c_fwd, F32_FWD_TOL), ("backward", c_bwd, F32_BWD_TOL))
                    if not r > tol]
        else:
            ctl = block_controls(att, *slices, do, **kw)
            out["controls"]["bfloat16"] = ctl
            log(f"gt shape T={T} D={D}: block_rel_err of a dropped tile (plain) {ctl}")
            weak = [f"{kernel} dropped-tile control {r:.3g} <= {BLOCK_REL_TOL}"
                    for kernel, r in ctl.items() if not r > BLOCK_REL_TOL]
        for layout, (q, k, v) in (("in place", [t.contiguous() for t in slices]),
                                  ("qkv slices", slices)):
            if layout == "qkv slices" and att._operand(q) is not q:
                fail(f"_operand: the graph transformer's {dtype_name} qkv column slice "
                     "should pass in place")
            cases = attention_cases(att, q, k, v, do, kw)
            for kernel in kernels:
                err = run_case(f"{kernel} gt {layout} {dtype_name} T={T} H={H} D={D} masked",
                               kernel, *cases[kernel], dtype_name,
                               scaled=dtype_name == "bfloat16",
                               split_tf32=dtype_name == "float32", ref=refs.get(kernel))
                key = f"{kernel}/{dtype_name}"
                out["max_abs_err"][key] = max(out["max_abs_err"].get(key, 0.0), err)
            del cases
        if weak:  # after the kernels' readings are logged
            fail(f"gt shape {dtype_name}: a control reads inside its limit, the check has no "
                 f"force: {weak}")
        del qkv, do, slices, refs
        torch.cuda.empty_cache()

    T = GT_T
    kw = dict(causal=False, kv_mask=gt_key_mask(T, dev, inner=False))
    pairs = (T - 1) ** 2  # the work of the real rows; a padded query row is empty
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        qkv = torch.randn(T, 3 * L, generator=gen, device=dev).to(dtype)
        do = torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
        q, k, v = (t.view(T, H, D) for t in qkv.split(L, dim=-1))
        o, lse = att.flash_attention_fwd(q, k, v, **kw)
        di = att.row_dot(o, do)
        runs = {"flash_attention_fwd": lambda: att.flash_attention_fwd(q, k, v, **kw),
                "flash_attention_bwd_dkv": lambda: att.flash_attention_bwd_dkv(
                    q, k, v, do, lse, di, **kw),
                "flash_attention_bwd_dq": lambda: att.flash_attention_bwd_dq(
                    q, k, v, do, lse, di, **kw)}
        sdpa_fwd, sdpa_bwd, sdpa_out = sdpa_calls(q[:-1], k[:-1], v[:-1], do[:-1], False)
        if not torch.allclose(sdpa_out.float(), o[:-1].float(), rtol=ATT_TOL["bfloat16"],
                              atol=ATT_TOL["bfloat16"]):
            fail(f"sdpa {dtype_name} at T={T}: the yardstick disagrees with the forward kernel "
                 f"on the real rows (max abs err {max_err(sdpa_out, o[:-1])})")
        grads = (*runs["flash_attention_bwd_dkv"](), runs["flash_attention_bwd_dq"]())
        sdpa_grads = [g[0].permute(1, 0, 2) for g in sdpa_bwd()]
        full_t = gt_full_t_grads(q, k, v, do, lse, di, kw["kv_mask"], grads, sdpa_grads,
                                 dtype_name)
        out.setdefault("full_t", {})[dtype_name] = full_t
        del grads, sdpa_grads
        lib_ms = {"flash_attention_fwd": time_ms(sdpa_fwd, reps=GT_REPS, warmup=1)}
        lib_ms["flash_attention_bwd_dkv"] = lib_ms["flash_attention_bwd_dq"] = time_ms(
            sdpa_bwd, reps=GT_REPS, warmup=1)
        for kernel in kernels:
            nbytes, ops = attention_work(kernel, T, H, D, qkv.element_size(), pairs)
            rec = {"kernel": kernel, "case": f"{kernel} {dtype_name} T={T} H={H} D={D} gt",
                   "dtype": dtype_name, "T": T, "H": H, "D": D, "causal": False,
                   "pairs": pairs,
                   "max_abs_err": out["max_abs_err"][f"{kernel}/{dtype_name}"],
                   "max_abs_err_case": f"T={GT_CHECK_T}, the same mask form",
                   "ms": time_ms(runs[kernel], reps=GT_REPS, warmup=1), "plain_ms": None,
                   "plain_note": "the plain version's [H, T, T] scores would take 459 GB; " + (
                       "phase 10 holds 512 sampled rows to float64 instead"
                       if kernel == "flash_attention_fwd" else "512 sampled rows are held to "
                       "float64 here instead (gt_full_t_grads), every real row to SDPA's"),
                   "library_ms": lib_ms[kernel],
                   "library": ("sdpa forward" if kernel == "flash_attention_fwd" else
                               "sdpa backward (dQ, dK, dV)") + " on the 169,343 real rows",
                   **attention_bound(kernel, dtype_name, nbytes, ops)}
            out["records"].append(rec)
            log(f"{rec['case']}: kernel {rec['ms']:.3f} ms, {rec['library']} "
                f"{rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
        del qkv, do, q, k, v, o, lse, di, runs, sdpa_fwd, sdpa_bwd, sdpa_out
        torch.cuda.empty_cache()
    return out


# --- phases 4 and 5 --------------------------------------------------------


def arxiv_config(model: str):
    from dgraph_tpu_torch.data.synthetic import ARXIV_AVG_DEGREE, ARXIV_NODES
    from dgraph_tpu_torch.serve.__main__ import Config

    return Config(
        model=model, num_nodes=ARXIV_NODES, feat_dim=128, hidden=256,
        num_classes=40, avg_degree=ARXIV_AVG_DEGREE, num_layers=2,
        min_bucket=8, max_bucket=1024, growth=2.0, seed=0, world_size=1,
    )


def request_sizes(n_requests: int, ladder, seed: int):
    """Request sizes spread evenly over the ladder's buckets (each size
    uniform within its bucket), in random order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lows = (0,) + ladder.sizes[:-1]
    sizes = [int(rng.integers(lows[i % len(lows)] + 1, ladder.sizes[i % len(lows)] + 1))
             for i in range(n_requests)]
    return rng, [sizes[i] for i in rng.permutation(n_requests)]


def cpu_reference(engine, graph):
    """The engine's model and graph on the CPU (plain PyTorch path)."""
    import torch

    from dgraph_tpu_torch.train.loop import model_apply

    model = copy.deepcopy(engine.model).cpu()
    batch = {"x": graph.features[0]}
    if graph.edge_weight is not None:
        batch["edge_weight"] = graph.edge_weight[0]
    with torch.inference_mode():
        return model_apply(model, batch, graph.plan.shard(0)).numpy()


def serve_path(model: str, kernel: str, per_forward, n_requests: int) -> dict:
    """Build, warm, drive ``n_requests`` through the batcher with the launch
    counts reset just before, and check the results."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import segment as seg
    from dgraph_tpu_torch.serve.__main__ import build_serving

    cfg = arxiv_config(model)
    t0 = time.perf_counter()
    engine, batcher, graph = build_serving(cfg, device="cuda")
    build_s = time.perf_counter() - t0
    try:
        warm = engine.warmup()
        log(f"{model}: graph+engine {build_s:.1f} s, warmup {warm['warmup_s']} s "
            f"(E={graph.num_edges}, e_pad={graph.plan.e_pad}, n_pad={graph.plan.n_src_pad})")
        rng, sizes = request_sizes(n_requests, engine.ladder, seed=1)
        seg.reset_launch_counts()
        forwards0 = engine.forwards
        served, lat = [], {}
        for n in sizes:
            ids = rng.choice(engine.num_nodes, size=n, replace=False)
            t = time.perf_counter()
            out = batcher.infer(ids)
            lat.setdefault(engine.ladder.bucket_for(n), []).append(
                (time.perf_counter() - t) * 1e3)
            served.append((ids, out))
        launches = seg.launch_counts()
        forwards = engine.forwards - forwards0
    finally:
        batcher.stop()
    if launches[kernel] != per_forward * forwards or forwards == 0:
        fail(f"{model}: {kernel} launched {launches[kernel]} times over "
             f"{forwards} forwards (want {per_forward} per forward)")
    backward_only = ("sorted_segment_sum_act", "fused_bwd_gd", "sorted_row_gather")
    if any(launches[k] for k in backward_only):
        fail(f"{model}: serving (inference_mode, gather flag off) launched a "
             f"training kernel: {launches}")
    if any(v for k, v in launches.items() if k.endswith(".hub_calls")):
        fail(f"{model}: the hub route ran on the SBM graph's owner ids: "
             f"{launches}")
    full = engine.full_logits()
    if not np.isfinite(full).all() or full.shape != (1, graph.plan.n_src_pad, cfg.num_classes):
        fail(f"{model}: full logits non-finite or shape {full.shape}")
    for ids, out in served:
        r, s = engine.rank_slot(ids)
        if out.shape != (len(ids), cfg.num_classes) or not np.array_equal(out, full[r, s]):
            fail(f"{model}: served rows differ from full_logits()")
    t = time.perf_counter()
    ref = cpu_reference(engine, graph)
    cpu_s = time.perf_counter() - t
    err = float(np.abs(full[0] - ref).max())
    if not np.allclose(full[0], ref, rtol=SERVE_TOL, atol=SERVE_TOL):
        fail(f"{model}: card logits differ from the CPU plain path (max abs err {err})")
    buckets = {
        str(b): {"count": len(v), "p50_ms": float(np.percentile(v, 50)),
                 "p99_ms": float(np.percentile(v, 99))}
        for b, v in sorted(lat.items())
    }
    log(f"{model}: {len(served)} requests, {forwards} forwards, launches {launches}; "
        f"served == full_logits bitwise; vs CPU max abs err {err:.3g} "
        f"(CPU forward {cpu_s:.1f} s)")
    for b, rec in buckets.items():
        log(f"{model}: bucket {b}: n={rec['count']} p50 {rec['p50_ms']:.3f} ms "
            f"p99 {rec['p99_ms']:.3f} ms")
    del engine
    torch.cuda.empty_cache()
    return {"model": model, "requests": len(served), "forwards": forwards,
            "launches": launches, "cpu_max_abs_err": err, "buckets": buckets,
            "warmup_s": warm["warmup_s"], "build_s": build_s}


def sage_launches_per_forward(cfg) -> int:
    """Sorted segment sums per GraphSAGE forward: each layer's feature
    chunks plus its degree count."""
    from dgraph_tpu_torch import config

    widths = [cfg.feat_dim] + [cfg.hidden] * (cfg.num_layers - 1)
    return sum(math.ceil(w / config.gather_col_block) + 1 for w in widths)


# --- phases 6 and 7 --------------------------------------------------------


def grads_of(model) -> dict:
    return {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}


def cpu_step0(model_cpu, batch, plan, loss_fn) -> tuple:
    """(loss, grads) of one forward and backward of ``model_cpu`` on the
    CPU plain path: the oracle of a card step's gradients."""
    from dgraph_tpu_torch.train.loop import model_apply

    b = {k: v[0] for k, v in batch.items()}
    model_cpu.zero_grad(set_to_none=True)
    loss = loss_fn(model_apply(model_cpu, b, plan.shard(0)), b["y"], b["mask"])
    loss.backward()
    return float(loss.detach()), grads_of(model_cpu)


def grad_margins(got: dict, want: dict, scaled: bool = False) -> dict:
    """Per leaf: its largest absolute error against ``want``, the atol it is
    held to (GRAD_TOL; with ``scaled``, GRAD_TOL times the leaf's largest
    magnitude, at least 1, as the loss's limit is its magnitude's), and its
    margin, the largest ``|got - want| / (atol + GRAD_TOL |want|)`` (above 1
    fails :func:`check_grads`)."""
    out = {}
    for k, w in want.items():
        atol = GRAD_TOL * max(1.0, float(w.abs().max())) if scaled else GRAD_TOL
        d = (got[k] - w).abs()
        out[k] = {"max_abs_err": float(d.max()), "atol": atol,
                  "margin": float((d / (atol + GRAD_TOL * w.abs())).max())}
    return out


def check_grads(what, got: dict, want: dict, scaled: bool = False,
                leaves: dict | None = None) -> float:
    """Every gradient within rtol = GRAD_TOL and the atol of
    :func:`grad_margins` of the CPU's; ``leaves`` receives each leaf's
    error, atol and margin. Returns the largest absolute error."""
    import torch

    margins = grad_margins(got, want, scaled)
    for k, w in want.items():
        if not torch.isfinite(got[k]).all():
            fail(f"{what}: non-finite gradient {k}")
        if not torch.allclose(got[k], w, rtol=GRAD_TOL, atol=margins[k]["atol"]):
            fail(f"{what}: gradient {k} differs from the CPU plain path ({margins[k]}, "
                 f"rtol {GRAD_TOL})")
    if leaves is not None:
        leaves.update(margins)
    return max(m["max_abs_err"] for m in margins.values())


def cached_hub_rows() -> list:
    """The hub rows of each segment plan cached in this process (the plans
    of the ids tensors alive now, ``ops.segment.segment_plan``), one list a
    plan that has hubs."""
    import gc

    from dgraph_tpu_torch.ops import segment as seg

    gc.collect()
    rows = []
    for _, plans in list(seg._offsets.values()):
        for _, plan in plans.values():
            if plan.hub is not None:
                rows.append(plan.hub.chunks[0, plan.hub.first[:-1]].tolist())
    return rows


# what -> the hub rows of the plans cached at that run's first launch check
_HUB_ROWS: dict = {}


def check_step_launches(what, step, counts, want, hubs=False, hub_rows=None) -> None:
    """Every kernel of ``want`` launched exactly as often. With ``hubs`` (a
    graph with hubs) the hub route (``<kernel>.hub_calls``) ran on some call
    of each sorted sum that launched. On the SBM graph (largest degree 37 in
    the CLI's one-rank plan) a plan holds one hub at most: src row 0, where
    the src-side ids put every padded edge (186 in bench_gcn's plan, no hub;
    820 in the CLI's one-rank plan, a hub of zero rows). So every hub of the
    plans cached when ``what`` is first checked (``hub_rows``, else
    :func:`cached_hub_rows` then) must be row 0, and without one the route
    runs on no call."""
    for k, n in want.items():
        if counts[k] != n:
            fail(f"{what}: step {step} launched {k} {counts[k]} times (want {n}); "
                 f"counts {counts}")
    if not hubs:
        if hub_rows is None:
            if what not in _HUB_ROWS:
                _HUB_ROWS[what] = cached_hub_rows()
            hub_rows = _HUB_ROWS[what]
        if any(rows != [0] for rows in hub_rows):
            fail(f"{what}: step {step}: a plan of the SBM graph holds hubs other than its "
                 f"padded src row 0: {hub_rows}")
    for k, n in counts.items():
        if not k.endswith(".hub_calls"):
            continue
        launched = counts[k.removesuffix(".hub_calls")]
        most = launched if hubs or hub_rows else 0
        if n > most or (hubs and launched and n < 1):
            fail(f"{what}: step {step}: {k} = {n} with {launched} launches "
                 f"({'a graph with hubs' if hubs else f'the SBM graph, hubs {hub_rows}'}); "
                 f"counts {counts}")


@contextlib.contextmanager
def dropped_hub_chunk():
    """The CPU plain path with a fault: kernel 1's forward
    (``sorted_segment_sum_bias_relu_plain``) leaves out the first chunk of
    the hub with the most chunks of each call's ids, as a hub route that lost
    a chunk would. Yields a dict that records the chunk left out."""
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    plain = seg.sorted_segment_sum_bias_relu_plain
    dropped = {}

    def faulty(data, ids, bias, n, *, edge_weight=None):
        out = plain(data, ids, bias, n, edge_weight=edge_weight)
        row_ptr = seg._row_ptr(ids, n)
        hub = seg.hub_plan(row_ptr)
        if hub is None:
            return out
        c = int(hub.first[int(torch.argmax(hub.first.diff()))])
        row, a, b = hub.chunks[:, c].tolist()
        lo, _, m = seg._bias_messages(data, ids, bias, n, edge_weight, False)
        out = out.clone()
        out[row] = (out[row].float() - m[a - lo:b - lo].sum(0)).to(out.dtype)
        dropped.update(row=row, chunk_edges=b - a,
                       row_edges=int(row_ptr[row + 1] - row_ptr[row]))
        return out

    seg.sorted_segment_sum_bias_relu_plain = faulty
    try:
        yield dropped
    finally:
        seg.sorted_segment_sum_bias_relu_plain = plain


def phase_train_bench_gcn(edges=None, what="train bench_gcn") -> dict:
    """bench.py's bench_gcn (bench.py:428-534) on the port: the arxiv-shaped
    random graph (or ``edges``, a graph with hubs), GCN F=128 H=256 C=40,
    unweighted, Adam 1e-3, f32. Two warm-up steps, ten timed (CUDA events
    around each, under torch.profiler for the busy share); launches checked
    every step (with ``edges``, the hub route on some call of each sorted
    sum); no step after the first computes CSR offsets or a hub plan; step
    0's loss and every gradient against the CPU plain path. With ``edges``
    the gradients are held to GRAD_TOL of each leaf's largest magnitude
    (:func:`check_grads`, ``scaled``), as the loss always is: two layers of
    unweighted sums over rows of up to 15,001 edges make a loss of about
    8,000, where an absolute 1e-4 reads the f32 summation order of the card
    and of the CPU plain path, not a fault. That limit is then read on a
    control, the CPU step with kernel 1's forward leaving out one chunk of
    its largest hub (:func:`dropped_hub_chunk`), which it must fail; each
    leaf's error, atol and margin are kept for the run and the control."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from dgraph_tpu_torch.ops import segment as seg
    from dgraph_tpu_torch.train.loop import masked_cross_entropy
    from dgraph_tpu_torch.train.profile import bench_gcn_setup, device_ops

    t0 = time.perf_counter()
    model, step, batch_d, plan, batch, model_cpu = bench_gcn_setup(torch.device("cuda"), edges)
    setup_s = time.perf_counter() - t0
    hubs = edges is not None
    chunks = 2 * math.ceil(256 / 128)  # 2 layers of H = 256
    # kernel 2 runs once per chunk as the VJP of the src-side take (the
    # halo sort route's backward); no other sorted sum is on this path
    want = {"sorted_segment_sum_bias_relu": chunks, "sorted_segment_sum_act": chunks,
            "fused_bwd_gd": chunks, "sorted_segment_sum": chunks, "sorted_row_gather": 0}
    losses, total, ms, offsets = [], None, [], []
    grads0 = None

    def one(i):
        nonlocal grads0, total
        seg.reset_launch_counts()
        seg.csr_offsets.computed = 0
        m = step(batch_d)
        counts = seg.launch_counts()
        offsets.append(seg.csr_offsets.computed)
        check_step_launches(what, i, counts, want, hubs)
        total = {k: (total or {}).get(k, 0) + v for k, v in counts.items()}
        losses.append(m["loss"])
        if i == 0:
            grads0 = grads_of(model)

    for i in range(2):
        one(i)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    events = []
    with torch.profiler.profile(activities=activities) as prof:
        t_wall = time.perf_counter()
        for i in range(2, 12):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            one(i)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: the loss did not fall over 12 steps: {losses}")
    if any(offsets[1:]):
        fail(f"{what}: steps after the first computed CSR offsets again: {offsets}")
    t = time.perf_counter()
    loss_cpu, grads_cpu = cpu_step0(model_cpu, batch, plan, masked_cross_entropy)
    cpu_s = time.perf_counter() - t
    if abs(losses[0] - loss_cpu) > GRAD_TOL * max(1.0, abs(loss_cpu)):
        fail(f"{what}: step-0 loss {losses[0]} vs CPU {loss_cpu}")
    leaves, control = {}, None
    grad_err = check_grads(what, grads0, grads_cpu, scaled=hubs, leaves=leaves)
    if hubs:
        with dropped_hub_chunk() as dropped:
            loss_bad, grads_bad = cpu_step0(model_cpu, batch, plan, masked_cross_entropy)
        control = {"dropped": dropped, "loss": loss_bad,
                   "loss_caught": abs(loss_bad - loss_cpu) > GRAD_TOL * max(1.0, abs(loss_cpu)),
                   "leaves": grad_margins(grads_bad, grads_cpu, scaled=True)}
        caught = [k for k, m in control["leaves"].items() if m["margin"] > 1.0]
        if not caught and not control["loss_caught"]:
            fail(f"{what}: the gradient limit passes a step that dropped a hub chunk "
                 f"({control})")
        log(f"{what}: step-0 gradients against the CPU, each leaf's max abs err / atol "
            f"(margin): " + "; ".join(f"{k} {m['max_abs_err']:.3g} / {m['atol']:.3g} "
                                      f"({m['margin']:.3g})" for k, m in leaves.items()))
        log(f"{what}: control, {dropped}: loss {loss_bad} against {loss_cpu} (caught "
            f"{control['loss_caught']}); leaves past the limit {caught}: "
            + "; ".join(f"{k} {m['max_abs_err']:.3g} / {m['atol']:.3g} ({m['margin']:.3g})"
                        for k, m in control["leaves"].items()))
    ops = device_ops(prof, len(ms))
    busy = sum(o["device_ms_per_step"] for o in ops)
    prof_rec = {"device_ms_per_step": busy, "wall_ms_per_step": wall_ms / len(ms),
                "device_busy_share": busy * len(ms) / wall_ms, "ops": ops}
    rec = {"config": what.removeprefix("train "), "E": int(plan.num_edges[0]),
           "e_pad": plan.e_pad, "n_pad": plan.n_src_pad, "losses": losses, "step_ms": ms,
           "step_ms_p50": float(np.percentile(ms, 50)), "step_ms_p99": float(np.percentile(ms, 99)),
           "launches_per_step": want, "launches": total, "csr_offsets_per_step": offsets,
           "step0_loss_cpu": loss_cpu, "grad_max_abs_err": grad_err,
           "grad_tol_scaled_by_leaf": hubs, "grad_leaves": leaves,
           "grad_control": control, "hub_rows": _HUB_ROWS.get(what), "setup_s": setup_s,
           "cpu_reference_s": cpu_s, "profile": prof_rec}
    log(f"{what}: E={rec['E']} e_pad={plan.e_pad}; step ms p50 "
        f"{rec['step_ms_p50']:.3f} p99 {rec['step_ms_p99']:.3f}; device busy "
        f"{prof_rec['device_busy_share']:.1%} ({prof_rec['device_ms_per_step']:.3f} ms of "
        f"{prof_rec['wall_ms_per_step']:.3f} ms a step, profiler on); loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches per step {want}; step-0 grads vs CPU "
        f"max abs err {grad_err:.3g} (CPU step {cpu_s:.1f} s)")
    for o in prof_rec["ops"][:10]:
        log(f"  {o['device_ms_per_step']:9.4f} ms/step  x{o['count']:<4d} {o['name'][:80]}")
    del model, step, batch_d
    torch.cuda.empty_cache()
    return rec


def phase_train_ogb_gcn() -> dict:
    """experiments/ogb_gcn.py's GCN at arxiv width through ``python -m
    dgraph_tpu_torch.train``'s main: SBM graph (V=169,343, F=128, C=40,
    average degree 13.77), symmetric-norm edge weights, H=256, Adam 5e-3,
    with the sorted-row-gather kernel switched on. Launches checked every
    step; step 0's gradients against the CPU plain path."""
    import contextlib

    import numpy as np
    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.ops import segment as seg
    from dgraph_tpu_torch.train import __main__ as cli
    from dgraph_tpu_torch.train.profile import ogb_gcn_config
    from dgraph_tpu_torch.weights import init_params

    cfg = ogb_gcn_config()
    cfg.epochs, cfg.log_path = 4, os.path.join(OUT_DIR, "train_ogb_gcn.jsonl")
    chunks = cfg.num_layers * math.ceil(cfg.hidden / config.gather_col_block)
    # the composed backward's bias-row and cotangent-row takes (kernel 3),
    # its d_bias sum and the src-side take's VJP (kernel 2); the weighted op
    # never takes the pair (kernel 4, act)
    want = {"sorted_row_gather": 2 * chunks, "sorted_segment_sum": 2 * chunks,
            "sorted_segment_sum_act": 0, "fused_bwd_gd": 0}
    per_step, grads0 = [], {}

    def on_step(epoch, t):
        counts = seg.launch_counts()
        seg.reset_launch_counts()
        check_step_launches("train ogb_gcn", epoch, counts, want)
        # 4 fused forwards a train step, 4 more when the step ran an eval
        evals = int(epoch % 10 == 0 or epoch == cfg.epochs - 1)
        if counts["sorted_segment_sum_bias_relu"] != chunks * (1 + evals):
            fail(f"train ogb_gcn: step {epoch} fused forward launches {counts}")
        per_step.append(counts)
        if epoch == 0:
            grads0.update(grads_of(t.model))

    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(cfg.log_path):
        os.remove(cfg.log_path)
    config.use_pallas_gather = True
    try:
        seg.reset_launch_counts()
        t0 = time.perf_counter()
        # the CLI's JSON lines go to stderr: stdout keeps this script's two
        with contextlib.redirect_stdout(sys.stderr):
            res = cli.main(cfg, on_step=on_step)
        run_s = time.perf_counter() - t0
        t = res["training"]
        model_cpu = init_params(GCN(t.graph.features.shape[-1], cfg.hidden,
                                    cfg.data.num_classes, SingleComm(),
                                    num_layers=cfg.num_layers), seed=0)
        batch = dict(t.graph.batch("train"), y=t.graph.labels)
        tc = time.perf_counter()
        loss_cpu, grads_cpu = cpu_step0(model_cpu, batch, t.graph.plan, t.loss_fn)
        cpu_s = time.perf_counter() - tc
    finally:
        config.use_pallas_gather = None
    losses = [r["loss"] for r in res["records"]]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train ogb_gcn: non-finite loss {losses}")
    if abs(losses[0] - loss_cpu) > GRAD_TOL * max(1.0, abs(loss_cpu)):
        fail(f"train ogb_gcn: step-0 loss {losses[0]} vs CPU {loss_cpu}")
    grad_err = check_grads("train ogb_gcn", grads0, grads_cpu)
    ms = [r["wall_ms"] for r in res["records"]]
    launches = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    rec = {"config": "ogb_gcn", "E": t.graph.num_edges, "e_pad": t.graph.plan.e_pad,
           "losses": losses, "step_wall_ms": ms,
           "step_ms_p50_excl_first": float(np.percentile(ms[1:], 50)),
           "avg_epoch_ms_excl_first": res["avg_epoch_ms_excl_first"],
           "launches_per_step": want, "launches": launches, "step0_loss_cpu": loss_cpu,
           "grad_max_abs_err": grad_err, "run_s": run_s, "cpu_reference_s": cpu_s,
           "hub_rows": _HUB_ROWS.get("train ogb_gcn")}
    log(f"train ogb_gcn (gather kernel on): E={rec['E']}; step wall ms {ms}; loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches per step {want}; step-0 grads vs "
        f"CPU max abs err {grad_err:.3g} (CPU step {cpu_s:.1f} s)")
    del res, t
    torch.cuda.empty_cache()
    return rec


# --- phase 8 -----------------------------------------------------------------


ATTN_LEAVES = (".qkv.weight", ".attn_out.weight")


def attn_grad_rels(got: dict, want: dict) -> dict:
    """{block: relative Frobenius error} of the attention projections'
    weight gradients (every name ending in ATTN_LEAVES), the qkv weight's
    q, k and v row blocks each on its own, so that a fault in one of them
    (a dQ block unwritten) is not diluted by the other two; a whole
    matrix's relative error is never above its blocks' largest."""
    out = {}
    for name, w in want.items():
        if not name.endswith(ATTN_LEAVES):
            continue
        parts = ("q", "k", "v") if name.endswith(".qkv.weight") else ("",)
        for tag, g, w_ in zip(parts, got[name].float().chunk(len(parts)),
                              w.float().chunk(len(parts))):
            out[f"{name}{'[' + tag + ']' if tag else ''}"] = float((g - w_).norm() / w_.norm())
    return out


def attn_grad_rel(got: dict, want: dict) -> float:
    """The largest of :func:`attn_grad_rels`."""
    return max(attn_grad_rels(got, want).values())


# the backward kernels whose first block (rows [0, 128) of their outputs)
# phase 8's controls leave unwritten: dK/dV's first key block, the heaviest
# of its causal grid (numbered first), and dQ's first query block (numbered
# last), each of which a misnumbered grid would skip
SKIPPED_BLOCK_KERNELS = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def skipped_block_grads(cfg, tokens, kernel) -> dict:
    """Step-0 gradients of a fresh lm_flash model (the same seed) on
    ``tokens``, with ``kernel``'s first block left unwritten, its output
    rows [0, 128) zeroed: a control of phase 8's bf16 gradient check."""
    import torch

    from dgraph_tpu_torch.ops import attention as att
    from dgraph_tpu_torch.train import lm

    t = lm.build_lm(cfg)
    tok = t.next_batch()
    if not torch.equal(tok.cpu(), tokens):
        fail("train lm_flash: the control drew another first batch")
    real = getattr(att, kernel)

    def skip_block(*args, **kw):
        out = real(*args, **kw)
        out = tuple(x.clone() for x in out) if isinstance(out, tuple) else (out.clone(),)
        for x in out:
            x[:128] = 0
        return out if len(out) > 1 else out[0]

    skip_block.launches = 0  # the wrapper counts its launches on its module name
    setattr(att, kernel, skip_block)
    try:
        lm.lm_loss(t.model(tok, t.positions), tok).backward()
    finally:
        setattr(att, kernel, real)
    return grads_of(t.model)


def phase_train_lm_flash(dtype_name: str = "float32", f32_step0=None) -> tuple:
    """experiments/long_context_lm.py's LM at head width 128 (lm_flash:
    ``--seq_len 8192 --latent 512 --num_heads 4 --num_layers 2 --vocab 64
    --attn_impl ulysses --world_size 1``, Adam 3e-3, causal) through ``python
    -m dgraph_tpu_torch.train.lm``'s ``main``: 2 warm-up and 10 timed steps
    (host clock around each, the last 10 under torch.profiler); every step
    launches each attention kernel once a layer and no other kernel; the
    loss falls; an eval forward launches only the forward kernel, once a
    layer. In f32, step 0's loss and every gradient against the same model
    and batch on the CPU plain path. In bf16 (``config.default_compute_dtype``
    set as ``DGRAPH_TPU_COMPUTE_DTYPE=bfloat16`` sets it, and restored after)
    the matmuls and the attention kernels (the tensor-core forward and
    dK/dV) run in bf16; on the same weights and batch as the f32 run's,
    ``f32_step0`` = (loss, gradients), step 0's loss must be within
    BF16_LOSS_TOL and its attention projections' gradients within
    BF16_GRAD_TOL, which the first block left unwritten by dK/dV, and by
    dQ, must each exceed (``skipped_block_grads``, read in the same run).
    Returns (record, step 0's gradients)."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.train import lm
    from dgraph_tpu_torch.train.profile import device_ops, lm_flash_config

    cfg = dataclasses.replace(lm_flash_config(), steps=12, log_every=1,
                              log_path=os.path.join(OUT_DIR, f"train_lm_flash_{dtype_name}.jsonl"))
    L = cfg.num_layers
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(flash_attention_fwd=L, flash_attention_bwd_dkv=L, flash_attention_bwd_dq=L)
    per_step, grads0, tokens0 = [], {}, []
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(i, t, tokens):
        counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        check_step_launches("train lm_flash", i, counts, want)
        per_step.append(counts)
        if i == 0:
            grads0.update(grads_of(t.model))
            tokens0.append(tokens.cpu())
        if i == 1:
            prof.start()  # steps 2-11

    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(cfg.log_path):
        os.remove(cfg.log_path)
    kernels.reset_launch_counts()
    saved_dtype = config.default_compute_dtype
    config.default_compute_dtype = dtype_name
    try:
        t0 = time.perf_counter()
        # the CLI's JSON lines go to stderr: stdout keeps this script's two
        with contextlib.redirect_stdout(sys.stderr):
            res = lm.main(cfg, on_step=on_step)
        torch.cuda.synchronize()
        prof.stop()
        run_s = time.perf_counter() - t0
        t = res["training"]
        launches = {k: sum(c[k] for c in per_step) for k in want}

        kernels.reset_launch_counts()
        te = time.perf_counter()
        eval_loss = float(t.eval_step(t.next_batch()))
        eval_ms = (time.perf_counter() - te) * 1e3
        eval_counts = kernels.launch_counts()
        del t, res["training"]
        torch.cuda.empty_cache()
        controls = {} if f32_step0 is None else {
            k: skipped_block_grads(cfg, tokens0[0], k) for k in SKIPPED_BLOCK_KERNELS}
    finally:
        config.default_compute_dtype = saved_dtype
    want_eval = dict.fromkeys(want, 0)
    want_eval["flash_attention_fwd"] = L
    check_step_launches(f"train lm_flash {dtype_name}", "eval", eval_counts, want_eval)
    if not math.isfinite(eval_loss):
        fail(f"train lm_flash {dtype_name}: an eval forward's loss is {eval_loss}")

    losses = [r["loss"] for r in res["records"]]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train lm_flash {dtype_name}: the loss did not fall over 12 steps: {losses}")

    loss_cpu = grad_err = cpu_s = grad_rel = None
    grad_rel_controls = {}
    if dtype_name == "float32":
        tc = time.perf_counter()
        cpu = lm.build_lm(cfg, device="cpu")
        tok = cpu.next_batch()
        if not torch.equal(tok, tokens0[0]):
            fail("train lm_flash: the CPU reference drew another first batch")
        loss_cpu = lm.lm_loss(cpu.model(tok, cpu.positions), tok)
        loss_cpu.backward()
        loss_cpu = float(loss_cpu.detach())
        cpu_s = time.perf_counter() - tc
        if abs(losses[0] - loss_cpu) > GRAD_TOL * max(1.0, abs(loss_cpu)):
            fail(f"train lm_flash: step-0 loss {losses[0]} vs CPU {loss_cpu}")
        grad_err = check_grads("train lm_flash", grads0, grads_of(cpu.model))
        del cpu
    else:
        f32_step0_loss, f32_grads = f32_step0
        grad_rel = attn_grad_rel(grads0, f32_grads)
        grad_rel_controls = {k: attn_grad_rel(g, f32_grads) for k, g in controls.items()}
        log(f"train lm_flash {dtype_name}: step-0 attention weight gradients vs the f32 "
            f"run's: {grad_rel:.3g} relative; with a kernel's first block unwritten "
            f"{ {k: round(r, 4) for k, r in grad_rel_controls.items()} } (limit "
            f"{BF16_GRAD_TOL})")
        if abs(losses[0] - f32_step0_loss) > BF16_LOSS_TOL * abs(f32_step0_loss):
            fail(f"train lm_flash {dtype_name}: step-0 loss {losses[0]} vs the f32 run's "
                 f"{f32_step0_loss} (relative tolerance {BF16_LOSS_TOL})")
        if not grad_rel <= BF16_GRAD_TOL:
            fail(f"train lm_flash {dtype_name}: step-0 attention gradients {grad_rel:.3g} "
                 f"relative from the f32 run's (limit {BF16_GRAD_TOL})")
        for k, r in grad_rel_controls.items():
            if not r > BF16_GRAD_TOL:
                fail(f"train lm_flash {dtype_name}: {k} with its first block unwritten reads "
                     f"{r:.3g}, inside the gradient limit {BF16_GRAD_TOL}: the check has no "
                     "force")

    ms = res["step_ms"][2:]
    ops = device_ops(prof, len(ms))
    busy = sum(o["device_ms_per_step"] for o in ops)
    wall = sum(ms) / len(ms)
    rec = {"config": "lm_flash", "dtype": dtype_name, "T": cfg.seq_len, "latent": cfg.latent,
           "heads": cfg.num_heads, "layers": L, "losses": losses, "step_ms_all": res["step_ms"],
           "step_ms": ms,
           "step_ms_p50": float(np.percentile(ms, 50)), "step_ms_p99": float(np.percentile(ms, 99)),
           "launches_per_step": want, "launches": launches, "eval_launches": eval_counts,
           "eval_ms": eval_ms, "step0_loss_cpu": loss_cpu, "grad_max_abs_err": grad_err,
           "step0_loss_f32": f32_step0 and f32_step0[0], "attn_grad_rel_err": grad_rel,
           "attn_grad_rel_err_controls": grad_rel_controls,
           "attn_grad_rel_err_by_block": None if grad_rel is None else {
               "sound": attn_grad_rels(grads0, f32_step0[1]),
               **{k: attn_grad_rels(g, f32_step0[1]) for k, g in controls.items()}},
           "run_s": run_s, "cpu_reference_s": cpu_s,
           "profile": {"device_ms_per_step": busy, "wall_ms_per_step": wall,
                       "device_busy_share": busy / wall, "ops": ops}}
    check = (f"step-0 grads vs CPU max abs err {grad_err:.3g} (CPU step {cpu_s:.1f} s)"
             if dtype_name == "float32" else
             f"step-0 loss vs the f32 run's {f32_step0[0]:.5f}: "
             f"{abs(losses[0] / f32_step0[0] - 1):.3g} relative")
    log(f"train lm_flash {dtype_name}: T={cfg.seq_len} L={cfg.latent} H={cfg.num_heads} "
        f"layers={L}; step ms p50 {rec['step_ms_p50']:.3f} p99 {rec['step_ms_p99']:.3f} (steps "
        f"2-11, host clock, profiler on); device busy {busy / wall:.1%} ({busy:.3f} of "
        f"{wall:.3f} ms a step); loss {losses[0]:.5f} -> {losses[-1]:.5f}; eval forward "
        f"{eval_ms:.2f} ms; {check}")
    for o in ops[:10]:
        log(f"  {o['device_ms_per_step']:9.4f} ms/step  x{o['count']:<4d} {o['name'][:80]}")
    torch.cuda.empty_cache()
    return rec, grads0


# --- phase 9 -----------------------------------------------------------------

P2P_W = 4
P2P_F = 256
P2P_EDGE_S = 300
P2P_REPS = 10


# the W = 4 plan phase 9 builds, kept for phase 13's parity (one build a
# run), and phase 9's CPU oracle of the W = 4 GCN step 0, which phase 13's
# GCN run is held to as well
_W4_HALO: dict = {}
_W4_GCN_CPU: dict = {}


def w4_halo_arrays(plan) -> dict:
    """What a rank needs of the W = 4 plan to run the halo lowerings: the
    send lists (every rank's), S, the live deltas, n_pad and the compiled
    halo schedule."""
    return {"deltas": tuple(plan.halo_deltas), "S": plan.halo.s_pad, "n_pad": plan.n_src_pad,
            "send_idx": plan.halo.send_idx.numpy(), "send_mask": plan.halo.send_mask.numpy(),
            "schedule": plan.halo_schedule}


def p2p_edge_cases(W: int) -> list:
    """(deltas, F, dtype, sign, masked, element offset of the blocks) of
    the kernel-5 edge cases at world size W. W = 4, deltas {1, 3} (fewer
    tiles than peers): every F in {1, 33, 256} and both types, with and
    without a mask, in the forward direction; the reverse direction, and
    blocks one element off (rows start unaligned: the scalar path), at
    F = 256; uint8 byte tiles (no mask) of fp8 rows F + 4 = 260 (a tile's
    run of S*260 bytes 16-byte aligned: the vector path) and 37 (unaligned:
    a byte a thread), both directions, and 260 one byte off. W = 2, delta
    {1}: F = 256, both types, both directions, masked; uint8 at 260, both
    directions. 24 and 6 cases."""
    if W == 2:
        return ([((1,), 256, dt, sign, True, 0)
                 for dt in ("float32", "bfloat16") for sign in (1, -1)]
                + [((1,), 260, "uint8", sign, False, 0) for sign in (1, -1)])
    dts = ("float32", "bfloat16")
    return ([((1, 3), F, dt, 1, masked, 0)
             for F in (1, 33, 256) for dt in dts for masked in (True, False)]
            + [((1, 3), 256, dt, -1, masked, 0) for dt in dts for masked in (True, False)]
            + [((1, 3), 256, dt, 1, True, 1) for dt in dts]
            + [((1, 3), Fw, "uint8", sign, False, 0) for Fw in (260, 37) for sign in (1, -1)]
            + [((1, 3), 260, "uint8", 1, False, 1)])


def p2p_case_name(dtype_name, sign, masked, W, S, F) -> str:
    """The name of a kernel-5 record at the real shape (phase 9), which the
    kernels line finds it by."""
    return (f"p2p_transport {dtype_name} sign={sign:+d} {'mask' if masked else 'no mask'} "
            f"W={W} S={S} F={F}")


def p2p_mutant_cases(W: int) -> list:
    """(mutation, F, dtype, sign, element offset) of kernel 6's seeded-fault
    checks at world size W, each at the deltas whose landings no two
    senders share (``analysis.kernel.disjoint_deltas``: where two senders
    write one row the card's outcome is a race). W = 4: F in {33, 256},
    both types, both directions, masked, and blocks one element off at
    F = 256; W = 2: F = 256, both types, both directions. 20 and 8 cases."""
    dts = ("float32", "bfloat16")
    Fs = (33, 256) if W == 4 else (256,)
    return [(m, F, dt, sign, 0) for m in ("bad_dst_row", "oversize") for F in Fs
            for dt in dts for sign in (1, -1)] + (
        [(m, 256, dt, 1, 1) for m in ("bad_dst_row", "oversize") for dt in dts] if W == 4 else [])


def p2p_landing_cases(W: int) -> tuple:
    """The landing check's cases on the card: each transport variant (kernel
    5, kernel 6 clean and its two faults), both directions, every peer a
    live source, f32 at S = P2P_EDGE_S and F = P2P_F, bf16 at S = 8 and
    F = 16 (its tiles' row codes stay exact and distinct)."""
    import torch

    from dgraph_tpu_torch.analysis.kernel import LANDING_VARIANTS

    return tuple(dict(kernel=k, mutation=m, S=S, F=F, dtype=dt, sign=sign)
                 for k, m in LANDING_VARIANTS
                 for dt, S, F in ((torch.float32, P2P_EDGE_S, P2P_F), (torch.bfloat16, 8, 16))
                 for sign in (1, -1))


def p2p_work(n, S, F, b, masked) -> tuple:
    """(bytes, ops) of one launch: each tile element read once and written
    once (into a peer's rows), 4 bytes of mask a row; one multiply an
    element when masked."""
    return 2 * n * S * F * b + (4 * n * S if masked else 0), (n * S * F if masked else 0)


def p2p_check(failures, name, run, plain, k5=None) -> float:
    """Bit-equal to the plain version (and to kernel 5's output ``k5()``
    when given), and two launches equal (each fault appended to
    ``failures``); the max abs error against the plain version (NaN where
    the data holds NaN)."""
    import torch

    got, want, again = run(), plain(), run()
    torch.cuda.synchronize()
    for what, ref in [("plain", want)] + ([("kernel 5", k5())] if k5 else []):
        if not torch.equal(bits(got), bits(ref)):
            failures.append(f"{name}: kernel != {what} in "
                            f"{int((bits(got) != bits(ref)).sum())} elements")
    if not torch.equal(bits(got), bits(again)):
        failures.append(f"{name}: two launches differ")
    return max_err(got, want)


def in_turn(group, fn):
    """ms of ``fn`` on each rank while the others wait (this rank's)."""
    out = None
    for r in range(group.world_size):
        group.barrier()
        if r == group.rank:
            out = time_ms(fn, reps=P2P_REPS)
    group.barrier()
    return out


def host_ms(group, fn, reps):
    """Host ms a call of ``fn`` over ``reps`` calls, all ranks together,
    after one call and a barrier."""
    import torch

    fn()
    torch.cuda.synchronize(group.device)
    group.barrier()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(group.device)
    return (time.perf_counter() - t) * 1e3 / reps


def p2p_real_case(group, gen, real, F, dtype_name, sign, failures, tag="") -> tuple:
    """Kernel 5 at a plan's real shape (``real``: :func:`w4_halo_arrays`)
    and width ``F``: the exchange (``sign`` +1: this rank's send rows of a
    random ``[n_pad, F]`` table, masked in flight; uint8: the fp8 wire
    tiles of those rows, masked before encoding, moved with no mask) or the
    reverse leg (-1: random halo rows back to their owners). Bit-equal to
    the plain version, two launches equal; the kernel's own time (CUDA
    events, the ranks in turn, the others idle), the exchange's wall time
    from barrier to barrier (all ranks together), the plain version's, and
    the yardstick's: the per-tile ``torch.mul``/``copy_`` into the mapped
    peer rows on one card, NCCL ``all_to_all_single`` where each rank has
    its card. Returns (the record, named by :func:`p2p_case_name` and
    ``tag``; the call's operands, for kernel 6 at the same shape)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dgraph_tpu_torch.ops import p2p
    from dgraph_tpu_torch.wire.codec import make_wire_transform

    dev, W, me = group.device, group.world_size, group.rank
    deltas, S, n = real["deltas"], real["S"], len(real["deltas"])
    dtype = getattr(torch, dtype_name)
    rows = [(me + sign * d) % W for d in deltas]
    if sign == 1:  # the exchange: send rows, masked in flight
        idx = torch.from_numpy(real["send_idx"][me]).to(dev).long()
        smask = torch.from_numpy(real["send_mask"][me]).to(dev)
        x = torch.randn(real["n_pad"], F, generator=gen, device=dev)
        blocks = x[idx[rows].reshape(-1)].view(n, S, F)
        mask = smask[rows].contiguous()
        if dtype_name == "uint8":
            fp8_encode = make_wire_transform("fp8", torch.float32)[0]
            blocks, mask = fp8_encode(blocks * mask[..., None]), None
        else:
            blocks = blocks.to(dtype)
    else:  # the reverse leg: halo rows back to their owners
        h = torch.randn(n, S, F, generator=gen, device=dev)
        mask = None
        blocks = (make_wire_transform("fp8", torch.float32)[0](h) if dtype_name == "uint8"
                  else h.to(dtype))
    Fw = blocks.shape[2]
    kw = dict(sign=sign, mask=mask, group=group)
    name = p2p_case_name(dtype_name, sign, mask is not None, W, S, Fw) + tag
    run = lambda: p2p.p2p_transport(blocks, deltas, W, S, **kw)  # noqa: E731
    plain = lambda: p2p.p2p_transport_plain(blocks, deltas, W, S, **kw)  # noqa: E731
    err = p2p_check(failures, name, run, plain)
    land = p2p.landing_buffer(group, W * S, Fw, dtype, sign)
    kernel = lambda: p2p.launch_puts(blocks, deltas, W, S, sign, mask, group, land)  # noqa: E731
    views = [land.peers[(me + sign * d) % W][me * S:(me + 1) * S] for d in deltas]
    if group.backend == "nccl":
        stack = p2p.send_stack(blocks, deltas, W, sign, me, mask)
        recv = torch.empty_like(stack)
        library = "NCCL all_to_all_single of the masked [W, S, F] stack"
        lib_ms = host_ms(group, lambda: dist.all_to_all_single(recv, stack, group=group.pg),
                         P2P_REPS)
    else:
        library = ("per-tile torch.mul(out=) into the mapped peer rows" if mask is not None
                   else "per-tile copy_ into the mapped peer rows")

        def lib_call():
            for k, v in enumerate(views):
                if mask is None:
                    v.copy_(blocks[k])
                else:
                    torch.mul(blocks[k], mask[k, :, None].to(dtype), out=v)
        lib_ms = in_turn(group, lib_call)
    nbytes, ops = p2p_work(n, S, Fw, blocks.element_size(), mask is not None)
    b_ms, b_by = bound(nbytes, ops, "float32" if dtype_name == "uint8" else dtype_name)
    rec = {
        "kernel": "p2p_transport", "case": name, "dtype": dtype_name, "sign": sign,
        "masked": mask is not None, "n": n, "S": S, "F": Fw, "W": W,
        "max_abs_err": err,
        "ms": in_turn(group, kernel), "wall_ms": host_ms(group, run, P2P_REPS),
        "plain_ms": host_ms(group, plain, 2), "library_ms": lib_ms, "library": library,
        "bound_ms": b_ms, "bound_by": b_by, "backend": group.backend,
        "rows_live": int(np.asarray(real["send_mask"][me])[rows].sum()),
    }
    return rec, dict(blocks=blocks, mask=mask, kw=kw, land=land, run=run, name=name)


def p2p_parity_rank(group, edge_cases, mutant_cases, landing_cases, real):
    """One rank of the kernel-5 and kernel-6 checks (run under
    ``comm.dist.launch``): every case bit-equal to the plain version, two
    launches equal, kernel 6 ``None`` also bit-equal to kernel 5, each of
    kernel 6's faults bit-equal to its plain version; then kernel 6's path,
    the verifier's landing check (``analysis.kernel.audit_landing``) with
    the launch counts zeroed before and read after; at the real shape
    (``real``: the W = 4 plan's send lists, F = 256) kernel 5's checks and
    times (:func:`p2p_real_case`) in f32, bf16 and on uint8 fp8 tiles, both
    legs, and kernel 6 ``None`` on the f32 and bf16 exchange."""
    import torch

    from dgraph_tpu_torch.analysis.kernel import audit_landing, disjoint_deltas
    from dgraph_tpu_torch.ops import kernels, p2p

    dev, W = group.device, group.world_size
    gen = torch.Generator(device=dev).manual_seed(100 + group.rank)
    failures, records = [], []
    t0 = time.perf_counter()

    def check(name, run, plain, k5=None) -> float:
        return p2p_check(failures, name, run, plain, k5)

    def tiles(n, S, F, dtype_name, off, masked):
        """Blocks with negative values, NaN and -inf (a masked row must
        come out as x * 0: -0.0, NaN, as in the plain version, where a
        select gives +0.0) and a mask or None; uint8 tiles every byte
        value."""
        if dtype_name == "uint8":
            raw = torch.randint(0, 256, (n * S * F + off,), generator=gen, device=dev,
                                dtype=torch.uint8)
            return raw[off:].view(n, S, F), None
        raw = torch.randn(n * S * F + off, generator=gen, device=dev)
        raw[::7], raw[3::11] = float("nan"), float("-inf")
        raw = raw.to(getattr(torch, dtype_name))
        mask = (torch.rand(n, S, generator=gen, device=dev) > 0.3).float() if masked else None
        return raw[off:].view(n, S, F), mask

    for deltas, F, dtype_name, sign, masked, off in edge_cases:
        n, S = len(deltas), P2P_EDGE_S
        blocks, mask = tiles(n, S, F, dtype_name, off, masked)
        kw = dict(sign=sign, mask=mask, group=group)
        case = (f"W={W} deltas={deltas} F={F} {dtype_name} sign={sign} mask={masked} "
                f"offset={off}")
        k5 = lambda: p2p.p2p_transport(blocks, deltas, W, S, **kw)  # noqa: E731
        check(f"p2p edge {case}", k5, lambda: p2p.p2p_transport_plain(blocks, deltas, W, S, **kw))
        if dtype_name == "uint8":  # kernel 6 stays f32 and bf16; a mask is refused
            try:
                p2p.p2p_transport(blocks, deltas, W, S, sign=sign, group=group,
                                  mask=torch.ones(blocks.shape[:2], device=dev))
                failures.append(f"p2p edge {case}: a mask with uint8 tiles did not raise")
            except ValueError:
                pass
            continue
        check(f"p2p mutant None edge {case}",
              lambda: p2p.p2p_transport_mutant(blocks, deltas, W, S, **kw),
              lambda: p2p.p2p_transport_mutant_plain(blocks, deltas, W, S, **kw), k5)
    for mutation, F, dtype_name, sign, off in mutant_cases:
        deltas, S = disjoint_deltas(W, mutation), P2P_EDGE_S
        blocks, mask = tiles(len(deltas), S, F, dtype_name, off, True)
        kw = dict(sign=sign, mask=mask, group=group, mutation=mutation)
        check(f"p2p mutant {mutation} W={W} deltas={deltas} F={F} {dtype_name} sign={sign} "
              f"offset={off}", lambda: p2p.p2p_transport_mutant(blocks, deltas, W, S, **kw),
              lambda: p2p.p2p_transport_mutant_plain(blocks, deltas, W, S, **kw))
    edge_s = time.perf_counter() - t0
    # kernel 6's path: the verifier's landing check, counted
    t1 = time.perf_counter()
    torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    landing = [audit_landing(group, **case) for case in landing_cases]
    torch.cuda.synchronize(dev)
    landing_counts = kernels.launch_counts()
    landing_s = time.perf_counter() - t1
    if real is not None:
        deltas, S = real["deltas"], real["S"]
        for dtype_name in ("float32", "bfloat16", "uint8"):
            for sign in (1, -1):
                rec, c = p2p_real_case(group, gen, real, P2P_F, dtype_name, sign, failures)
                records.append(rec)
                if sign != 1 or dtype_name == "uint8":
                    continue
                # kernel 6 None at the same shape: bit-equal to kernel 5 and to
                # its plain version; the same bytes, so the same bound and the
                # same yardstick (measured above on these inputs)
                blocks, mask, kw = c["blocks"], c["mask"], c["kw"]
                run6 = lambda: p2p.p2p_transport_mutant(blocks, deltas, W, S, **kw)  # noqa: E731
                plain6 = lambda: p2p.p2p_transport_mutant_plain(  # noqa: E731
                    blocks, deltas, W, S, **kw)
                err6 = check(c["name"].replace("p2p_transport", "p2p_transport_mutant None"),
                             run6, plain6, c["run"])
                kernel6 = lambda: p2p.launch_mutant_puts(  # noqa: E731
                    blocks, deltas, W, S, sign, mask, group, c["land"], None)
                records.append(dict(
                    rec, kernel="p2p_transport_mutant",
                    case=c["name"].replace("p2p_transport", "p2p_transport_mutant"),
                    max_abs_err=err6, ms=in_turn(group, kernel6),
                    wall_ms=host_ms(group, run6, P2P_REPS), plain_ms=host_ms(group, plain6, 1)))
    return {"failures": failures, "records": records,
            "cases": len(edge_cases) + len(mutant_cases), "landing": landing,
            "landing_counts": landing_counts, "landing_s": landing_s, "edge_s": edge_s,
            "real_s": time.perf_counter() - t0 - edge_s - landing_s}


def partition_record(graph) -> dict:
    """What a W = 4 graph's partition gives the exchange, as one rank built
    it: the partition's host seconds and a digest of it (every rank builds
    its own and they must agree), whether the native host library loaded
    in this process (a multilevel partition without it is greedy BFS), the
    edge cut, the vertices each rank owns, S, the live deltas, the bytes an
    exchange puts at F = P2P_F in f32 (every live delta's [S, F] tile), and
    the interior and boundary edges of each rank's split."""
    import hashlib

    import numpy as np

    from dgraph_tpu_torch import native
    from dgraph_tpu_torch import partition as pt

    plan, ren = graph.plan, graph.ren
    return {
        "partition_s": graph.partition_s,
        "digest": hashlib.sha256(np.ascontiguousarray(ren.partition).tobytes()
                                 + np.ascontiguousarray(ren.perm).tobytes()).hexdigest()[:16],
        "native": native.available(), "native_error": native.build_error,
        "edge_cut": pt.edge_cut(graph.edge_index, ren.partition),
        "owned": ren.counts.tolist(), "S": plan.halo.s_pad, "deltas": list(plan.halo_deltas),
        "exchange_bytes": len(plan.halo_deltas) * plan.halo.s_pad * P2P_F * 4,
        "interior": plan.overlap.num_interior.tolist(),
        "boundary": plan.overlap.num_boundary.tolist(),
    }


class Phase9Probe:
    """``on_step`` of the W = 4 training run, in each rank's process: each
    step's kernel launches and the host ms its exchanges took barrier to
    barrier (then zeroed), step 0's gradients and the hub rows of the
    rank's cached segment plans (:func:`cached_hub_rows`), the last step's
    parameters, and a profile of steps 2-11 (device busy share)."""

    def __init__(self, epochs: int):
        self.epochs = epochs
        self.prof = None

    def __call__(self, epoch, t):
        import torch
        from torch.profiler import ProfilerActivity

        from dgraph_tpu_torch.ops import kernels, p2p
        from dgraph_tpu_torch.train.profile import device_ops

        out = {"counts": kernels.launch_counts(), "exchange_ms": p2p.p2p_transport.wall_s * 1e3}
        kernels.reset_launch_counts()
        p2p.p2p_transport.wall_s = 0.0
        if epoch == 0:
            out["grads"] = {k: v.numpy() for k, v in grads_of(t.model).items()}
            out["partition"] = partition_record(t.graph)
            out["hub_rows"] = cached_hub_rows()
        if epoch == 1:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        if epoch == self.epochs - 1:
            torch.cuda.synchronize()
            self.prof.stop()
            out["ops"] = device_ops(self.prof, self.epochs - 2)
            out["params"] = {k: v.detach().cpu().numpy() for k, v in t.model.state_dict().items()}
        return out


def cpu_step0_rank(group, cfg: dict):
    """Step 0's global loss and summed gradients of one rank on the CPU
    plain path (the oracle of the card run's step 0)."""
    from dgraph_tpu_torch.comm import DistComm
    from dgraph_tpu_torch.comm.collectives import all_reduce_sum
    from dgraph_tpu_torch.train import __main__ as cli
    from dgraph_tpu_torch.train.loop import model_apply

    from dgraph_tpu_torch import config

    # the p2p route's plain version (the transport through all_to_all)
    config.use_pallas_p2p, config.halo_impl = True, "pallas_p2p"
    c = cli.Config(**dict(cfg, data=cli.DataConfig(**cfg["data"]), device="cpu"))
    t = cli.build_training(c, comm=DistComm(group))
    if not t.comm.split_active(t.plan):
        raise RuntimeError("the CPU reference does not take the p2p split route")
    b = {k: v[group.rank] for k, v in t.batches["train"].items()}
    count = all_reduce_sum(b["mask"].sum(), group)
    loss = t.loss_fn(model_apply(t.model, b, t.plan), b["y"], b["mask"], count=count)
    loss.backward()
    t.comm.grad_sync(list(t.model.parameters()))
    return {"loss": float(all_reduce_sum(loss.detach(), group)),
            "grads": {k: v.numpy() for k, v in grads_of(t.model).items()}}


def merged_p2p_record(per_rank: list) -> dict:
    """One real-shape kernel-5 (or kernel-6) record from every rank's: the
    times averaged over the ranks (each rank's kept), the largest error;
    logged."""
    import numpy as np

    rec = dict(per_rank[0], ms_per_rank=[r["ms"] for r in per_rank],
               wall_ms_per_rank=[r["wall_ms"] for r in per_rank],
               ms=float(np.mean([r["ms"] for r in per_rank])),
               wall_ms=float(np.mean([r["wall_ms"] for r in per_rank])),
               plain_ms=float(np.mean([r["plain_ms"] for r in per_rank])),
               library_ms=float(np.mean([r["library_ms"] for r in per_rank])),
               max_abs_err=max(r["max_abs_err"] for r in per_rank))
    log(f"{rec['case']}: err {rec['max_abs_err']} kernel {rec['ms']:.4f} ms (ranks in turn; "
        f"per rank {[round(v, 4) for v in rec['ms_per_rank']]}) exchange wall "
        f"{rec['wall_ms']:.3f} ms (barrier to barrier) plain {rec['plain_ms']:.3f} ms "
        f"{rec['library']} {rec['library_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}) [{rec['backend']}]")
    return rec


def phase_p2p_kernel(graph) -> dict:
    """Kernels 5 and 6 against their plain versions on the card: the real
    W = 4 plan's send lists at F = 256 (f32 and bf16, the exchange with its
    mask and the reverse leg without; kernel 6 ``None`` on the exchange),
    the edge cases and kernel 6's seeded faults, then the landing check
    (kernel 6's path, its launches counted), at W = 4 and W = 2 (four and
    two ranks sharing the card, or a card each); the verifier's static
    selftest first."""
    from dgraph_tpu_torch.comm.dist import launch

    from dgraph_tpu_torch.analysis.kernel import check_landing, kernel_selftest_failures

    failures = kernel_selftest_failures()
    if failures:
        fail(f"the put-discipline verifier's static selftest: {failures[:5]}")
    log("kernel 6 verifier, static tier: the clean protocol GREEN, drop_send_wait, "
        "drop_recv_wait, no_slot_wait, bad_dst_row and oversize each RED on its own rule")
    real = w4_halo_arrays(graph.plan)
    out, landing = {}, {}
    for W in (P2P_W, 2):
        t0 = time.perf_counter()
        res = launch(p2p_parity_rank, W, p2p_edge_cases(W), p2p_mutant_cases(W),
                     p2p_landing_cases(W), real if W == P2P_W else None,
                     device="cuda", timeout=600)
        failures = [f for r in res for f in r["failures"]]
        if failures:
            fail(f"kernels 5 and 6: {len(failures)} failures: {failures[:5]}")
        rules = check_landing([r["landing"] for r in res], failures)
        if failures:
            fail(f"the landing check on the card: {failures[:5]}")
        launches = {k: sum(r["landing_counts"][k] for r in res)
                    for k in ("p2p_transport", "p2p_transport_mutant")}
        landing[W] = {"rules": rules, "launches": launches, "cases": len(res[0]["landing"])}
        log(f"p2p_transport and p2p_transport_mutant W={W}: {res[0]['cases']} edge and "
            f"seeded-fault cases bit-equal to plain on every rank, two launches equal; landing "
            f"check ({landing[W]['cases']} cases a rank): {rules}, launches {launches} "
            f"({time.perf_counter() - t0:.1f} s with the spawn; rank 0: edge cases "
            f"{res[0]['edge_s']:.1f} s, landing check {res[0]['landing_s']:.1f} s, the real "
            f"shape's checks and times {res[0]['real_s']:.1f} s)")
        out[W] = res
    recs = [merged_p2p_record([r["records"][i] for r in out[P2P_W]])
            for i in range(len(out[P2P_W][0]["records"]))]
    return {"records": recs, "edge_cases": {W: out[W][0]["cases"] for W in out},
            "landing": landing,
            "landing_launches": {"p2p_transport_mutant": sum(
                landing[W]["launches"]["p2p_transport_mutant"] for W in landing)}}


@contextlib.contextmanager
def halo_impl_env(impl: str):
    """DGRAPH_TPU_HALO_IMPL=``impl`` for the ranks spawned inside (each
    reads it at start-up)."""
    saved = os.environ.get("DGRAPH_TPU_HALO_IMPL")
    os.environ["DGRAPH_TPU_HALO_IMPL"] = impl
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("DGRAPH_TPU_HALO_IMPL")
        else:
            os.environ["DGRAPH_TPU_HALO_IMPL"] = saved


def train_w4_run(partition: str) -> tuple:
    """experiments/ogb_gcn.py's GCN at arxiv width over 4 ranks through
    ``python -m dgraph_tpu_torch.train``'s main with
    DGRAPH_TPU_HALO_IMPL=pallas_p2p (dst-owned, the interior/boundary split)
    under ``partition``: 2 warm-up and 10 timed steps. Every rank's every
    step launches kernel 5 four times (two exchanges, two reverse legs) and
    kernel 1 eight times (2 layers x 2 chunks x 2 subsets), plus 2 and 8
    when the step ran an eval; the loss falls; the ranks' parameters are
    bit-equal after the last step; every rank built the same partition
    (digest) with the native host library loaded. Returns (the Config, the
    record, each rank's step-0 gradients)."""

    import numpy as np

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops.kernels import KERNELS
    from dgraph_tpu_torch.train import __main__ as cli
    from dgraph_tpu_torch.train.profile import ogb_gcn_config

    what = f"train ogb_gcn W=4 {partition}"
    cfg = ogb_gcn_config(world_size=P2P_W, partition=partition)
    cfg.epochs = 12
    cfg.log_path = os.path.join(OUT_DIR, f"train_ogb_gcn_w4_{partition}.jsonl")
    chunks = cfg.num_layers * math.ceil(cfg.hidden / config.gather_col_block)
    want = dict.fromkeys(KERNELS, 0)
    want.update(p2p_transport=2 * cfg.num_layers, sorted_segment_sum_bias_relu=2 * chunks,
                sorted_segment_sum=2 * chunks)
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(cfg.log_path):
        os.remove(cfg.log_path)
    t0 = time.perf_counter()
    with halo_impl_env("pallas_p2p"), contextlib.redirect_stdout(sys.stderr):
        res = cli.main(cfg, on_step=Phase9Probe(cfg.epochs))
    run_s = time.perf_counter() - t0
    ranks = res["ranks"]
    parts = [rank["on_step"][0]["partition"] for rank in ranks]
    if any(not p["native"] for p in parts):
        fail(f"{what}: the native host library did not load in every rank: "
             f"{[p['native_error'] for p in parts]}")
    if len({p["digest"] for p in parts}) != 1:
        fail(f"{what}: the ranks built different partitions: {[p['digest'] for p in parts]}")
    for r, rank in enumerate(ranks):
        for i, probe in enumerate(rank["on_step"]):
            evals = int(i % 10 == 0 or i == cfg.epochs - 1)
            step_want = dict(want, p2p_transport=want["p2p_transport"] + cfg.num_layers * evals,
                             sorted_segment_sum_bias_relu=want["sorted_segment_sum_bias_relu"]
                             + 2 * chunks * evals)
            check_step_launches(f"{what} rank {r}", i, probe["counts"], step_want,
                                hub_rows=rank["on_step"][0]["hub_rows"])
    losses = [rec["loss"] for rec in res["records"]]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: the loss did not fall over {cfg.epochs} steps: {losses}")
    last = [rank["on_step"][-1]["params"] for rank in ranks]
    for r in range(1, P2P_W):
        for k, v in last[0].items():
            if not np.array_equal(last[r][k], v):
                fail(f"{what}: rank {r}'s {k} differs from rank 0's after the last step")
    launches = {k: sum(p["counts"][k] for rank in ranks for p in rank["on_step"])
                for k in ranks[0]["on_step"][0]["counts"]}
    part = dict(parts[0], partition_s=[p["partition_s"] for p in parts])
    log(f"{what}: partition {max(part['partition_s']):.2f} s a rank (host, every rank its "
        f"own, digests equal, native library loaded in every rank); edge cut "
        f"{part['edge_cut']:.4f}; owned per rank {part['owned']}; S={part['S']} live deltas "
        f"{part['deltas']}: {part['exchange_bytes'] / 1e6:.1f} MB an exchange a rank at "
        f"F={P2P_F} f32; interior/boundary edges per rank {part['interior']}/{part['boundary']}")
    per_rank = []
    for r, rank in enumerate(ranks):
        ms = [rec["wall_ms"] for rec in rank["records"]][2:]
        ex = [p["exchange_ms"] for p in rank["on_step"]][2:]
        ops = rank["on_step"][-1]["ops"]
        busy = sum(o["device_ms_per_step"] for o in ops)
        per_rank.append({"rank": r, "step_ms": ms, "step_ms_p50": float(np.percentile(ms, 50)),
                         "step_ms_p99": float(np.percentile(ms, 99)),
                         "exchange_ms": ex, "exchange_ms_p50": float(np.percentile(ex, 50)),
                         "device_ms_per_step": busy,
                         "device_busy_share": busy / float(np.mean(ms)), "ops": ops})
        log(f"{what} rank {r}: step ms p50 {per_rank[-1]['step_ms_p50']:.3f} p99 "
            f"{per_rank[-1]['step_ms_p99']:.3f} (steps 2-11, host clock, profiler on), of "
            f"which the exchanges barrier to barrier p50 {per_rank[-1]['exchange_ms_p50']:.3f} "
            f"ms; device busy {per_rank[-1]['device_busy_share']:.1%} ({busy:.3f} ms a step)")
    summed = sum(p["device_ms_per_step"] for p in per_rank)
    log(f"{what}: device ms a step summed over the ranks {summed:.3f}, against a step p50 of "
        f"{max(p['step_ms_p50'] for p in per_rank):.3f} ms (on one card the ranks' kernels "
        f"share it)")
    for o in per_rank[0]["ops"][:12]:
        log(f"  rank 0: {o['device_ms_per_step']:9.4f} ms/step  x{o['count']:<4d} {o['name'][:80]}")
    rec = {"config": f"ogb_gcn W=4 pallas_p2p {partition}", "world_size": P2P_W,
           "partition_method": partition, "partition": part, "losses": losses, "launches_per_step": want,
           "launches": launches, "run_s": run_s,
           "hub_rows": [rank["on_step"][0]["hub_rows"] for rank in ranks],
           "avg_epoch_ms_excl_first": res["avg_epoch_ms_excl_first"], "per_rank": per_rank}
    return cfg, rec, [rank["on_step"][0]["grads"] for rank in ranks]


def w4_cpu_oracle() -> tuple:
    """Step 0 of phase 9's GCN (``train_w4_run``'s config under ``random``)
    on 4 gloo ranks on the CPU, the p2p route's plain version: (rank 0's
    global loss and summed gradients, seconds)."""
    import dataclasses

    from dgraph_tpu_torch.comm.dist import launch
    from dgraph_tpu_torch.train.profile import ogb_gcn_config

    cfg = ogb_gcn_config(world_size=P2P_W, partition="random")
    tc = time.perf_counter()
    cpu = launch(cpu_step0_rank, P2P_W, dataclasses.asdict(cfg), device="cpu",
                 timeout=900, threads=max(1, (os.cpu_count() or 1) // P2P_W))
    return cpu[0], time.perf_counter() - tc


def phase_train_ogb_gcn_w4(turns, oracle) -> list:
    """Phase 9's training: :func:`train_w4_run` under each partition of
    ``turns`` in that order (both ``multilevel``, the CLI's default and the
    main row of kernel 5, and ``random``, the earlier row); every run's
    step-0 loss and every rank's gradients against one 4-rank gloo run on
    the CPU (``oracle``, a future of :func:`w4_cpu_oracle`; under
    ``random``: renumbering the vertices changes neither the seeded
    parameters nor the masked mean loss, so one reference holds them
    all)."""
    import torch

    runs = [train_w4_run(p) for p in turns]
    cpu, cpu_s = oracle.result()
    _W4_GCN_CPU.update(cpu, impl="pallas_p2p (plain)")
    want_grads = {k: torch.from_numpy(v) for k, v in cpu["grads"].items()}
    recs = []
    for cfg, rec, grads in runs:
        what = f"train ogb_gcn W=4 {cfg.data.partition}"
        loss0 = rec["losses"][0]
        if abs(loss0 - cpu["loss"]) > GRAD_TOL * max(1.0, abs(cpu["loss"])):
            fail(f"{what}: step-0 loss {loss0} vs CPU {cpu['loss']}")
        grad_err = 0.0
        for r, g in enumerate(grads):
            got = {k: torch.from_numpy(v) for k, v in g.items()}
            grad_err = max(grad_err, check_grads(f"{what} rank {r}", got, want_grads))
        rec.update(step0_loss_cpu=cpu["loss"], grad_max_abs_err=grad_err,
                   cpu_reference_s=cpu_s)
        p50 = [p["step_ms_p50"] for p in rec["per_rank"]]
        log(f"{what} (pallas_p2p): loss {rec['losses'][0]:.5f} -> {rec['losses'][-1]:.5f}; "
            f"launches a step a rank {dict((k, v) for k, v in rec['launches_per_step'].items() if v)}"
            f"; step-0 loss and grads vs the 4-rank CPU run (random partition) max abs err "
            f"{grad_err:.3g}; parameters bit-equal across ranks; step ms p50 per rank "
            f"{[round(x, 3) for x in p50]}; run {rec['run_s']:.1f} s, CPU reference {cpu_s:.1f} s")
        recs.append(rec)
    return recs


# --- main --------------------------------------------------------------------


# --- phase 10 ----------------------------------------------------------------


def train_cli_run(what, cfg, want, want_eval, prof_steps, hubs=False) -> tuple:
    """``python -m dgraph_tpu_torch.train``'s ``main`` at ``cfg``: every
    step launches exactly ``want`` (plus ``want_eval`` on the epochs that
    ran an eval: 0, every tenth and the last); steps ``prof_steps`` (first,
    last) under torch.profiler; the peak device memory of the run; then one
    more eval forward, which must launch exactly ``want_eval``; the loss
    must fall; no step after the first may compute CSR offsets again (the
    sorted kernels' searchsorted and hub plan, once per ids tensor of the
    plan); the hub route runs on no call, or with ``hubs`` on some call of
    each sorted sum that launched (:func:`check_step_launches`). Returns
    (the CLI's result, record, step 0's gradients)."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.ops import segment as seg
    from dgraph_tpu_torch.train import __main__ as cli
    from dgraph_tpu_torch.train.profile import device_ops

    first, last = prof_steps
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    per_step, grads0, offsets = [], {}, []

    def on_step(epoch, t):
        counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        offsets.append(seg.csr_offsets.computed)
        seg.csr_offsets.computed = 0
        evals = int(epoch % 10 == 0 or epoch == cfg.epochs - 1)
        check_step_launches(what, epoch, counts,
                            {k: want[k] + evals * want_eval[k] for k in want}, hubs)
        per_step.append(counts)
        if epoch == 0:
            grads0.update(grads_of(t.model))
        if epoch in (first - 1, last):
            torch.cuda.synchronize()
            (prof.start if epoch == first - 1 else prof.stop)()

    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(cfg.log_path):
        os.remove(cfg.log_path)
    kernels.reset_launch_counts()
    seg.csr_offsets.computed = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the CLI's JSON lines go to stderr: stdout keeps this script's two
    with contextlib.redirect_stdout(sys.stderr):
        res = cli.main(cfg, on_step=on_step)
    run_s = time.perf_counter() - t0
    if any(offsets[1:]):
        fail(f"{what}: steps after the first computed CSR offsets again: {offsets}")
    peak = torch.cuda.max_memory_allocated()
    t = res["training"]
    kernels.reset_launch_counts()
    te = time.perf_counter()
    eval_loss = float(t.eval_step(t.batches["val"])["loss"])
    eval_ms = (time.perf_counter() - te) * 1e3
    eval_counts = kernels.launch_counts()
    check_step_launches(what, "eval", eval_counts, want_eval, hubs)
    if not math.isfinite(eval_loss):
        fail(f"{what}: an eval forward's loss is {eval_loss}")
    losses = [r["loss"] for r in res["records"]]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: the loss did not fall over {len(losses)} steps: {losses}")
    ms = [r["wall_ms"] for r in res["records"]]
    n_prof = last - first + 1
    ops = device_ops(prof, n_prof)
    busy = sum(o["device_ms_per_step"] for o in ops)
    wall = sum(ms[first:last + 1]) / n_prof
    rec = {"config": what, "epochs": cfg.epochs, "E": t.graph.num_edges,
           "e_pad": t.graph.plan.e_pad, "n_pad": t.graph.plan.n_src_pad, "losses": losses,
           "step_wall_ms": ms, "timed_steps": f"{first}-{cfg.epochs - 1}",
           "step_ms_p50": float(np.percentile(ms[first:], 50)),
           "step_ms_p99": float(np.percentile(ms[first:], 99)),
           "launches_per_step": want, "launches_per_eval": want_eval,
           "launches": {k: sum(c[k] for c in per_step) for k in per_step[0]},
           "csr_offsets_per_step": offsets, "eval_ms": eval_ms, "peak_memory_bytes": peak, "run_s": run_s,
           "hub_rows": _HUB_ROWS.get(what),
           "profile": {"steps": f"{first}-{last}", "device_ms_per_step": busy,
                       "wall_ms_per_step": wall, "device_busy_share": busy / wall,
                       "ops": ops}}
    log(f"{what}: E={rec['E']} n_pad={rec['n_pad']}; step ms p50 {rec['step_ms_p50']:.3f} "
        f"p99 {rec['step_ms_p99']:.3f} (steps {rec['timed_steps']}, host clock); device busy "
        f"{busy / wall:.1%} ({busy:.3f} of {wall:.3f} ms a step, steps {first}-{last}, "
        f"profiler on); peak memory {peak / 2**30:.2f} GiB; loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; eval forward {eval_ms:.1f} ms; launches per step {want}; CSR "
        f"offsets computed per step {offsets}")
    for o in ops[:10]:
        log(f"  {o['device_ms_per_step']:9.4f} ms/step  x{o['count']:<4d} {o['name'][:80]}")
    return res, rec, grads0


def cli_step0_vs_cpu(what, cfg, num_nodes: int) -> dict:
    """Step 0 of the CLI's training at ``cfg`` on an SBM graph of
    ``num_nodes`` vertices (the same widths), on the card and on the CPU
    plain path: the loss and every gradient within GRAD_TOL."""
    import dataclasses

    from dgraph_tpu_torch.train import __main__ as cli

    small = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_nodes=num_nodes))
    out = {}
    for device in ("cuda", "cpu"):
        t = cli.build_training(small, device=device)
        t0 = time.perf_counter()
        loss = float(t.train_step(t.batches["train"])["loss"])
        out[device] = (loss, grads_of(t.model), time.perf_counter() - t0)
        del t
    (loss_gpu, grads_gpu, _), (loss_cpu, grads_cpu, cpu_s) = out["cuda"], out["cpu"]
    if abs(loss_gpu - loss_cpu) > GRAD_TOL * max(1.0, abs(loss_cpu)):
        fail(f"{what} at V={num_nodes}: step-0 loss {loss_gpu} vs CPU {loss_cpu}")
    err = check_grads(f"{what} at V={num_nodes}", grads_gpu, grads_cpu)
    log(f"{what} at V={num_nodes}: step-0 loss {loss_gpu:.6f} (CPU {loss_cpu:.6f}), grads vs "
        f"CPU max abs err {err:.3g} (CPU step {cpu_s:.1f} s)")
    return {"V": num_nodes, "loss": loss_gpu, "loss_cpu": loss_cpu, "grad_max_abs_err": err,
            "cpu_step_s": cpu_s}


def gt_sampled_rows(t, seed: int = 0) -> dict:
    """The forward kernel at the graph transformer's full shape, against
    float64: layer 0's q, k and v (the trained model, the train batch), the
    kernel's output over all GT_T slots, and the plain attention of
    GT_SAMPLED_ROWS rows (the last rows hold the padded slot) over every
    key, evaluated in float64 on the card; the error must be within
    F32_FWD_TOL, and the same plain attention on q, k and v truncated to
    TF32 (the control) must read above it. The padded row must be zero."""
    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.models.gcn import dense
    from dgraph_tpu_torch.ops import attention as att

    model, b = t.model, {k: v[0] for k, v in t.batches["train"].items()}
    vmask = b["vmask"]
    with torch.no_grad():
        h = dense(model.embed, b["x"], config.resolve_compute_dtype(model.dtype))
        h = h * vmask[:, None]
        gps = model.gps_0
        h = h + gps.local_branch(h, t.plan)
        q, k, v = gps.attention_inputs(h)
        out = att.flash_attention_fwd(q, k, v, kv_mask=vmask)[0]
    T, _, D = q.shape
    rows = torch.from_numpy(gt_rows(T, seed)).to(q.device)
    real = vmask > 0

    def plain64(qq, kk, vv):
        s = torch.einsum("rhd,shd->hrs", qq[rows].double(), kk.double()) * D ** -0.5
        p = torch.softmax(s.masked_fill(~real, -torch.inf), dim=-1)
        del s
        return torch.einsum("hrs,shd->rhd", p, vv.double()) * real[rows, None, None]

    ref = plain64(q, k, v)
    err = float((out[rows].double() - ref).abs().max())
    control = float((plain64(tf32_trunc(q), tf32_trunc(k), tf32_trunc(v)) - ref).abs().max())
    padded_zero = bool((out[~real] == 0).all())
    rec = {"rows": len(rows), "T": T, "max_abs_err": err, "limit": F32_FWD_TOL,
           "tf32_control": control, "padded_rows_zero": padded_zero,
           "max_abs_out": float(ref.abs().max())}
    log(f"gt sampled rows: {len(rows)} query rows over {T} keys against float64: err {err:.3g} "
        f"(limit {F32_FWD_TOL}), TF32 control {control:.3g}, largest |O| "
        f"{rec['max_abs_out']:.3g}; padded rows zero: {padded_zero}")
    if not err <= F32_FWD_TOL:
        fail(f"gt sampled rows: the forward kernel is {err:.3g} from float64 (limit "
             f"{F32_FWD_TOL})")
    if not control > F32_FWD_TOL:
        fail(f"gt sampled rows: the TF32 control reads {control:.3g}, inside the limit "
             f"{F32_FWD_TOL}: the check has no force")
    if not padded_zero:
        fail("gt sampled rows: the padded slot's output is not zero")
    return rec


# the graph transformer's steps in phase 10 (~4.8 s each in f32): a warm-up
# and two timed steps keep the whole run inside its time limit
GT_EPOCHS = 2  # a step takes seconds in f32: step 0 warms up, step 1 is timed


def phase_train_gt(dtype_name: str = "float32", f32_step0_loss=None) -> dict:
    """``python -m dgraph_tpu_torch.train --model gt`` at arxiv width
    (gt_arxiv: hidden 128, 4 heads of 32, 2 layers, attention over all
    169,344 slots): GT_EPOCHS steps, 1 warm-up and 1 timed (step 1
    profiled); every step launches the forward, dK/dV and dQ attention kernels once a layer
    and kernel 2 three times a layer and feature chunk (the local branch's
    sum and the backward of its two takes); an eval forward the forward
    kernel and the sum only. In f32 the sampled rows (gt_sampled_rows) and
    step 0 against the CPU plain path at V = 4096; in bf16
    (``config.default_compute_dtype``) step 0's loss within BF16_LOSS_TOL of
    the f32 run's, on the same weights and batch."""
    import dataclasses

    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.train.profile import gt_arxiv_config

    cfg = dataclasses.replace(gt_arxiv_config(), epochs=GT_EPOCHS,
                              log_path=os.path.join(OUT_DIR, f"train_gt_{dtype_name}.jsonl"))
    L = cfg.num_layers
    chunks = math.ceil(cfg.hidden / config.gather_col_block)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(flash_attention_fwd=L, flash_attention_bwd_dkv=L, flash_attention_bwd_dq=L,
                sorted_segment_sum=3 * L * chunks)
    want_eval = dict.fromkeys(kernels.KERNELS, 0)
    want_eval.update(flash_attention_fwd=L, sorted_segment_sum=L * chunks)
    what = f"train gt_arxiv {dtype_name}"
    saved = config.default_compute_dtype
    config.default_compute_dtype = dtype_name
    try:
        res, rec, _ = train_cli_run(what, cfg, want, want_eval, (1, GT_EPOCHS - 1))
        rec["dtype"] = dtype_name
        if dtype_name == "float32":
            rec["sampled_rows"] = gt_sampled_rows(res["training"])
    finally:
        config.default_compute_dtype = saved
    del res
    torch.cuda.empty_cache()
    if dtype_name == "float32":
        rec["step0_vs_cpu"] = cli_step0_vs_cpu("train gt_arxiv", cfg, 4096)
    else:
        rel = abs(rec["losses"][0] / f32_step0_loss - 1)
        rec.update(step0_loss_f32=f32_step0_loss, step0_loss_rel_to_f32=rel)
        log(f"{what}: step-0 loss {rec['losses'][0]:.5f} vs the f32 run's "
            f"{f32_step0_loss:.5f}: {rel:.3g} relative (limit {BF16_LOSS_TOL})")
        if not rel <= BF16_LOSS_TOL:
            fail(f"{what}: step-0 loss {rec['losses'][0]} vs the f32 run's {f32_step0_loss}")
    torch.cuda.empty_cache()
    return rec


def phase_train_gat() -> dict:
    """``python -m dgraph_tpu_torch.train --model gat`` at arxiv width
    (gat_arxiv: 4 heads of 128, 2 layers): 2 warm-up and 10 timed steps
    (steps 2-9 profiled); every step launches kernel 2 six times a head
    group and layer (the softmax denominator at width 1 and the message sum
    at width 128 forward; the backward of the src, dst, seg_max and denom
    takes), an eval forward two times. The logits of the CLI's model
    (``build_training(cfg)``) before its first step match a CPU copy of the
    same weights' plain forward (no autograd) at full size within 1e-4, and
    step 0's loss and every gradient match the CPU plain path at V = 16,384
    (the CPU's autograd at full size would keep about 40 GB of [E, 128]
    activations)."""
    import dataclasses

    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.train import __main__ as cli
    from dgraph_tpu_torch.train.loop import model_apply
    from dgraph_tpu_torch.train.profile import gat_arxiv_config

    cfg = dataclasses.replace(gat_arxiv_config(), epochs=12,
                              log_path=os.path.join(OUT_DIR, "train_gat.jsonl"))
    L, H, D = cfg.num_layers, 4, cfg.hidden
    groups = math.ceil(H / max(1, config.gather_col_block // D))
    want = dict.fromkeys(kernels.KERNELS, 0)
    want["sorted_segment_sum"] = 6 * L * groups
    want_eval = dict.fromkeys(kernels.KERNELS, 0)
    want_eval["sorted_segment_sum"] = 2 * L * groups
    res, rec, _ = train_cli_run("train gat_arxiv", cfg, want, want_eval, (2, 9))
    del res
    torch.cuda.empty_cache()
    t = cli.build_training(cfg)  # the CLI's own build: its model before the first step
    b = {k: v[0] for k, v in t.batches["train"].items()}
    model_cpu = copy.deepcopy(t.model).cpu()
    with torch.no_grad():
        logits = model_apply(t.model, b, t.plan).cpu()
        b = {k: v.cpu() for k, v in b.items()}
        tc = time.perf_counter()
        logits_cpu = model_apply(model_cpu, b, t.graph.plan.shard(0))
        cpu_s = time.perf_counter() - tc
    del t, b, model_cpu
    torch.cuda.empty_cache()
    err = float((logits - logits_cpu).abs().max())
    rec["full_size_logits_vs_cpu"] = {"max_abs_err": err, "cpu_forward_s": cpu_s}
    log(f"train gat_arxiv: the CLI's model before its first step against a CPU copy's plain "
        f"forward at full size: max abs err {err:.3g} (CPU forward {cpu_s:.1f} s)")
    if not torch.allclose(logits, logits_cpu, rtol=SERVE_TOL, atol=SERVE_TOL):
        fail(f"train gat_arxiv: full-size logits differ from the CPU plain forward by {err} "
             f"(tol {SERVE_TOL})")
    rec["step0_vs_cpu"] = cli_step0_vs_cpu("train gat_arxiv", cfg, 16384)
    torch.cuda.empty_cache()
    return rec


def graph_model_phases(cfg) -> tuple:
    """Phase 10, in the form of :func:`one_rank_phases`."""
    log("phase 10: train ogb_gcn --model gt (f32, then bf16) and --model gat "
        "(python -m dgraph_tpu_torch.train); phase 11's raw layout written beside")
    start_ogb_raw_layout()
    gt_f32 = phase_train_gt()
    gt_bf16 = phase_train_gt("bfloat16", gt_f32["losses"][0])
    gat = phase_train_gat()
    if gt_bf16["launches"] != gt_f32["launches"]:
        fail(f"train gt_arxiv bfloat16 launched {gt_bf16['launches']}, the f32 run "
             f"{gt_f32['launches']}")
    main_case = {name: [(f"{name} {run['dtype']} T={GT_T} H={GT_H} D={GT_D} gt",
                         run["launches"], f"gt_{run['dtype']}")
                        for run in (gt_bf16, gt_f32)]
                 for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                              "flash_attention_bwd_dq")}
    # kernel 2 in both models; GAT's launches run it at F = 128 and F = 1
    main_case["sorted_segment_sum"] = [
        ("sorted_segment_sum float32 none F=128", gt_f32["launches"], "gt"),
        ("sorted_segment_sum float32 none F=128", gat["launches"], "gat"),
        ("sorted_segment_sum float32 none F=1", gat["launches"], "gat_width1")]
    return [], main_case, {"train": [gt_f32, gt_bf16, gat]}


def one_rank_phases(cfg) -> tuple:
    """Phases 3-8: (kernel records, {kernel: [(phase 3's case, the launches
    of the path it serves, the row's key in the kernels line)]}, details);
    the first row of a kernel is its main row (key None)."""
    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.serve.__main__ import load_data

    log("phase 3: kernel parity and times")
    data = load_data(cfg)
    graph = DistributedGraph.from_global(
        data["edge_index"], data["features"], data["labels"], data["masks"],
        world_size=1, partition_method=cfg.partition, add_symmetric_norm=True,
    )
    del data
    kernels = phase_kernels(graph)
    del graph
    torch.cuda.empty_cache()
    attention = phase_attention()

    log("phase 4: serve GCN")
    gcn_chunks = cfg.num_layers * math.ceil(cfg.hidden / config.gather_col_block)
    gcn = serve_path("gcn", "sorted_segment_sum_bias_relu", gcn_chunks, 32)

    log("phase 5: serve SAGE")
    sage = serve_path("sage", "sorted_segment_sum",
                      sage_launches_per_forward(arxiv_config("sage")), 8)

    log("phase 6: train bench_gcn")
    bench = phase_train_bench_gcn()

    log("phase 7: train ogb_gcn (python -m dgraph_tpu_torch.train, gather kernel on)")
    ogb = phase_train_ogb_gcn()

    log("phase 8: train lm_flash (python -m dgraph_tpu_torch.train.lm), f32 then bf16")
    lm_flash, grads0 = phase_train_lm_flash()
    lm_flash_bf16 = phase_train_lm_flash("bfloat16", (lm_flash["losses"][0], grads0))[0]
    del grads0
    if lm_flash_bf16["launches"] != lm_flash["launches"]:
        fail(f"train lm_flash bfloat16 launched {lm_flash_bf16['launches']}, the f32 run "
             f"{lm_flash['launches']}")

    main_case = {
        "sorted_segment_sum_bias_relu": [("sorted_segment_sum_bias_relu float32 w F=128",
                                          gcn["launches"], None)],
        "sorted_segment_sum": [("sorted_segment_sum float32 none F=128", sage["launches"],
                                None)],
        "sorted_segment_sum_act": [("sorted_segment_sum_act float32 unw F=128",
                                    bench["launches"], None)],
        "fused_bwd_gd": [("fused_bwd_gd float32 F=128", bench["launches"], None)],
        "sorted_row_gather": [("sorted_row_gather float32 F=128", ogb["launches"], None)],
    }
    # the attention kernels by their bf16 (tensor-core) rows with the bf16
    # run's launches; their f32 rows (also on the tensor cores) beside them
    # with the f32 run's
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        main_case[name] = [(f"{name} bfloat16 T={LM_T} H={LM_H} D={LM_D} causal",
                            lm_flash_bf16["launches"], None),
                           (f"{name} float32 T={LM_T} H={LM_H} D={LM_D} causal",
                            lm_flash["launches"], "float32")]
    return (kernels["records"] + attention["records"], main_case,
            {"kernels": kernels, "attention": attention, "serve": [gcn, sage],
             "train": [bench, ogb, lm_flash, lm_flash_bf16]})


W4_TURNS = ("multilevel", "random")
# ``--phase 9``: the two partitions in both orders, so an order effect
# (the card's state, the allocator) shows apart from the partition's
W4_TURNS_ABBA = ("random", "multilevel", "multilevel", "random")


def multi_rank_phase(cfg, turns=W4_TURNS) -> tuple:
    """Phase 9, in the form of :func:`one_rank_phases`; the W = 4 training
    under each partition of ``turns``, in that order."""
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.serve.__main__ import load_data
    from dgraph_tpu_torch.train.__main__ import DataConfig

    log("phase 9: kernels 5 and 6 and the landing check at W = 4 and 2, then train ogb_gcn "
        f"over 4 ranks (DGRAPH_TPU_HALO_IMPL=pallas_p2p) under the partitions {turns}")
    # the training CLI's default partition (multilevel), which phase 9's
    # first run trains under: kernel 5's main shape
    partition = DataConfig().partition
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the CPU oracle of the trainings, beside the plan build and kernel
        # 5's checks (their kernel times are CUDA events)
        oracle = pool.submit(w4_cpu_oracle)
        data = load_data(cfg)
        t = time.perf_counter()
        graph4 = DistributedGraph.from_global(
            data["edge_index"], data["features"], data["labels"], data["masks"],
            world_size=P2P_W, partition_method=partition, add_symmetric_norm=True,
            overlap=True,
        )
        plan, part = graph4.plan, partition_record(graph4)
        if not part["native"]:
            fail(f"the native host library did not load: {part['native_error']}")
        log(f"W=4 plan ({partition}): {time.perf_counter() - t:.1f} s, of which the partition "
            f"{part['partition_s']:.2f} s; edge cut {part['edge_cut']:.4f}; owned per rank "
            f"{part['owned']}; S={plan.halo.s_pad} e_pad={plan.e_pad} n_pad={plan.n_src_pad} "
            f"deltas={plan.halo_deltas} interior/boundary edges per rank "
            f"{part['interior']}/{part['boundary']}")
        del data
        _W4_HALO.update(w4_halo_arrays(plan))
        p2p_k = phase_p2p_kernel(graph4)
        del graph4, plan
        ogb4 = phase_train_ogb_gcn_w4(turns, oracle)
    main_run = next(r for r in ogb4 if r["partition_method"] == partition)
    k6 = next(r for r in p2p_k["records"] if r["kernel"] == "p2p_transport_mutant")
    return (p2p_k["records"],
            {"p2p_transport": [(p2p_k["records"][0]["case"], main_run["launches"], None)],
             "p2p_transport_mutant": [(k6["case"], p2p_k["landing_launches"], None)]},
            {"p2p_transport": p2p_k, "train": ogb4, "w4_partition": part})


# --- phase 11 ----------------------------------------------------------------


def write_ogb_raw_layout(root: str) -> dict:
    """Phase 11's data, in a process of its own: ``ogbn.export_arxiv_shaped_npz``
    (V = 169,343, F = 128) written under ``root`` in ogbn-arxiv's raw
    download layout through ``ogb_raw.write_node_pred_raw`` (numpy and
    gzip) and parsed back by ``ogbn.load_ogb_arrays``: every array must
    equal ``from_npz``'s of the same export. Returns the seconds and sizes,
    or ``{"error": ...}``."""
    import numpy as np

    from dgraph_tpu_torch.data import ogb_raw, ogbn

    npz = os.path.join(root, "arxiv_shaped.npz")
    t0 = time.perf_counter()
    ogbn.export_arxiv_shaped_npz(npz, scale=1.0, seed=0)
    export_s = time.perf_counter() - t0
    z = ogbn.from_npz(npz)
    split = {k: np.flatnonzero(z[f"{k}_mask"]) for k in ("train", "valid", "test")}
    t0 = time.perf_counter()
    base = ogb_raw.write_node_pred_raw(root, "ogbn-arxiv", edge_index=z["edge_index"],
                                       labels=z["labels"], node_feat=z["features"],
                                       split_idx=split)
    write_s = time.perf_counter() - t0
    raw_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(base) for f in fs)
    t0 = time.perf_counter()
    arrs = ogbn.load_ogb_arrays("ogbn-arxiv", root=root)
    parse_s = time.perf_counter() - t0
    for k in ("edge_index", "features", "labels", "train_mask", "valid_mask", "test_mask"):
        # the export's masks are bool, the loader's float32 (as the reference's)
        want_k = z[k].astype(np.float32) if k.endswith("_mask") else z[k]
        if arrs[k].dtype != want_k.dtype or not np.array_equal(arrs[k], want_k):
            return {"error": f"ogb raw: {k} read back from the raw layout differs from "
                             f"from_npz ({arrs[k].dtype} {arrs[k].shape} vs {z[k].dtype} "
                             f"{z[k].shape})"}
    V, F = arrs["features"].shape
    return {"V": V, "F": F, "E": arrs["edge_index"].shape[1], "export_npz_s": export_s,
            "write_raw_s": write_s, "raw_bytes": raw_bytes, "parse_s": parse_s}


# phase 11's layout writer (write_ogb_raw_layout), started ahead of phase 11
_OGB_RAW: dict = {}


def start_ogb_raw_layout() -> None:
    """Start :func:`write_ogb_raw_layout` in a spawned process. The whole
    run starts it with phase 10, whose graph transformer keeps the card
    busy and the host idle, so phase 11 finds its layout written; the
    layout (about 128 MB) is deleted at the end of phase 11, or at exit."""
    import atexit
    import multiprocessing
    import shutil

    root = os.path.abspath(os.path.join(OUT_DIR, "ogb_raw"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    atexit.register(shutil.rmtree, root, True)
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    _OGB_RAW.update(root=root, pool=pool, t0=time.perf_counter(),
                    future=pool.submit(write_ogb_raw_layout, root))


def phase_ogb_raw() -> dict:
    """The OGB loaders on ogbn-arxiv's raw download layout at full size
    (:func:`write_ogb_raw_layout`, started here or, in the whole run, with
    phase 10), then ``python -m dgraph_tpu_torch.train``'s main on it with
    ``--data.ogb_name ogbn-arxiv --data.root <that layout>`` at the CLI's
    default partition, one rank, 3 steps, the sorted-row-gather kernel on:
    every step launches kernels 3 and 2 2x a chunk and layer, kernel 1 once
    (twice with an eval), the backward pair never. The layout (about 128 MB)
    is deleted at the end: OUT_DIR keeps only logs and records."""
    import dataclasses
    import shutil

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops import segment as seg
    from dgraph_tpu_torch.train import __main__ as cli
    from dgraph_tpu_torch.train.profile import ogb_gcn_config

    if not _OGB_RAW:
        start_ogb_raw_layout()
    root = _OGB_RAW["root"]
    try:
        try:
            info = _OGB_RAW["future"].result()
        finally:
            _OGB_RAW.pop("pool").shutdown()
        if "error" in info:
            fail(info["error"])
        V = info["V"]
        log(f"ogb raw: ogbn-arxiv-shaped export V={V} F={info['F']} E={info['E']}: export npz "
            f"{info['export_npz_s']:.1f} s; write raw layout {info['write_raw_s']:.1f} s "
            f"({info['raw_bytes'] / 1e6:.1f} MB gzipped); parse {info['parse_s']:.1f} s; "
            f"every array equal to from_npz's (a process of its own, started "
            f"{time.perf_counter() - _OGB_RAW['t0']:.1f} s ago)")

        cfg = ogb_gcn_config()
        cfg.data = dataclasses.replace(cfg.data, ogb_name="ogbn-arxiv", root=root)
        cfg.epochs, cfg.log_path = 3, os.path.join(OUT_DIR, "train_ogb_raw.jsonl")
        chunks = cfg.num_layers * math.ceil(cfg.hidden / config.gather_col_block)
        want = {"sorted_row_gather": 2 * chunks, "sorted_segment_sum": 2 * chunks,
                "sorted_segment_sum_act": 0, "fused_bwd_gd": 0}
        per_step = []

        def on_step(epoch, t):
            counts = seg.launch_counts()
            seg.reset_launch_counts()
            check_step_launches("train ogb raw", epoch, counts, want)
            evals = int(epoch % 10 == 0 or epoch == cfg.epochs - 1)
            if counts["sorted_segment_sum_bias_relu"] != chunks * (1 + evals):
                fail(f"train ogb raw: step {epoch} fused forward launches {counts}")
            per_step.append(counts)

        if os.path.exists(cfg.log_path):
            os.remove(cfg.log_path)
        config.use_pallas_gather = True
        try:
            seg.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                res = cli.main(cfg, on_step=on_step)
            run_s = time.perf_counter() - t0
        finally:
            config.use_pallas_gather = None
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = [r["loss"] for r in res["records"]]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train ogb raw: non-finite loss {losses}")
    t = res["training"]
    if t.graph.num_nodes != V or set(t.batches) != {"train", "val", "test"}:
        fail(f"train ogb raw: the CLI trained on V={t.graph.num_nodes} with splits "
             f"{sorted(t.batches)}")
    ms = [r["wall_ms"] for r in res["records"]]
    rec = {"config": "ogb_gcn --data.ogb_name ogbn-arxiv (raw layout)", "V": V, "F": info["F"],
           "partition": cfg.data.partition, "export_npz_s": info["export_npz_s"],
           "write_raw_s": info["write_raw_s"], "raw_bytes": info["raw_bytes"],
           "parse_s": info["parse_s"], "losses": losses, "step_wall_ms": ms, "run_s": run_s,
           "launches_per_step": want,
           "launches": {k: sum(c[k] for c in per_step) for k in per_step[0]}}
    log(f"train ogb raw (--data.ogb_name ogbn-arxiv, gather kernel on): step wall ms {ms}; "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; launches per step {want}; run "
        f"{run_s:.1f} s (the parse and the partition included)")
    del res, t
    return rec


def ogb_raw_phase(cfg) -> tuple:
    """Phase 11, in the form of :func:`one_rank_phases`."""
    import torch

    log("phase 11: the OGB raw layout through the training CLI (--data.ogb_name)")
    rec = phase_ogb_raw()
    torch.cuda.empty_cache()
    return [], {}, {"train": [rec]}


# --- phase 12 ----------------------------------------------------------------


def write_skewed_npz(path: str, seed: int = 0) -> dict:
    """The degree-skewed arxiv-sized graph (``synthetic.skewed_arxiv_edges``:
    V = 169,343, 2,332,486 directed edges) as a ``--data.path`` npz: its
    edge_index, features [V, 128] f32 and labels of 40 classes drawn from
    the seed, and train/valid/test masks of ogbn-arxiv's sizes (90,941 /
    29,799 / the rest) over a seeded permutation. Returns its degree
    profile against the hub route's constants."""
    import numpy as np

    from dgraph_tpu_torch.data.synthetic import ARXIV_NODES, skewed_arxiv_edges
    from dgraph_tpu_torch.ops import segment as seg

    edges = skewed_arxiv_edges(seed)
    V = ARXIV_NODES
    rng = np.random.default_rng(seed)
    order = rng.permutation(V)
    bounds = (0, 90_941, 90_941 + 29_799, V)
    masks = {}
    for split, a, b in zip(("train", "valid", "test"), bounds, bounds[1:]):
        masks[f"{split}_mask"] = np.zeros(V, bool)
        masks[f"{split}_mask"][order[a:b]] = True
    np.savez(path, edge_index=edges, features=rng.standard_normal((V, 128), dtype=np.float32),
             labels=rng.integers(0, 40, V).astype(np.int32), **masks)
    deg = np.bincount(edges[1], minlength=V)
    hubs = deg[deg > seg.HUB_DEGREE]
    return {"V": V, "E": int(edges.shape[1]), "max_degree": int(deg.max()),
            "hub_rows": int(hubs.size), "hub_edges": int(hubs.sum()),
            "hub_chunks": int(np.ceil(hubs / seg.HUB_CHUNK).sum())}


def hub_device_ms(rec) -> dict:
    """Device ms a step of the sorted segment sums (their kernels hold the
    hub route's partial pass) and of the combine pass, from a run's
    profile."""
    ops = rec["profile"]["ops"]
    return {"segment_sum_kernels": sum(o["device_ms_per_step"] for o in ops
                                       if "segment_sum" in o["name"]),
            "hub_combine": sum(o["device_ms_per_step"] for o in ops
                               if "hub_combine" in o["name"])}


def phase_gcn_skewed() -> tuple:
    """GCN on the degree-skewed arxiv-sized graph (:func:`write_skewed_npz`,
    deleted after): ``python -m dgraph_tpu_torch.train``'s main with
    ``--data.path`` at ogb_gcn's settings (H = 256, 2 layers, symmetric-norm
    weights, Adam 5e-3, one rank, the CLI's default partition) with the
    sorted-row-gather kernel on, 2 warm-up and 10 timed steps (kernels 1, 2
    and 3, launches as phase 7's; the hub route on some call of each sorted
    sum every step; steps 2-11 profiled); step 0's loss and gradients
    against the CPU plain path; then phase 6's bench_gcn step on the same
    graph (kernels 1, 1a, 4 and 2, unweighted). Each run: step ms p50 / p99,
    the device-busy share, the device ms of the sorted sums and of the
    combine pass."""
    import dataclasses

    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.data.synthetic import skewed_arxiv_edges
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.train.profile import ogb_gcn_config
    from dgraph_tpu_torch.weights import init_params

    os.makedirs(OUT_DIR, exist_ok=True)
    npz = os.path.join(OUT_DIR, "gcn_skewed.npz")
    try:
        t0 = time.perf_counter()
        graph = write_skewed_npz(npz)
        write_s = time.perf_counter() - t0
        log(f"gcn_skewed: the skewed arxiv graph written in {write_s:.1f} s: {graph}")
        cfg = ogb_gcn_config()
        cfg.data = dataclasses.replace(cfg.data, path=npz)
        cfg.epochs, cfg.log_path = 12, os.path.join(OUT_DIR, "train_gcn_skewed.jsonl")
        chunks = cfg.num_layers * math.ceil(cfg.hidden / config.gather_col_block)
        want = dict.fromkeys(kernels.KERNELS, 0)
        want.update(sorted_row_gather=2 * chunks, sorted_segment_sum=2 * chunks,
                    sorted_segment_sum_bias_relu=chunks)
        want_eval = dict.fromkeys(kernels.KERNELS, 0)
        want_eval["sorted_segment_sum_bias_relu"] = chunks
        config.use_pallas_gather = True
        try:
            res, rec, grads0 = train_cli_run("train gcn_skewed", cfg, want, want_eval, (2, 11),
                                             hubs=True)
        finally:
            config.use_pallas_gather = None
    finally:
        if os.path.exists(npz):
            os.remove(npz)
    t = res["training"]
    model_cpu = init_params(GCN(t.graph.features.shape[-1], cfg.hidden, 40, SingleComm(),
                                num_layers=cfg.num_layers), seed=0)
    batch = dict(t.graph.batch("train"), y=t.graph.labels)
    tc = time.perf_counter()
    loss_cpu, grads_cpu = cpu_step0(model_cpu, batch, t.graph.plan, t.loss_fn)
    cpu_s = time.perf_counter() - tc
    if abs(rec["losses"][0] - loss_cpu) > GRAD_TOL * max(1.0, abs(loss_cpu)):
        fail(f"train gcn_skewed: step-0 loss {rec['losses'][0]} vs CPU {loss_cpu}")
    rec.update(graph=graph, write_npz_s=write_s, step0_loss_cpu=loss_cpu,
               grad_max_abs_err=check_grads("train gcn_skewed", grads0, grads_cpu),
               cpu_reference_s=cpu_s, hub_device_ms_per_step=hub_device_ms(rec))
    del res, t, model_cpu, batch
    torch.cuda.empty_cache()
    log(f"train gcn_skewed: step-0 grads vs CPU max abs err {rec['grad_max_abs_err']:.3g} "
        f"(CPU step {cpu_s:.1f} s); device ms a step {rec['hub_device_ms_per_step']}")
    bench = phase_train_bench_gcn(skewed_arxiv_edges(), "train bench_gcn_skewed")
    bench["hub_device_ms_per_step"] = hub_device_ms(bench)
    log(f"train bench_gcn_skewed: device ms a step {bench['hub_device_ms_per_step']}")
    return rec, bench


def skewed_phase(cfg, kernel_cases_too: bool = False) -> tuple:
    """Phase 12, in the form of :func:`one_rank_phases`; alone
    (``--phase 12``) it first holds kernels 1, 1a and 2 to their plain
    versions on the skewed graph's plan ids, which phase 3 does otherwise."""
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    records, detail = [], {}
    if kernel_cases_too:
        log("phase 12: kernels 1, 1a and 2 on the skewed graph's plan ids")
        gen = torch.Generator(device="cuda").manual_seed(0)
        records = skewed_graph_cases(seg, gen, lambda *a: None)
        detail["skewed_graph_kernels"] = records
    log("phase 12: train GCN on the degree-skewed arxiv-sized graph (--data.path), then "
        "bench_gcn on it")
    cli_run, bench = phase_gcn_skewed()
    main_case = {
        "sorted_segment_sum_bias_relu": [("sorted_segment_sum_bias_relu float32 w F=128 "
                                          "skewed graph", cli_run["launches"], "gcn_skewed")],
        "sorted_segment_sum": [("sorted_segment_sum float32 none F=128 skewed graph",
                                cli_run["launches"], "gcn_skewed")],
        "sorted_segment_sum_act": [("sorted_segment_sum_act float32 unw F=128 skewed graph",
                                    bench["launches"], "bench_gcn_skewed")],
    }
    return records, main_case, {"train": [cli_run, bench], **detail}


# --- phase 13 ----------------------------------------------------------------

LOWERINGS = ("all_to_all", "ppermute", "overlap", "pallas_p2p", "sched")
LOWERING_F = 256
LOWERING_REPS = 3  # timed calls a leg and lowering (the median is logged)
# the timed calls a leg on one shared card, where host-staged times compare
# no lowering (a cut of depth that keeps the whole run inside its time
# limit; every check still runs); a card a rank: LOWERING_REPS
SHARED_CARD_REPS = 1
W13_EPOCHS = 2  # training steps a phase-13 run on one card (at most 4)
W13_EPOCHS_NCCL = 12  # on cards of their own, where a step takes a tenth
W13_TRACE_STEPS = 4  # GCN 'overlap' on four cards: steps profiled after the timed ones
GAT_STEP0_V = 16384  # GAT's step 0 against the CPU, as phase 10 holds it
# (model, DGRAPH_TPU_HALO_IMPL) of phase 13's training runs; on four cards
# GCN also runs under every other lowering (its step timed under each)
W13_RUNS = (("gcn", "overlap"), ("sage", "overlap"), ("gat", "overlap"), ("gat", "ppermute"),
            ("gcn", "sched"))
# runs held to the CPU oracle of another run: the same step 0, another lowering
W13_SHARED_ORACLE = {("gcn", "sched"): ("gcn", "overlap")}
# (wire format, activation dtype) of the lowering parity's wire turns (bf16
# on bf16 activations is the identity, which the turns without one cover)
WIRE_TURNS = (("bf16", "float32"), ("fp8", "float32"), ("fp8", "bfloat16"))
# the training run under a wire format: (model, lowering, format), its step
# 0 held to the f32-wire run of the same model on the same plan
W13_WIRE_RUN = ("gcn", "pallas_p2p", "fp8")
W13_WIRE_BASE = ("gcn", "overlap")
CODEC_REPS = 10
@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms on inside (``index_add_`` on the
    card then adds in a fixed order)."""
    import torch

    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved)


def dropped_transfer(schedule):
    """(the schedule with one transfer taken out, that transfer): the first
    whose live rows no other window of its pair covers, built by hand (the
    compiler's verifier would reject it). The control of the 'sched'
    parity: its exchange must miss ``all_to_all``'s bits on those rows."""
    from dgraph_tpu_torch.sched import HaloSchedule, Round

    wins = [(t, k, r.row_count) for k, r in enumerate(schedule.rounds) for t in r.transfers]
    for t, k, _ in wins:
        rows = set(range(t.row_start, t.row_start + t.row_count))
        for u, j, c in wins:
            if j != k and (u.src, u.dst) == (t.src, t.dst):
                rows -= set(range(u.row_start, u.row_start + c))
        if rows:
            rounds = [Round(tuple(u for u in r.transfers if u != t)) for r in schedule.rounds]
            return HaloSchedule(schedule.world_size, schedule.s_pad,
                                tuple(r for r in rounds if r.transfers)), t
    raise ValueError("every transfer's rows are covered by another window")


def lowering_parity_rank(group, real: dict) -> dict:
    """One rank of the lowering parity at the W = 4 plan's send lists,
    F = LOWERING_F, f32 and bf16: the exchange (``halo_exchange``) and the
    reverse sum (``halo_scatter_sum``) under each of LOWERINGS. 'overlap',
    'pallas_p2p' and 'sched' must give ``all_to_all``'s bits in both legs
    (the exchange on the rows a round lands: the blocks of live deltas, the
    schedule's windows), 'ppermute' in the exchange; its reverse, a masked
    sum a delta, within TOL of ``all_to_all``'s (max abs error over the
    largest magnitude), which a control, the same reverse without the first
    delta's rounds, must exceed. In f32 the exchange's x VJP under
    'ppermute' must give the bits of its per-delta sums added in reverse
    delta order (the reference's backward), and under a schedule with one
    transfer taken out (:func:`dropped_transfer`) the exchange must miss
    ``all_to_all``'s bits on that transfer's rows. The outputs held to each
    other are computed under torch's deterministic algorithms: the owners'
    masked sum is an ``index_add_``, whose atomic adds on the card sum in an
    order that varies from call to call (and so did ``all_to_all``'s against
    itself). Each leg timed
    barrier to barrier (the deterministic mode off, as in training), the
    median of LOWERING_REPS calls (on a shared card: SHARED_CARD_REPS)."""
    import statistics

    import torch

    from dgraph_tpu_torch.comm import collectives as coll
    from dgraph_tpu_torch.plan import HaloSpec

    dev, W, me = group.device, group.world_size, group.rank
    deltas, S, n_pad, sched = real["deltas"], real["S"], real["n_pad"], real["schedule"]
    halo = HaloSpec(torch.from_numpy(real["send_idx"][me]).to(dev),
                    torch.from_numpy(real["send_mask"][me]).to(dev), S)
    gen = torch.Generator(device=dev).manual_seed(300 + me)
    x32 = torch.randn(n_pad, LOWERING_F, generator=gen, device=dev)
    h32 = torch.randn(W * S, LOWERING_F, generator=gen, device=dev)
    landed = torch.cat([torch.arange(((me - d) % W) * S, ((me - d) % W + 1) * S)
                        for d in deltas]).to(dev)

    def windows(schedule) -> torch.Tensor:  # the rows this rank's rounds land
        rows = {t.src * S + r: None for rnd in schedule.rounds for t in rnd.transfers
                if t.dst == me for r in range(t.row_start, t.row_start + rnd.row_count)}
        return torch.tensor(sorted(rows), dtype=torch.long, device=dev)

    landed_rows = {impl: landed for impl in LOWERINGS}
    landed_rows["sched"] = windows(sched)
    ctrl_sched, cut = dropped_transfer(sched)
    cut_rows = torch.arange(cut.src * S + cut.row_start,
                            cut.src * S + cut.row_start + cut.row_count, device=dev)
    failures, records, controls = [], [], []
    spent = {"check_s": 0.0, "time_s": 0.0}
    reps = LOWERING_REPS if group.backend == "nccl" else SHARED_CARD_REPS

    def barrier_ms(fn) -> float:
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            group.barrier()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            group.barrier()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    def rel(got, want) -> float:
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        x, h = x32.to(dtype), h32.to(dtype)
        out = {}
        for impl in LOWERINGS:
            ex = lambda: coll.halo_exchange(x, halo, group, deltas, impl, sched)  # noqa: E731
            rv = lambda: coll.halo_scatter_sum(h, halo, n_pad, group, deltas, impl,  # noqa: E731
                                               sched)
            t = time.perf_counter()
            with deterministic():
                out[impl] = (ex(), rv())
            torch.cuda.synchronize(dev)
            spent["check_s"] += time.perf_counter() - t
            t = time.perf_counter()
            records.append({"impl": impl, "dtype": dtype_name, "exchange_ms": barrier_ms(ex),
                            "reverse_ms": barrier_ms(rv), "backend": group.backend,
                            "reps": reps})
            spent["time_s"] += time.perf_counter() - t
        buf0, back0 = out["all_to_all"]
        for impl in LOWERINGS[1:]:
            buf, back = out[impl]
            rows = landed_rows[impl]
            if not torch.equal(bits(buf[rows]), bits(buf0[rows])):
                failures.append(f"{impl} {dtype_name}: the exchange's landed rows differ from "
                                "all_to_all's")
            if impl != "ppermute" and not torch.equal(bits(back), bits(back0)):
                failures.append(f"{impl} {dtype_name}: the reverse sum differs from "
                                "all_to_all's")
        err = rel(out["ppermute"][1], back0)
        with deterministic():
            dropped = coll.halo_scatter_sum(h, halo, n_pad, group, deltas[1:], "ppermute")
        control = rel(dropped, back0)
        if not err <= TOL[dtype_name]:
            failures.append(f"ppermute {dtype_name}: the reverse sum is {err:.3g} from "
                            f"all_to_all's (limit {TOL[dtype_name]})")
        if not control > TOL[dtype_name]:
            failures.append(f"ppermute {dtype_name}: the control (delta {deltas[0]} left out) "
                            f"reads {control:.3g}, inside the limit {TOL[dtype_name]}")
        records.append({"impl": "ppermute reverse vs all_to_all", "dtype": dtype_name,
                        "rel_err": err, "control": control, "limit": TOL[dtype_name]})
        with deterministic():
            ctrl = coll.halo_exchange(x, halo, group, deltas, "sched", ctrl_sched)
        torch.cuda.synchronize(dev)
        if cut.dst == me:
            missed = not torch.equal(bits(ctrl[cut_rows]), bits(buf0[cut_rows]))
            if not missed:
                failures.append(f"sched {dtype_name}: the control (transfer {cut} taken out) "
                                "gives all_to_all's bits on its rows")
            controls.append({"impl": "sched control", "dtype": dtype_name, "missed": missed,
                             "transfer": [cut.src, cut.dst, cut.row_start, cut.row_count]})
        if dtype_name == "float32":
            failures += ppermute_x_vjp(group, x, h, halo, deltas, n_pad, records)
    # the wire turns: each lowering under each (format, activation dtype) of
    # WIRE_TURNS, bit-equal to all_to_all under the same format in both legs
    # (ppermute's reverse within TOL, its per-delta order)
    for fmt, dtype_name in WIRE_TURNS:
        dtype = getattr(torch, dtype_name)
        x, h = x32.to(dtype), h32.to(dtype)
        out = {}
        for impl in LOWERINGS:
            ex = lambda: coll.halo_exchange(x, halo, group, deltas, impl, sched, fmt)  # noqa: E731
            rv = lambda: coll.halo_scatter_sum(h, halo, n_pad, group, deltas,  # noqa: E731
                                               impl, sched, fmt)
            t = time.perf_counter()
            with deterministic():
                out[impl] = (ex(), rv())
            torch.cuda.synchronize(dev)
            spent["check_s"] += time.perf_counter() - t
            t = time.perf_counter()
            records.append({"impl": impl, "dtype": dtype_name, "wire": fmt,
                            "exchange_ms": barrier_ms(ex),
                            "reverse_ms": barrier_ms(rv), "backend": group.backend,
                            "reps": reps})
            spent["time_s"] += time.perf_counter() - t
        buf0, back0 = out["all_to_all"]
        for impl in LOWERINGS[1:]:
            buf, back = out[impl]
            rows = landed_rows[impl]
            if not torch.equal(bits(buf[rows]), bits(buf0[rows])):
                failures.append(f"{impl} {dtype_name} wire {fmt}: the exchange's landed rows "
                                "differ from all_to_all's")
            if impl != "ppermute" and not torch.equal(bits(back), bits(back0)):
                failures.append(f"{impl} {dtype_name} wire {fmt}: the reverse sum differs from "
                                "all_to_all's")
        err = rel(out["ppermute"][1], back0)
        if not err <= TOL[dtype_name]:
            failures.append(f"ppermute {dtype_name} wire {fmt}: the reverse sum is {err:.3g} from "
                            f"all_to_all's (limit {TOL[dtype_name]})")
        records.append({"impl": "ppermute reverse vs all_to_all", "dtype": dtype_name,
                        "wire": fmt, "rel_err": err, "control": None, "limit": TOL[dtype_name]})
    return {"failures": failures, "records": records, "controls": controls, **spent}


def ppermute_x_vjp(group, x, g, halo, deltas, n_pad, records: list) -> list:
    """The exchange's x VJP under 'ppermute' on this rank against its
    expected bits: the peers' blocks of ``g`` delivered by ``all_to_all``,
    masked, one segment sum a delta, added in reverse delta order (JAX's
    transpose of the reference's exchange). Records whether the delta-order
    sum differs (so the check sees the order). Returns the failures."""
    import torch

    from dgraph_tpu_torch.comm import collectives as coll
    from dgraph_tpu_torch.ops.p2p import all_to_all

    W, S, me = group.world_size, halo.s_pad, group.rank
    with deterministic():
        xv = x.detach().clone().requires_grad_()
        coll.halo_exchange(xv, halo, group, deltas, "ppermute").backward(g)
        back = all_to_all(g.reshape(W, S, -1), group)
        peers = [(me + d) % W for d in deltas]
        want = coll._per_delta_owner_sum(back, halo, n_pad, peers[::-1])
        fwd_order = coll._per_delta_owner_sum(back, halo, n_pad, peers)
    same = torch.equal(bits(xv.grad), bits(want))
    records.append({"impl": "ppermute x VJP vs its reverse-order sum", "dtype": "float32",
                    "bit_equal": same,
                    "delta_order_differs": not torch.equal(bits(fwd_order), bits(want))})
    return [] if same else ["ppermute float32: the x VJP misses its reverse-order sum's bits"]


def codec_rows(F: int, seed: int):
    """Seeded f32 rows on the host: normal rows, a zero row, a row of -0.0,
    rows of 1e-4 and 1e4 scale, a row whose small entries land in e4m3's
    subnormal range after the row scale, and a row of f32 subnormals."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(64, F, generator=g)
    x[1], x[2] = 0.0, -0.0
    x[3] *= 1e-4
    x[4] *= 1e4
    x[5, 1:] *= 1e-3
    x[6] = torch.tensor([1e-40, -3e-42, 5e-39, 0.0, -1e-45, 2e-39] * F)[:F]
    return x


def device_kernels(fn) -> "int | None":
    """The device kernels one call of ``fn`` launches (torch.profiler): the
    larger count of two profiled calls (in a process that profiled before,
    a profile has been seen to record no device activity), or None where
    neither saw any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA))
    return max(counts) or None


def wire_codec_check(S: int) -> dict:
    """The wire codecs on the card: for bf16 and fp8, f32 and bf16
    activations (bf16 on bf16 is the identity), F in {6, 256}, on
    :func:`codec_rows`: the torch codec's bytes on the card equal its bytes
    on the host and the port's numpy reference codec's
    (``spec.np_encode(compiled=True)``: the reference's compiled fp8
    scale), and decoding either gives the same bits (f32 also
    ``np_decode``'s). Then each codec's time at one rank's exchange of the
    W = 4 plan (encode ``[3 S, 256]``, decode ``[3 S, wire width]``; CUDA
    events, CODEC_REPS calls) and its device kernels a call."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.wire import codec, spec

    def raw(t):
        return t.contiguous().view(torch.uint8).cpu().numpy().tobytes()

    failures, cases, times = [], 0, {}
    for fmt in ("bf16", "fp8"):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            enc, dec = codec.make_wire_transform(fmt, dtype)
            if enc is None:
                continue
            for F in (6, 256):
                x = codec_rows(F, seed=F)
                if dtype == torch.bfloat16:
                    x = codec.to_bf16(x)
                want = np.ascontiguousarray(spec.np_encode(x.float().numpy(), fmt, compiled=True))
                dev, host = enc(x.cuda()), enc(x)
                what = f"codec {fmt} {dtype_name} F={F}"
                if raw(dev) != want.view(np.uint8).tobytes() or raw(host) != raw(dev):
                    failures.append(f"{what}: the card's bytes differ from the reference codec's")
                back_dev, back_host = dec(dev).cpu(), dec(host)
                if not torch.equal(bits(back_dev), bits(back_host)):
                    failures.append(f"{what}: the card's decode differs from the host's")
                if dtype == torch.float32 and raw(back_dev) != np.ascontiguousarray(
                        spec.np_decode(want, fmt)).view(np.uint8).tobytes():
                    failures.append(f"{what}: the card's decode differs from np_decode's")
                cases += 1
            x = torch.randn(3 * S, LOWERING_F, device="cuda").to(dtype)
            y = enc(x)
            times[f"{fmt} {dtype_name}"] = {
                "encode_ms": time_ms(lambda: enc(x), reps=CODEC_REPS),
                "decode_ms": time_ms(lambda: dec(y), reps=CODEC_REPS),
                "encode_kernels": device_kernels(lambda: enc(x)),
                "decode_kernels": device_kernels(lambda: dec(y)),
                "rows": 3 * S, "F": LOWERING_F, "wire_width": y.shape[-1],
                "wire_bytes": y.numel() * y.element_size(),
                "activation_bytes": x.numel() * x.element_size()}
    if failures:
        fail(f"the wire codecs on the card: {failures[:5]}")
    for k, t in times.items():
        log(f"wire codec {k} at [{t['rows']}, {t['F']}] (one rank's exchange at W={P2P_W}): "
            f"encode {t['encode_ms']:.4f} ms ({t['encode_kernels']} kernels), decode "
            f"{t['decode_ms']:.4f} ms ({t['decode_kernels']} kernels); "
            f"{t['activation_bytes']} -> {t['wire_bytes']} bytes")
    log(f"wire codecs: {cases} cases bit-equal on the card, the host and the numpy reference "
        "codec, encode and decode")
    return {"cases": cases, "times": times}


def phase_lowering_parity() -> dict:
    """The five lowerings at the W = 4 multilevel plan on 4 ranks
    (:func:`lowering_parity_rank`), the plan phase 9 built or, alone, built
    here; each leg's time the mean over the ranks of their medians."""
    import numpy as np

    from dgraph_tpu_torch.comm.dist import launch

    if not _W4_HALO:
        from dgraph_tpu_torch.data import DistributedGraph
        from dgraph_tpu_torch.serve.__main__ import load_data
        from dgraph_tpu_torch.train.__main__ import DataConfig

        data = load_data(arxiv_config("gcn"))
        t = time.perf_counter()
        graph = DistributedGraph.from_global(
            data["edge_index"], data["features"], data["labels"], data["masks"],
            world_size=P2P_W, partition_method=DataConfig().partition, add_symmetric_norm=True)
        _W4_HALO.update(w4_halo_arrays(graph.plan))
        log(f"W=4 plan ({DataConfig().partition}): {time.perf_counter() - t:.1f} s")
    real = _W4_HALO
    sched = real["schedule"]
    rows = sched.round_rows()
    sched_rec = {"schedule_id": sched.schedule_id, "rounds": sched.num_rounds,
                 "round_rows": list(rows), "operand_rows": sched.operand_rows(),
                 "all_to_all_rows": (P2P_W - 1) * real["S"],
                 "transfers": sched.num_transfers}
    log(f"W={P2P_W} halo schedule {sched.schedule_id}: {sched.num_rounds} rounds of "
        f"{sched.num_transfers} transfers, C_k {list(rows)}, {sched.operand_rows()} operand "
        f"rows a rank against all_to_all's (W-1)*S = {sched_rec['all_to_all_rows']}")
    codec = wire_codec_check(real["S"])
    t0 = time.perf_counter()
    res = launch(lowering_parity_rank, P2P_W, real, device="cuda", timeout=600)
    failures = [f for r in res for f in r["failures"]]
    if failures:
        fail(f"the halo lowerings at W=4: {failures[:5]}")
    recs = []
    for i, rec in enumerate(res[0]["records"]):
        per_rank = [r["records"][i] for r in res]
        wire = f" wire {rec['wire']}" if rec.get("wire") else ""
        if "exchange_ms" in rec:
            rec = dict(rec, **{k: float(np.mean([r[k] for r in per_rank]))
                               for k in ("exchange_ms", "reverse_ms")},
                       exchange_ms_per_rank=[r["exchange_ms"] for r in per_rank])
            log(f"lowering {rec['impl']} {rec['dtype']}{wire} W={P2P_W} S={real['S']} "
                f"F={LOWERING_F}: exchange {rec['exchange_ms']:.2f} ms, reverse "
                f"{rec['reverse_ms']:.2f} ms (barrier to barrier, median of "
                f"{LOWERING_REPS if rec['backend'] == 'nccl' else SHARED_CARD_REPS}, "
                f"mean over ranks; {rec['backend']})")
        elif "rel_err" in rec:
            ctrl = [r["control"] for r in per_rank if r["control"] is not None]
            rec = dict(rec, rel_err=max(r["rel_err"] for r in per_rank),
                       control=min(ctrl) if ctrl else None)
            log(f"{rec['impl']} {rec['dtype']}{wire}: {rec['rel_err']:.3g} relative (limit "
                f"{rec['limit']})" + (f"; control, a delta left out, {rec['control']:.3g}"
                                      if ctrl else ""))
        elif "bit_equal" in rec:
            rec = dict(rec, bit_equal=all(r["bit_equal"] for r in per_rank),
                       delta_order_differs=[r["delta_order_differs"] for r in per_rank])
            log(f"{rec['impl']} {rec['dtype']}: bit-equal on every rank; the delta-order "
                f"sum differs from it on ranks "
                f"{[r for r, d in enumerate(rec['delta_order_differs']) if d]}")
        recs.append(rec)
    # the control's record comes from the rank that receives the cut transfer
    ctrl = [rec for r in res for rec in r["controls"]]
    for rec in ctrl:
        log(f"sched control {rec['dtype']}: transfer (src, dst, start, rows) "
            f"{tuple(rec['transfer'])} taken out: all_to_all's bits missed on its rows")
    recs += ctrl
    if len(ctrl) != 2:
        fail(f"the sched control ran on {len(ctrl)} of 2 dtypes")
    log(f"halo lowerings W={P2P_W} S={real['S']} deltas={real['deltas']} F={LOWERING_F}: "
        "overlap, pallas_p2p and sched bit-equal to all_to_all in both legs (the exchange on "
        "its landed rows), ppermute's exchange bit-equal, its x VJP its reverse-order sum's "
        f"bits and its reverse within TOL; the same under the wire turns {WIRE_TURNS} "
        f"({time.perf_counter() - t0:.1f} s with the spawn; rank 0: checks "
        f"{res[0]['check_s']:.1f} s, timed calls {res[0]['time_s']:.1f} s)")
    return {"records": recs, "S": real["S"], "deltas": list(real["deltas"]),
            "schedule": sched_rec, "codec": codec}


def w13_config(model: str):
    """The CLI's Config of a phase-13 run: ogb_gcn's arxiv-width graph over 4
    ranks (GAT at gat_arxiv's width), W13_EPOCHS steps (W13_EPOCHS_NCCL on
    four cards)."""
    import dataclasses

    from dgraph_tpu_torch.train.profile import gat_arxiv_config, ogb_gcn_config

    import torch

    base = gat_arxiv_config() if model == "gat" else ogb_gcn_config()
    epochs = W13_EPOCHS_NCCL if torch.cuda.device_count() >= P2P_W else W13_EPOCHS
    return dataclasses.replace(base, model=model, world_size=P2P_W, epochs=epochs)


def w13_launches(cfg, impl: str, wire=None) -> tuple:
    """(a train step's, an eval's) kernel launches a rank of a phase-13 run.
    GCN on the split route ('overlap', 'pallas_p2p'): kernel 1 on both
    subsets of each feature chunk, kernel 2 for each subset's bias gradient
    (the subsets' takes have unsorted ids: row gathers), under 'pallas_p2p'
    kernel 5 for each exchange and its reverse; GCN unsplit: kernel 1 once
    a chunk, kernel 2 for its bias gradient and the src-side take's VJP (the
    plan's sorting permutation), as phase 7 without the gather kernel.
    GraphSAGE on the split route: kernel 2 on both subsets of each chunk
    and once for the degree, forward only (the backward's takes are row
    gathers). GAT as phase 10 (the attention's sums on the dst-owned side;
    its one collective is the src-side exchange)."""
    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops.kernels import KERNELS

    want, want_eval = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    cb = config.gather_col_block
    if cfg.model == "gcn":
        chunks = cfg.num_layers * math.ceil(cfg.hidden / cb)
        split = impl in ("overlap", "pallas_p2p")
        want.update(sorted_segment_sum_bias_relu=(1 + split) * chunks,
                    sorted_segment_sum=2 * chunks)
        want_eval.update(sorted_segment_sum_bias_relu=(1 + split) * chunks)
        if impl == "pallas_p2p":
            want.update(p2p_transport=2 * cfg.num_layers)
            want_eval.update(p2p_transport=cfg.num_layers)
            if wire == "fp8":  # every put moves the encoded uint8 tiles
                want["p2p_transport.byte_launches"] = want["p2p_transport"]
                want_eval["p2p_transport.byte_launches"] = want_eval["p2p_transport"]
    elif cfg.model == "sage":
        widths = [cfg.data.feat_dim] + [cfg.hidden] * (cfg.num_layers - 1)
        n = sum(2 * math.ceil(w / cb) + 1 for w in widths)
        want.update(sorted_segment_sum=n)
        want_eval.update(sorted_segment_sum=n)
    else:
        groups = math.ceil(4 / max(1, cb // cfg.hidden))
        want.update(sorted_segment_sum=6 * cfg.num_layers * groups)
        want_eval.update(sorted_segment_sum=2 * cfg.num_layers * groups)
    return want, want_eval


class Phase13Probe:
    """``on_step`` of a phase-13 run, in each rank's process: each step's
    kernel launches (then zeroed); at step 0 the lowering the rank resolved,
    whether it took the split route, its gradients and its cached plans' hub
    rows, and with ``small`` (a Config as a dict) step 0 of that config
    built on the same ranks (GAT at V = GAT_STEP0_V: its loss and
    gradients); at the last step the parameters; with ``trace_from`` a
    profile of the steps after step ``trace_from`` (none of them timed),
    and whether kernel 1 ran beside an NCCL kernel there
    (:func:`overlap_with_nccl`)."""

    def __init__(self, epochs: int, small: dict | None = None, trace_from: int | None = None):
        self.epochs, self.small, self.trace_from = epochs, small, trace_from
        self.prof = None

    def __call__(self, epoch, t):
        import torch
        from torch.profiler import ProfilerActivity

        from dgraph_tpu_torch.comm import collectives
        from dgraph_tpu_torch.ops import kernels, p2p

        out = {"counts": {**kernels.launch_counts(),
                          "p2p_transport.byte_launches": p2p.p2p_transport.byte_launches}}
        kernels.reset_launch_counts()
        if epoch == 0:
            out.update(impl=collectives.resolve_plan_impl(t.plan, t.comm.group),
                       wire=collectives.resolve_plan_wire_format(t.plan, t.comm.group),
                       split=t.comm.split_active(t.plan), grads=grads_of(t.model),
                       hub_rows=cached_hub_rows())
            if self.small is not None:
                from dgraph_tpu_torch.train import __main__ as cli

                c = cli.Config(**dict(self.small, data=cli.DataConfig(**self.small["data"])))
                s = cli.build_training(c, comm=t.comm)
                out["small"] = {"loss": float(s.train_step(s.batches["train"])["loss"]),
                                "grads": grads_of(s.model)}
                del s
                kernels.reset_launch_counts()
        if epoch == self.trace_from:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        if epoch == self.epochs - 1:
            out["params"] = {k: v.detach().cpu().numpy() for k, v in t.model.state_dict().items()}
            if self.prof is not None:
                torch.cuda.synchronize()
                self.prof.stop()
                out["overlap"] = overlap_with_nccl(self.prof)
        return out


def overlap_with_nccl(prof) -> dict:
    """From a profile's device kernels: kernel 1's launches
    (``segment_sum_bias_relu``) and the NCCL kernels, how many of kernel 1's
    ran beside an NCCL kernel and for how many ms together."""
    from torch.autograd import DeviceType

    kern = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > e.time_range.start]
    nccl = [(a, b) for a, b, n in kern if "nccl" in n.lower()]
    k1 = [(a, b) for a, b, n in kern if "segment_sum_bias_relu" in n]
    beside, both_us = 0, 0.0
    for a, b in k1:
        over = sum(max(0.0, min(b, d) - max(a, c)) for c, d in nccl)
        beside += over > 0
        both_us += over
    return {"kernel1": len(k1), "nccl": len(nccl), "kernel1_beside_nccl": beside,
            "beside_ms": both_us / 1e3, "nccl_ms": sum(d - c for c, d in nccl) / 1e3,
            "nccl_kernels": sorted({n for _, _, n in kern if "nccl" in n.lower()})[:4]}


def cpu_step0_w13(group, cfgs: list) -> list:
    """Step 0's global loss and summed gradients of one rank on the CPU
    plain path under each ``(cfg as a dict, the lowering pinned)``: the
    oracles of phase 13's card runs (the same lowering, gloo)."""
    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.comm import DistComm
    from dgraph_tpu_torch.train import __main__ as cli

    from dgraph_tpu_torch.comm.collectives import resolve_plan_impl

    out = []
    for cfg, impl in cfgs:
        config.halo_impl = impl
        c = cli.Config(**dict(cfg, data=cli.DataConfig(**cfg["data"]), device="cpu"))
        t = cli.build_training(c, comm=DistComm(group))
        loss = float(t.train_step(t.batches["train"])["loss"])
        out.append({"loss": loss, "impl": resolve_plan_impl(t.plan, group),
                    "grads": {k: v.numpy() for k, v in grads_of(t.model).items()}})
        del t
    return out


@contextlib.contextmanager
def wire_format_env(fmt):
    """DGRAPH_TPU_WIRE_FORMAT=``fmt`` for the ranks spawned inside (None:
    the variable as it is)."""
    saved = os.environ.get("DGRAPH_TPU_WIRE_FORMAT")
    if fmt is not None:
        os.environ["DGRAPH_TPU_WIRE_FORMAT"] = fmt
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("DGRAPH_TPU_WIRE_FORMAT", None)
        else:
            os.environ["DGRAPH_TPU_WIRE_FORMAT"] = saved


def train_w13_run(model: str, impl: str, trace: bool = False, wire=None) -> tuple:
    """``python -m dgraph_tpu_torch.train``'s main over 4 ranks with
    DGRAPH_TPU_HALO_IMPL=``impl``: every rank resolved ``impl`` (GCN and
    GraphSAGE under 'overlap' on the split route), every step launched
    :func:`w13_launches`' kernels, the loss fell and the ranks' parameters
    are bit-equal after the last step. With ``trace``, W13_TRACE_STEPS more
    steps run under the profiler after the timed ones. With ``wire``,
    DGRAPH_TPU_WIRE_FORMAT=``wire``: every rank resolved it (under fp8 on
    'pallas_p2p' every put of kernel 5 moved uint8 tiles). Returns (the Config,
    the record, every rank's step-0 gradients, every rank's small step or
    None)."""
    import dataclasses

    import numpy as np
    import torch

    from dgraph_tpu_torch.train import __main__ as cli

    what = f"{model} W={P2P_W} {impl}" + (f" wire {wire}" if wire else "")
    cfg = w13_config(model)
    timed = cfg.epochs  # steps 1 to timed - 1 give the step times
    if trace:
        cfg = dataclasses.replace(cfg, epochs=timed + W13_TRACE_STEPS)
    cfg.log_path = os.path.join(OUT_DIR, f"train_{model}_w4_{impl}"
                                + (f"_{wire}" if wire else "") + ".jsonl")
    small = None
    if model == "gat":
        small = dataclasses.asdict(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, num_nodes=GAT_STEP0_V)))
    want, want_eval = w13_launches(cfg, impl, wire)
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(cfg.log_path):
        os.remove(cfg.log_path)
    t0 = time.perf_counter()
    with halo_impl_env(impl), wire_format_env(wire), contextlib.redirect_stdout(sys.stderr):
        res = cli.main(cfg, on_step=Phase13Probe(cfg.epochs, small,
                                                 timed - 1 if trace else None))
    run_s = time.perf_counter() - t0
    ranks = res["ranks"]
    for r, rank in enumerate(ranks):
        p0 = rank["on_step"][0]
        if p0["impl"] != impl or p0["split"] != (impl in ("overlap", "pallas_p2p")):
            fail(f"{what}: rank {r} resolved {p0['impl']!r} (split {p0['split']})")
        if p0["wire"] != (wire or "fp32"):
            fail(f"{what}: rank {r} resolved the wire format {p0['wire']!r}")
        for i, probe in enumerate(rank["on_step"]):
            evals = int(i % 10 == 0 or i == cfg.epochs - 1)
            check_step_launches(f"{what} rank {r}", i, probe["counts"],
                                {k: want[k] + evals * want_eval[k] for k in want},
                                hub_rows=p0["hub_rows"])
    losses = [rec["loss"] for rec in res["records"]]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: the loss did not fall over {cfg.epochs} steps: {losses}")
    last = [rank["on_step"][-1]["params"] for rank in ranks]
    for r in range(1, P2P_W):
        for k, v in last[0].items():
            if not np.array_equal(last[r][k], v):
                fail(f"{what}: rank {r}'s {k} differs from rank 0's after the last step")
    ms = [[rec["wall_ms"] for rec in rank["records"]] for rank in ranks]
    rec = {"config": what, "model": model, "impl": impl, "world_size": P2P_W, "wire": wire,
           "backend": "nccl" if torch.cuda.device_count() >= P2P_W else "gloo",
           "losses": losses, "launches_per_step": want, "launches_per_eval": want_eval,
           "launches": {k: sum(p["counts"][k] for rank in ranks for p in rank["on_step"])
                        for k in want},
           "step_ms": ms, "step_ms_p50": [float(np.percentile(m[1:timed], 50)) for m in ms],
           "step_ms_p99": [float(np.percentile(m[1:timed], 99)) for m in ms],
           "run_s": run_s, "overlap": [rank["on_step"][-1].get("overlap") for rank in ranks]}
    log(f"{what}: resolved {impl!r} on every rank (split route: "
        f"{ranks[0]['on_step'][0]['split'] and model != 'gat'}); loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; launches a step a rank "
        f"{dict((k, v) for k, v in want.items() if v)}; parameters bit-equal across ranks; "
        f"step ms p50 (steps 1-{timed - 1}) per rank "
        f"{[round(x, 1) for x in rec['step_ms_p50']]} [{rec['backend']}]; run {run_s:.1f} s")
    if trace:
        log(f"{what}: steps {timed}-{cfg.epochs - 1} profiled: {rec['overlap']}")
    smalls = [rank["on_step"][0].get("small") for rank in ranks]
    return cfg, rec, [rank["on_step"][0]["grads"] for rank in ranks], smalls


def lowering_phase(cfg) -> tuple:
    """Phase 13, in the form of :func:`one_rank_phases`: the lowerings'
    parity at W = 4, then GCN and GraphSAGE under 'overlap', GAT under
    'overlap' and 'ppermute' and GCN under 'sched' through the training CLI
    over 4 ranks, each run's step 0 against a 4-rank gloo run on the CPU
    under the same pin (GAT's at V = GAT_STEP0_V: the run's ranks build it
    beside their own; GCN's against phase 9's CPU run, the p2p route's
    plain version, when phase 9 ran; GCN's under 'sched' against GCN's
    'overlap' oracle, W13_SHARED_ORACLE). On one card the CPU runs go on
    beside the card's (the whole run's time limit), so those host-staged
    step times compare no lowering. On four cards the CPU runs come first, on the host's cores,
    and no timed step shares the host with them; GCN also runs under
    'all_to_all', 'ppermute' and 'pallas_p2p', and its 'overlap' run
    profiles W13_TRACE_STEPS steps after its timed ones."""
    import dataclasses

    import torch

    from dgraph_tpu_torch.comm.dist import launch

    log("phase 13: the wire codecs, the halo lowerings all_to_all, ppermute, overlap, "
        "pallas_p2p and sched at W = 4 (f32, bf16, and under the wire formats), then GCN and "
        "GraphSAGE under overlap, GAT under overlap and ppermute, GCN under sched and GCN under "
        "pallas_p2p with DGRAPH_TPU_WIRE_FORMAT=fp8 over 4 ranks (python -m "
        "dgraph_tpu_torch.train)")
    parity = phase_lowering_parity()
    four = torch.cuda.device_count() >= P2P_W
    runs = list(W13_RUNS)
    if four:
        runs += [("gcn", i) for i in LOWERINGS if ("gcn", i) not in runs]
    # the CPU oracles, one a (model, lowering) of W13_RUNS (GAT's at its small
    # size; GCN's phase 9's when it ran)
    oracles = [run for run in W13_RUNS if run not in W13_SHARED_ORACLE
               and not (run[0] == "gcn" and _W4_GCN_CPU)]
    cpu_cfgs = []
    for model, impl in oracles:
        c = dataclasses.asdict(dataclasses.replace(w13_config(model), device="cpu"))
        if model == "gat":
            c["data"]["num_nodes"] = GAT_STEP0_V
        cpu_cfgs.append((c, impl))
    threads = max(1, len(os.sched_getaffinity(0)) // P2P_W - 1) if four else 1

    def oracle_ranks():
        tc = time.perf_counter()
        res = launch(cpu_step0_w13, P2P_W, cpu_cfgs, device="cpu", timeout=900,
                     threads=threads)
        return res[0], time.perf_counter() - tc

    out = []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu_future = pool.submit(oracle_ranks)
        if four:
            cpu_future.result()
        for model, impl in runs:
            trace = four and (model, impl) == ("gcn", "overlap")
            out.append((model, impl) + train_w13_run(model, impl, trace))
        wire_model, wire_impl, wire_fmt = W13_WIRE_RUN
        wire_run = train_w13_run(wire_model, wire_impl, wire=wire_fmt)
        cpu, cpu_s = cpu_future.result()
        cpu = dict(zip(oracles, cpu))
    if _W4_GCN_CPU:
        cpu[("gcn", "overlap")] = _W4_GCN_CPU
    for run, other in W13_SHARED_ORACLE.items():
        cpu[run] = cpu[other]
    recs = []
    for model, impl, cfg, rec, grads, smalls in out:
        what = f"{model} W={P2P_W} {impl}"
        if (model, impl) in cpu:
            want = cpu[(model, impl)]
            if model == "gat":
                loss0, grads, where = smalls[0]["loss"], [s["grads"] for s in smalls], (
                    f"at V={GAT_STEP0_V}")
            else:
                loss0, where = rec["losses"][0], "at full size"
            if abs(loss0 - want["loss"]) > GRAD_TOL * max(1.0, abs(want["loss"])):
                fail(f"{what}: step-0 loss {loss0} {where} vs CPU {want['loss']}")
            want_grads = {k2: torch.from_numpy(v) for k2, v in want["grads"].items()}
            err = max(check_grads(f"{what} rank {r}", g, want_grads)
                      for r, g in enumerate(grads))
            rec.update(step0_vs_cpu={"where": where, "loss": loss0, "loss_cpu": want["loss"],
                                     "cpu_impl": want["impl"], "grad_max_abs_err": err,
                                     "cpu_s": cpu_s})
            log(f"{what}: step-0 loss {loss0:.6f} {where} (CPU {want['loss']:.6f}, gloo, "
                f"{want['impl']}), every rank's grads vs the 4-rank CPU run max abs err "
                f"{err:.3g}")
        recs.append(rec)
    log(f"phase 13's CPU oracles {oracles}: {cpu_s:.1f} s (4 gloo ranks, {threads} threads "
        f"each, {'before' if four else 'beside'} the card's runs)")
    # the wire run's step 0 against the f32-wire run of the same model on
    # the same plan, within one round trip of the format
    from dgraph_tpu_torch.wire.spec import np_roundtrip_bound

    wrec = wire_run[1]
    base = next(r for r in recs if (r["model"], r["impl"]) == W13_WIRE_BASE)
    limit = np_roundtrip_bound(wire_fmt)
    l0, b0 = wrec["losses"][0], base["losses"][0]
    if not (math.isfinite(l0) and abs(l0 - b0) <= limit * abs(b0)):
        fail(f"{wrec['config']}: step-0 loss {l0} vs the f32-wire {base['config']} run's {b0} "
             f"(limit {limit} relative)")
    wrec["step0_vs_f32_wire"] = {"base": base["config"], "loss": l0, "loss_f32_wire": b0,
                                 "rel_diff": abs(l0 - b0) / abs(b0), "limit": limit}
    log(f"{wrec['config']}: step-0 loss {l0:.6f} vs the f32-wire {base['config']} run's "
        f"{b0:.6f}: {abs(l0 - b0) / abs(b0):.3g} relative (limit {limit:.4g}, "
        f"np_roundtrip_bound); kernel 5 moved uint8 tiles "
        f"{wrec['launches']['p2p_transport.byte_launches']} times")
    recs.append(wrec)
    gcn = next(r for r in recs if r["model"] == "gcn")
    gcn_sched = next(r for r in recs if (r["model"], r["impl"]) == ("gcn", "sched"))
    sage = next(r for r in recs if r["model"] == "sage")
    gats = [r for r in recs if r["model"] == "gat"]
    main_case = {
        "sorted_segment_sum_bias_relu": [
            ("sorted_segment_sum_bias_relu float32 w F=128", r["launches"], f"gcn_w4_{r['impl']}")
            for r in (gcn, gcn_sched)],
        "sorted_segment_sum": [("sorted_segment_sum float32 none F=128", sage["launches"],
                                "sage_w4_overlap")] + [
            ("sorted_segment_sum float32 none F=128", r["launches"], f"{r['model']}_w4_{r['impl']}")
            for r in gats + [gcn_sched]],
        # kernel 5 on uint8 tiles: phase 9's record at the plan's fp8 width,
        # the launches of the fp8 run's puts
        "p2p_transport": [(p2p_case_name("uint8", 1, False, P2P_W, parity["S"], LOWERING_F + 4),
                           {"p2p_transport": wrec["launches"]["p2p_transport.byte_launches"]},
                           "uint8_fp8_wire")],
    }
    return [], main_case, {"train": recs, "lowerings": parity}


# --- phase 14 ----------------------------------------------------------------


def graphcast_launches(layers: int, latent: int, gather: bool = False, train: bool = True,
                       p2p: bool = False) -> dict:
    """The launches of kernels 2, 3 and 5 in one GraphCast training step a
    rank (``train``: forward under remat, the recompute and the backward) or
    in one forward (a rollout step), derived from the model: ``layers + 2``
    edge and node blocks (encoder, processor, decoder), each edge block's
    takes cut into ``ceil(latent / gather_col_block)`` feature chunks.

    - kernel 2: every node block's dst-side sum, in the forward and again
      in its recompute; in the backward, a chunk's halo-side take (the sort
      route's sum) and its dst-side take (the sorted take's transpose);
    - kernel 3 with ``gather`` (``DGRAPH_TPU_PALLAS_GATHER=1``): a chunk's
      dst-side take, in the forward and the recompute, and the backward's
      row take of each node block's sum;
    - kernel 5 with ``p2p`` (the ``pallas_p2p`` lowering over ranks): every
      edge block's src-side exchange, in the forward and the recompute, and
      its reverse in the backward.

    Kernels 1, 1a and 4 never launch (no fused bias-relu)."""
    from dgraph_tpu_torch import config

    blocks = layers + 2
    chunks = -(-latent // (config.gather_col_block or latent))
    if train:
        return {"sorted_segment_sum": blocks * (2 + 2 * chunks),
                "sorted_row_gather": blocks * (2 * chunks + 1) if gather else 0,
                "p2p_transport": 3 * blocks if p2p else 0}
    return {"sorted_segment_sum": blocks, "sorted_row_gather": blocks * chunks if gather else 0,
            "p2p_transport": blocks if p2p else 0}


# bench_graphcast's configuration (bench.py:660-662), the widest GraphCast the
# repo supports: the level-6 multimesh on the 0.25-degree ERA5 grid, 73
# channels, latent 256, 16 processor layers, through the training CLI
GC_MAIN = dict(mesh_level=6, num_lat=721, num_lon=1440, channels=73, latent=256,
               processor_layers=16)
# the reference's structural anchors at level 6 on 721x1440
# (tests/test_graphcast.py:57-64): mesh vertices, directed multimesh edges,
# grid2mesh and mesh2grid edges
GC_ANCHORS = {"mesh_vertices": 40_962, "mesh_edges": 327_660, "g2m_edges": 1_618_824,
              "m2g_edges": 3_114_720}
GC_WARMUP, GC_TIMED, GC_PROF = 2, 8, 2  # main-path steps: warm-up, timed, profiled after
GC_BF16_TIMED = 4  # the bf16 turn's timed steps, after GC_WARMUP
GC_ROLLOUT = 2  # --eval_rollout's steps at full width (raw and EMA tracks)
# step 0 against the CPU plain path at a depth the CPU runs in seconds
GC_SMALL = dict(mesh_level=3, num_lat=91, num_lon=180, channels=73, latent=64,
                processor_layers=2)
# the W = 4 turns at the experiment's defaults (level 4, 181x360, latent
# 128, 4 layers): their step-0 loss within GC_W4_TOL relative of a W = 1
# run's on the same weights and sample
GC_W4, GC_W4_STEPS, GC_W4_TOL = 4, 2, 1e-5
GC_W4_STEPS_NCCL = 12  # on a host of GC_W4 cards (NCCL): step 0, then 11 timed
GC_P2P_REL = "g2m"  # kernel 5 timed at this relation's W = 4 exchange (the grid's halo)
GC_KERNEL_F = (256, 128)  # kernel 2 and 3 at the GraphCast shapes: latent 256's
# feature chunk (and a whole latent-128 row) and the main path's chunk width


def graphcast_config(**kw):
    """The GraphCast CLI's Config with its log under OUT_DIR."""
    from dgraph_tpu_torch.train import graphcast as gc_cli

    return gc_cli.Config(**{"log_path": os.path.join(OUT_DIR, "graphcast_torch.jsonl"), **kw})


def graphcast_want(layers: int, latent: int, gather: bool = False, train: bool = True,
                   p2p: bool = False) -> dict:
    """Every kernel's launches a GraphCast step (or forward): kernels 2, 3
    and 5 as :func:`graphcast_launches` derives them, no other kernel."""
    from dgraph_tpu_torch.ops.kernels import KERNELS

    return {**{k: 0 for k in KERNELS}, **graphcast_launches(layers, latent, gather, train, p2p)}


def check_exact_launches(what, step, counts, want) -> None:
    """Every kernel of ``want`` launched exactly as often; the hub route on
    no more calls than its kernel launched."""
    for k, n in want.items():
        if counts[k] != n:
            fail(f"{what}: step {step} launched {k} {counts[k]} times (want {n}); "
                 f"counts {counts}")
    for k, n in counts.items():
        if k.endswith(".hub_calls") and n > counts[k.removesuffix(".hub_calls")]:
            fail(f"{what}: step {step}: {k} = {n} above its launches; counts {counts}")


class LaunchesByShape:
    """Kernels 2, 3 and 5 counted at each shape they launch at. Their
    launch sites (``ops.segment._segment_sum`` and ``_row_gather``,
    ``ops.p2p._transport``) are wrapped while it is installed, and each
    call's launches are read from its wrapper's count around the call.
    ``counts`` maps a shape's key (:func:`shape_key`) to its launches.
    ``with LaunchesByShape() as tally:`` installs it for the block;
    :class:`GraphCastProbe` installs one in each rank's process."""

    def __init__(self):
        self.counts: dict = {}
        self.saved = None

    def _count(self, key, wrapper, call):
        before = wrapper.launches
        out = call()
        if wrapper.launches > before:
            self.counts[key] = self.counts.get(key, 0) + wrapper.launches - before
        return out

    def install(self) -> None:
        from dgraph_tpu_torch.ops import p2p
        from dgraph_tpu_torch.ops import segment as seg

        segment_sum, row_gather, transport = self.saved = (
            seg._segment_sum, seg._row_gather, p2p._transport)
        seg._segment_sum = lambda data, ids, n, op: self._count(  # noqa: E731
            shape_key("sorted_segment_sum", data.shape[0], n, data.shape[1], data.dtype),
            seg.sorted_segment_sum, lambda: segment_sum(data, ids, n, op))
        seg._row_gather = lambda x, ids: self._count(  # noqa: E731
            shape_key("sorted_row_gather", ids.shape[0], x.shape[0], x.shape[1], x.dtype),
            seg.sorted_row_gather, lambda: row_gather(x, ids))

        def counted_transport(blocks, deltas, W, S, sign, mask, group, *, wrapper, **kw):
            key = p2p_shape_key(wrapper.__name__, S, blocks.shape[2], blocks.dtype, sign)
            return self._count(key, wrapper, lambda: transport(
                blocks, deltas, W, S, sign, mask, group, wrapper=wrapper, **kw))
        p2p._transport = counted_transport

    def remove(self) -> None:
        from dgraph_tpu_torch.ops import p2p
        from dgraph_tpu_torch.ops import segment as seg

        seg._segment_sum, seg._row_gather, p2p._transport = self.saved

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.remove()


def shape_key(kernel, E, N, F, dtype) -> str:
    """A kernel-2 or kernel-3 shape: E ids (edges) into N rows, F wide."""
    return f"{kernel} E={E} N={N} F={F} {str(dtype).removeprefix('torch.')}"


def p2p_shape_key(kernel, S, F, dtype, sign) -> str:
    """A kernel-5 (or kernel-6) shape: tiles of S rows, F wide, one leg."""
    return f"{kernel} S={S} F={F} {str(dtype).removeprefix('torch.')} sign={sign:+d}"


class GraphCastProbe:
    """``on_step`` of a GraphCast CLI run (in each rank's process above one
    rank): each step's launches (then zeroed), loss and CSR offsets
    computed; at step 0 the lowering each plan resolved; at the last step
    (``last``) the parameters, and with ``micro`` the CLI's
    microbenchmark on the rank's training (``train.graphcast.microbenchmark``).
    With ``p2p_rel`` or ``shapes``, a :class:`LaunchesByShape` is installed
    in each rank's process as the probe arrives there (before the rank's
    first step), and the last step hands back its counts; with ``p2p_rel``
    it then times kernel 5 at that relation's exchange and its reverse
    (:func:`p2p_real_case`, f32 at the model's latent width), after the
    run's launches are read (over replica groups, replica 0's ranks)."""

    def __init__(self, last: int, micro: bool = False, p2p_rel: str = "",
                 shapes: bool = False):
        self.last, self.micro, self.p2p_rel = last, micro, p2p_rel
        self.shapes = shapes or bool(p2p_rel)
        self.by_shape = None

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.shapes:
            self.by_shape = LaunchesByShape()
            self.by_shape.install()

    def __call__(self, step, t, sm):
        import torch

        from dgraph_tpu_torch.comm import collectives
        from dgraph_tpu_torch.ops import kernels
        from dgraph_tpu_torch.ops import segment as seg

        out = {"counts": kernels.launch_counts(), "loss": float(sm.loss),
               "offsets": seg.csr_offsets.computed}
        kernels.reset_launch_counts()
        seg.csr_offsets.computed = 0
        if step == 0:
            out["impl"] = {k: collectives.resolve_plan_impl(p, t.comm.group)
                           for k, p in t.plans.items()}
            out["pads"] = {k: {"s_pad": p.halo.s_pad, "n_src_pad": p.n_src_pad,
                               "deltas": p.halo_deltas} for k, p in t.plans.items()}
        if step == self.last:
            out["params"] = {k: p.detach().cpu().numpy().copy()
                             for k, p in t.model.named_parameters()}
            if self.micro:
                from dgraph_tpu_torch.train import graphcast as gc_cli

                out["microbenchmark"] = gc_cli.microbenchmark(t)
                kernels.reset_launch_counts()
            if self.by_shape is not None:
                self.by_shape.remove()
                out["by_shape"] = dict(self.by_shape.counts)
            # over replica groups sharing a card, replica 0's ranks time it
            if self.p2p_rel and t.replica == 0:
                group = t.comm.group
                gen = torch.Generator(device=group.device).manual_seed(140 + group.rank)
                real = w4_halo_arrays(getattr(t.graphs, f"{self.p2p_rel}_plan"))
                out["p2p_failures"], out["p2p_records"] = [], []
                for sign in (1, -1):
                    rec, _ = p2p_real_case(group, gen, real, t.model.latent, "float32", sign,
                                           out["p2p_failures"], f" graphcast {self.p2p_rel}")
                    out["p2p_records"].append(rec)
                kernels.reset_launch_counts()
        return out


def graphcast_steps_check(what, probes, want) -> list:
    """Each step's launches exact, no step after the first computing CSR
    offsets, every loss finite; returns the losses."""
    for i, p in enumerate(probes):
        check_exact_launches(what, i, p["counts"], want)
    offsets = [p["offsets"] for p in probes]
    if any(offsets[1:]):
        fail(f"{what}: steps after the first computed CSR offsets again: {offsets}")
    losses = [p["loss"] for p in probes]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: a non-finite loss: {losses}")
    return losses


def graphcast_kernel_cases(t, relations=("m2g", "g2m", "mesh"), widths=GC_KERNEL_F,
                           dtypes=("float32", "bfloat16"),
                           kernels=("sorted_segment_sum", "sorted_row_gather"),
                           label="graphcast") -> list:
    """Kernels 2 and 3 at the main path's shapes: each relation's dst ids
    (m2g 3 edges a grid row, g2m about 40 a mesh row, mesh about 8), F in
    GC_KERNEL_F, f32 and bf16 (or the ``relations``, ``widths``, ``dtypes``
    and ``kernels`` given; ``t.plans[rel]`` needs only ``dst_index`` and
    ``n_dst_pad``; each case named with ``label``). On values that are multiples of 1/4 (sums
    exact in any order) the kernel must equal its plain version bit for
    bit; on normal values each output is held to TOL of the sum of its
    terms' magnitudes (the summation order differs: the plain version adds
    by atomics), two launches must give equal bits, and it is timed beside
    the plain version, the one PyTorch call
    (``index_add_`` for kernel 2 in f32, ``index_select`` for kernel 3) and
    the bound."""
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    dev = t.device
    gen = torch.Generator(device=dev).manual_seed(14)
    records = []
    for rel in relations:
        plan = t.plans[rel]
        ids, n = plan.dst_index, plan.n_dst_pad
        e_pad, e_valid = ids.shape[0], int((ids < n).sum())
        deg = seg._row_ptr(ids, n).diff()
        hubs = int((deg > seg.HUB_DEGREE).sum())
        for dtype_name, F in itertools.product(dtypes, widths):
            dtype = getattr(torch, dtype_name)
            exact = quarter_values(gen, e_pad, F).to(dtype)
            table = quarter_values(gen, n, F).to(dtype)
            for kernel, run, plain in (
                    ("sorted_segment_sum", lambda d: seg.sorted_segment_sum(d, ids, n),
                     lambda d: seg.sorted_segment_sum_plain(d, ids, n)),
                    ("sorted_row_gather", lambda x: seg.sorted_row_gather(x, ids),
                     lambda x: seg.sorted_row_gather_plain(x, ids))):
                if kernel not in kernels:
                    continue
                name = f"{kernel} {dtype_name} {label} {rel} F={F}"
                arg = exact if kernel == "sorted_segment_sum" else table
                if not torch.equal(bits(run(arg)), bits(plain(arg))):
                    fail(f"{name}: the kernel's bits differ from its plain version's on "
                         f"values whose sums are exact")
                arg = torch.randn(arg.shape, generator=gen, device=dev).to(dtype)
                got, want = run(arg), plain(arg)
                # the sum's order differs from the plain version's atomics:
                # each output against TOL of its terms' magnitudes (a pole
                # hub's ~2,000-term sum cancels far below them)
                scale = plain(arg.abs()).float() + 1.0
                err = max_err(got, want)
                if not bool(((got.float() - want.float()).abs() <= TOL[dtype_name] * scale).all()):
                    fail(f"{name}: kernel disagrees with plain beyond TOL of its terms' "
                         f"magnitudes (max abs err {err})")
                if not torch.equal(bits(got), bits(run(arg))):
                    fail(f"{name}: two launches differ")
                del got, want, scale
                tag = "none" if kernel == "sorted_segment_sum" else ""
                nbytes, ops = main_shape_bytes(kernel, tag, e_pad, e_valid, n, F,
                                               arg.element_size())
                b_ms, b_by = bound(nbytes, ops, dtype_name)
                if kernel == "sorted_segment_sum":
                    lib = library_call(kernel, tag, arg, ids, n, e_valid, None)
                else:
                    lib = library_call(kernel, tag, None, ids, n, e_valid, arg)
                rec = {"kernel": kernel, "case": name, "dtype": dtype_name, "relation": rel,
                       "E": e_pad, "E_valid": e_valid, "N": n, "F": F,
                       "edges_a_row_max": int(deg.max()), "hub_rows": hubs,
                       "edges_a_row_mean": e_valid / max(int((deg > 0).sum()), 1),
                       "max_abs_err": err, "ms": time_ms(lambda: run(arg)),
                       "plain_ms": time_ms(lambda: plain(arg), reps=5, warmup=1),
                       "library_ms": None if lib is None else time_ms(lib),
                       "bound_ms": b_ms, "bound_by": b_by}
                records.append(rec)
                log(f"{name}: E={e_pad} N={n} (rows of up to {rec['edges_a_row_max']} edges, "
                    f"{rec['edges_a_row_mean']:.2f} a non-empty row, {hubs} hub rows) err "
                    f"{err:.3g} kernel "
                    f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms library "
                    f"{rec['library_ms']} ms bound {b_ms:.4f} ms ({b_by})")
                del arg
            del exact, table
    return records


def graphcast_step0_vs_cpu() -> dict:
    """Step 0 of the CLI's training at GC_SMALL on the card and on the CPU
    plain path (the same seeded weights and sample 0): the loss within
    GRAD_TOL of its magnitude and every gradient within GRAD_TOL
    (:func:`check_grads`). A control, the CPU step with kernel 2's plain
    version leaving out the last edge of its longest row in every call
    (:func:`dropped_row_edge`), must miss that limit."""
    from dgraph_tpu_torch.train import graphcast as gc_cli

    cfg = graphcast_config(**GC_SMALL, steps=1, world_size=1, log_path="")
    out = {}
    for device in ("cuda", "cpu"):
        t = gc_cli.build_graphcast(cfg, device=device)
        t0 = time.perf_counter()
        loss = float(t.train_step(*t.batch(0)).loss)
        out[device] = (loss, grads_of(t.model), time.perf_counter() - t0)
        if device == "cpu":
            t.restart()
            with dropped_row_edge() as dropped:
                t.train_step(*t.batch(0))
            control = grad_margins(grads_of(t.model), out["cpu"][1])
        del t
    (loss_gpu, grads_gpu, _), (loss_cpu, grads_cpu, cpu_s) = out["cuda"], out["cpu"]
    if abs(loss_gpu - loss_cpu) > GRAD_TOL * max(1.0, abs(loss_cpu)):
        fail(f"graphcast small: step-0 loss {loss_gpu} vs CPU {loss_cpu}")
    leaves = {}
    err = check_grads("graphcast small", grads_gpu, grads_cpu, leaves=leaves)
    sound = max(m["margin"] for m in leaves.values())
    ctl = max(m["margin"] for m in control.values())
    if not ctl > 1.0:
        fail(f"graphcast small: the control (kernel 2 leaving out one edge a call, {dropped}) "
             f"passes GRAD_TOL: margin {ctl}")
    log(f"graphcast small {GC_SMALL}: step-0 loss {loss_gpu:.6f} (CPU {loss_cpu:.6f}); grads "
        f"vs the CPU max abs err {err:.3g}, margin {sound:.3g} of GRAD_TOL; the control "
        f"(kernel 2 leaving out one edge a call) margin {ctl:.3g} (CPU step {cpu_s:.1f} s)")
    return {"config": GC_SMALL, "loss": loss_gpu, "loss_cpu": loss_cpu, "grad_max_abs_err": err,
            "margin": sound, "control_margin": ctl, "control": dropped, "cpu_step_s": cpu_s}


@contextlib.contextmanager
def dropped_row_edge():
    """The CPU plain path with a fault: kernel 2's plain version
    (``sorted_segment_sum_plain``) leaves out the last edge of its longest
    row in every call, as a kernel that lost one edge would. Yields a dict
    that counts the calls it changed."""
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    plain = seg.sorted_segment_sum_plain
    dropped = {"calls": 0}

    def faulty(data, ids, n, *, input_op="none"):
        out = plain(data, ids, n, input_op=input_op)
        row_ptr = seg._row_ptr(ids, n)
        row = int(torch.argmax(row_ptr.diff()))
        last = int(row_ptr[row + 1]) - 1
        m = torch.relu(data[last]) if input_op == "relu" else data[last]
        out = out.clone()
        out[row] = (out[row].float() - m.float()).to(out.dtype)
        dropped["calls"] += 1
        return out

    seg.sorted_segment_sum_plain = faulty
    try:
        yield dropped
    finally:
        seg.sorted_segment_sum_plain = plain


def graphcast_main_path() -> tuple:
    """The main path, f32: ``python -m dgraph_tpu_torch.train.graphcast``'s
    ``main`` at GC_MAIN (--warmup_steps 4), GC_WARMUP + GC_TIMED steps, each
    launching exactly what :func:`graphcast_want` derives (kernel 2 only;
    no kernel 1, 1a, 3 or 4), the loss falling (the mean of the last 4
    below the mean of the first 4); the graphs' anchors (GC_ANCHORS); the
    peak device memory; then GC_PROF more steps under torch.profiler (the
    device-busy share, the top kernels). Returns (the training, record)."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.ops import segment as seg
    from dgraph_tpu_torch.train import graphcast as gc_cli
    from dgraph_tpu_torch.train.profile import device_ops

    steps = GC_WARMUP + GC_TIMED
    cfg = graphcast_config(**GC_MAIN, steps=steps, warmup_steps=4, world_size=1)
    what = "graphcast_l6 f32"
    want = graphcast_want(GC_MAIN["processor_layers"], GC_MAIN["latent"])
    if os.path.exists(cfg.log_path):
        os.remove(cfg.log_path)
    kernels.reset_launch_counts()
    seg.csr_offsets.computed = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr), LaunchesByShape() as by_shape:
        res = gc_cli.main(cfg, on_step=GraphCastProbe(steps - 1))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t = res["training"]
    probes = res["on_step"]
    losses = graphcast_steps_check(what, probes, want)
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        fail(f"{what}: the loss did not fall: {losses}")
    g = t.graphs
    got = {"mesh_vertices": g.num_mesh, "mesh_edges": int(g.mesh_plan.num_edges.sum()),
           "g2m_edges": int(g.g2m_plan.num_edges.sum()),
           "m2g_edges": int(g.m2g_plan.num_edges.sum())}
    if got != GC_ANCHORS:
        fail(f"{what}: the graphs' anchors {got}, want {GC_ANCHORS}")
    plans = {rel: {"E": int(getattr(g, f"{rel}_plan").num_edges.sum()),
                   "e_pad": getattr(g, f"{rel}_plan").e_pad,
                   "n_src_pad": getattr(g, f"{rel}_plan").n_src_pad,
                   "n_dst_pad": getattr(g, f"{rel}_plan").n_dst_pad,
                   "s_pad": getattr(g, f"{rel}_plan").halo.s_pad} for rel in ("mesh", "g2m", "m2g")}
    # a step's sample: laid out on the host and moved to the card, before
    # the step's clock starts
    td = time.perf_counter()
    x, y = t.batch(0)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - td
    ms = res["step_ms"]
    timed = ms[GC_WARMUP:]
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        tp = time.perf_counter()
        for _ in range(GC_PROF):
            t.train_step(x, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tp) * 1e3 / GC_PROF
    ops = device_ops(prof, GC_PROF)
    busy = sum(o["device_ms_per_step"] for o in ops)
    kernels.reset_launch_counts()
    rec = {"config": what, "cfg": GC_MAIN, "steps": steps, "graph_build_s": res["graph_build_s"],
           "dataset_s": t.dataset_s,
           "anchors": got, "plans": plans, "losses": losses, "step_ms": ms,
           "step_ms_p50": float(np.percentile(timed, 50)),
           "step_ms_p99": float(np.percentile(timed, 99)),
           "launches_per_step": want,
           "launches": {k: sum(p["counts"][k] for p in probes) for k in probes[0]["counts"]},
           "launches_by_shape": by_shape.counts, "peak_memory_bytes": peak,
           "sample_shard_s": shard_s, "run_s": run_s,
           "records": res["records"],
           "profile": {"steps": GC_PROF, "wall_ms_per_step": wall, "device_ms_per_step": busy,
                       "device_busy_share": busy / wall, "top": ops[:5]}}
    log(f"{what}: graphs {res['graph_build_s']:.1f} s, weather {t.dataset_s:.1f} s, anchors "
        f"{got}; plans {plans}; step ms "
        f"p50 {rec['step_ms_p50']:.1f} p99 {rec['step_ms_p99']:.1f} (steps "
        f"{GC_WARMUP}-{steps - 1}, host clock); loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
        f"memory {peak / 2**30:.2f} GiB; kernel 2 {want['sorted_segment_sum']} a step "
        f"(hub route on {rec['launches']['sorted_segment_sum.hub_calls']} of "
        f"{rec['launches']['sorted_segment_sum']} calls); a step's sample laid out and moved in "
        f"{shard_s:.2f} s; "
        f"device busy {busy / wall:.1%} ({busy:.1f} of {wall:.1f} ms a step, {GC_PROF} steps "
        f"profiled); run {run_s:.1f} s")
    for o in ops[:5]:
        log(f"  {o['device_ms_per_step']:9.3f} ms/step  x{o['count']:<5d} {o['name'][:80]}")
    return t, rec


def graphcast_bf16_turn(t, f32_loss0: float) -> dict:
    """The main path again under DGRAPH_TPU_COMPUTE_DTYPE=bfloat16 on the
    same graphs, data and seeded weights (``t.restart()``): the f32 run's
    launches every step, step 0's loss within BF16_LOSS_TOL relative of the
    f32 run's, every loss finite, the step times."""
    import numpy as np
    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.ops import segment as seg

    what = "graphcast_l6 bf16"
    want = graphcast_want(GC_MAIN["processor_layers"], GC_MAIN["latent"])
    config.set_flags(default_compute_dtype="bfloat16")
    try:
        t.restart()
        kernels.reset_launch_counts()
        seg.csr_offsets.computed = 0
        probe, probes, ms = GraphCastProbe(-1), [], []
        for i in range(GC_WARMUP + GC_BF16_TIMED):
            x, y = t.batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sm = t.train_step(x, y)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            probes.append(probe(i, t, sm))
    finally:
        config.set_flags(default_compute_dtype="float32")
    losses = graphcast_steps_check(what, probes, want)
    rel = abs(losses[0] - f32_loss0) / abs(f32_loss0)
    if not rel <= BF16_LOSS_TOL:
        fail(f"{what}: step-0 loss {losses[0]} vs the f32 run's {f32_loss0} ({rel:.3g} relative, "
             f"limit {BF16_LOSS_TOL})")
    timed = ms[GC_WARMUP:]
    rec = {"config": what, "losses": losses, "step_ms": ms,
           "step_ms_p50": float(np.percentile(timed, 50)),
           "step_ms_p99": float(np.percentile(timed, 99)), "step0_rel_to_f32": rel,
           "launches": {k: sum(p["counts"][k] for p in probes) for k in probes[0]["counts"]}}
    log(f"{what}: step-0 loss {losses[0]:.5f} vs f32 {f32_loss0:.5f} ({rel:.3g} relative, "
        f"limit {BF16_LOSS_TOL}); the f32 launches every step; step ms p50 "
        f"{rec['step_ms_p50']:.1f} p99 {rec['step_ms_p99']:.1f} (steps {GC_WARMUP}-"
        f"{len(ms) - 1})")
    return rec


def graphcast_rollout(t) -> dict:
    """``--eval_rollout GC_ROLLOUT`` at full width (``train.graphcast.eval_rollout``),
    f32, with the sorted-row-gather kernel on (DGRAPH_TPU_PALLAS_GATHER=1):
    forward launches only, exactly two tracks x GC_ROLLOUT steps of one
    forward's (kernel 2 the node sums, kernel 3 the dst-side takes), and a
    finite RMSE a step for the raw and the EMA tracks."""
    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.train import graphcast as gc_cli

    config.use_pallas_gather = True
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with LaunchesByShape() as by_shape:
            recs = gc_cli.eval_rollout(t, GC_ROLLOUT)
        run_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        config.use_pallas_gather = None
    tracks = len(recs)
    per = graphcast_want(GC_MAIN["processor_layers"], GC_MAIN["latent"], gather=True,
                         train=False)
    check_exact_launches("graphcast_l6 rollout", "all", counts,
                         {k: v * tracks * GC_ROLLOUT for k, v in per.items()})
    if tracks != 2 or not all(math.isfinite(r) for rec in recs for r in rec["rmse_per_step"]):
        fail(f"graphcast_l6 rollout: {recs}")
    log(f"graphcast_l6 --eval_rollout {GC_ROLLOUT} (gather kernel on): {recs}; launches "
        f"{dict((k, v) for k, v in counts.items() if v)}; {run_s:.1f} s")
    return {"records": recs, "launches": counts, "launches_by_shape": by_shape.counts,
            "run_s": run_s}


def graphcast_w4() -> tuple:
    """GraphCast at the experiment's defaults over GC_W4 ranks through the
    CLI, GC_W4_STEPS steps (GC_W4_STEPS_NCCL on a host of GC_W4 cards, a
    card a rank): the default lowering (its last step also runs
    the CLI's microbenchmark), then DGRAPH_TPU_HALO_IMPL=pallas_p2p (kernel
    5 moves every relation's src-side halo, the g2m relation's the grid
    rows: three exchanges a block a step, forward, recompute and reverse).
    Each: every plan resolved the lowering, the launches derived, step 0's
    loss within GC_W4_TOL relative of one rank's on the card (the same
    seeded weights and sample 0), the ranks' parameters bit-equal after the
    last step."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.train import graphcast as gc_cli

    four = torch.cuda.device_count() >= GC_W4
    base = graphcast_config(steps=GC_W4_STEPS_NCCL if four else GC_W4_STEPS, world_size=1)
    layers, latent = base.processor_layers, base.latent

    def one_rank_loss():
        t1 = gc_cli.build_graphcast(base)
        return float(t1.train_step(*t1.batch(0)).loss)

    out = []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # one rank's step 0 in this process, while the first run's ranks start
        base_loss = pool.submit(one_rank_loss)
        for impl in ("all_to_all", "pallas_p2p"):
            what = f"graphcast W={GC_W4} {impl}"
            cfg = dataclasses.replace(base, world_size=GC_W4)
            want = graphcast_want(layers, latent, p2p=impl == "pallas_p2p")
            t0 = time.perf_counter()
            env = halo_impl_env(impl) if impl != "all_to_all" else contextlib.nullcontext()
            p2p_rel = GC_P2P_REL if impl == "pallas_p2p" else ""
            with env, contextlib.redirect_stdout(sys.stderr):
                res = gc_cli.main(cfg, on_step=GraphCastProbe(cfg.steps - 1,
                                                              micro=impl == "all_to_all",
                                                              p2p_rel=p2p_rel))
            run_s = time.perf_counter() - t0
            ranks = [r["on_step"] for r in res["ranks"]]
            for r, probes in enumerate(ranks):
                if set(probes[0]["impl"].values()) != {impl}:
                    fail(f"{what}: rank {r}'s plans resolved {probes[0]['impl']}")
                graphcast_steps_check(f"{what} rank {r}", probes, want)
            loss0 = ranks[0][0]["loss"]
            loss1 = base_loss.result()
            rel = abs(loss0 - loss1) / abs(loss1)
            if not rel <= GC_W4_TOL:
                fail(f"{what}: step-0 loss {loss0} vs one rank's {loss1} ({rel:.3g} relative)")
            last = [probes[-1]["params"] for probes in ranks]
            for r in range(1, GC_W4):
                for k, v in last[0].items():
                    if not np.array_equal(last[r][k], v):
                        fail(f"{what}: rank {r}'s {k} differs from rank 0's after the last step")
            ms = [r["step_ms"] for r in res["ranks"]]
            rec = {"config": what, "impl": impl, "losses": res["losses"], "loss_w1": loss1,
                   "backend": "nccl" if four else "gloo", "step0_rel": rel, "step_ms": ms,
                   "step_ms_p50": [float(np.percentile(m[1:], 50)) for m in ms],
                   "launches_per_step": want,
                   "launches": {k: sum(p["counts"][k] for probes in ranks for p in probes)
                                for k in want},
                   "pads": ranks[0][0]["pads"], "run_s": run_s,
                   "microbenchmark": [probes[-1].get("microbenchmark") for probes in ranks]}
            if p2p_rel:
                # kernel 5 at the relation's exchange, timed after the run, and
                # the run's launches at each shape, summed over the ranks
                failures = [f for probes in ranks for f in probes[-1]["p2p_failures"]]
                if failures:
                    fail(f"{what}: kernel 5 at the {p2p_rel} exchange: {failures[:5]}")
                rec["p2p_records"] = [merged_p2p_record([probes[-1]["p2p_records"][i]
                                                         for probes in ranks])
                                      for i in range(len(ranks[0][-1]["p2p_records"]))]
                by_shape = {}
                for probes in ranks:
                    for k, v in probes[-1]["by_shape"].items():
                        by_shape[k] = by_shape.get(k, 0) + v
                rec["launches_by_shape"] = by_shape
            out.append(rec)
            log(f"{what}: every plan resolved {impl!r}; step-0 loss {loss0:.6f} vs one rank's "
                f"{loss1:.6f} ({rel:.3g} relative, limit {GC_W4_TOL}); launches a step a rank "
                f"{dict((k, v) for k, v in want.items() if v)}; parameters bit-equal across "
                f"ranks; step ms per rank {[[round(x, 1) for x in m] for m in ms]} (p50 of steps "
                f"1- {[round(x, 1) for x in rec['step_ms_p50']]}, {rec['backend']}); run "
                f"{run_s:.1f} s; rank 0's halo pads {rec['pads']}")
            if rec["microbenchmark"][0] is not None:
                log(f"{what}: --microbenchmark on the mesh plan, per rank: "
                    f"{[{k: round(v, 3) for k, v in m.items()} for m in rec['microbenchmark']]}")
    return out


def graphcast_halo_l6_w4() -> dict:
    """The main path's graphs partitioned for GC_W4 ranks (host only, the
    CLI's partitions: multilevel mesh, latitude-band grid): each relation's
    send pad S against the src side's padded rows a rank, per live delta.
    The grid's bands and the mesh's parts do not line up, so g2m's halo is
    nearly the whole grid shard."""
    from dgraph_tpu_torch.models.graphcast import build_graphcast_graphs

    t0 = time.perf_counter()
    g = build_graphcast_graphs(GC_MAIN["mesh_level"], GC_MAIN["num_lat"], GC_MAIN["num_lon"],
                               GC_W4)
    out = {"build_s": time.perf_counter() - t0}
    for rel in ("mesh", "g2m", "m2g"):
        plan = getattr(g, f"{rel}_plan")
        out[rel] = {"s_pad": plan.halo.s_pad, "n_src_pad": plan.n_src_pad,
                    "deltas": plan.halo_deltas,
                    "s_over_n_src": plan.halo.s_pad / plan.n_src_pad,
                    "bytes_an_exchange_f32": len(plan.halo_deltas) * plan.halo.s_pad
                    * GC_MAIN["latent"] * 4}
    return out


def graphcast_phase(cfg) -> tuple:
    """Phase 14, in the form of :func:`one_rank_phases`: GraphCast through
    ``python -m dgraph_tpu_torch.train.graphcast`` at bench_graphcast's
    level-6 width (f32, then bf16, then a rollout with the gather kernel),
    kernels 2 and 3 at its three relations' shapes, step 0 against the CPU
    at a small depth, then over GC_W4 ranks at the experiment's defaults."""
    import torch

    log("phase 14: GraphCast (python -m dgraph_tpu_torch.train.graphcast) at level 6, "
        "721x1440, 73 channels, latent 256, 16 layers: f32, bf16, --eval_rollout; kernels 2 "
        "and 3 at its shapes; step 0 vs the CPU; then 4 ranks at level 4")
    t, main_rec = graphcast_main_path()
    bf16 = graphcast_bf16_turn(t, main_rec["losses"][0])
    roll = graphcast_rollout(t)
    records = graphcast_kernel_cases(t)
    del t
    torch.cuda.empty_cache()
    small = graphcast_step0_vs_cpu()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the level-6 W = 4 partition's halo, on the host while the W = 4
        # runs' ranks work (no time of the card is read there)
        halo = pool.submit(graphcast_halo_l6_w4)
        w4 = graphcast_w4()
        halo = halo.result()
    log(f"graphcast level 6 at W={GC_W4} (host, {halo['build_s']:.1f} s): S against the src "
        f"side's rows a rank, per delta: " + "; ".join(
            f"{rel} {h['s_pad']} of {h['n_src_pad']} ({h['s_over_n_src']:.1%}), deltas "
            f"{h['deltas']}, {h['bytes_an_exchange_f32'] / 1e6:.1f} MB an f32 exchange"
            for rel, h in halo.items() if rel != "build_s"))
    p2p = next(r for r in w4 if r["impl"] == "pallas_p2p")
    records += p2p["p2p_records"]
    # the kernels line: kernels 2 and 3 at each relation's dst-side shape
    # (f32; F = 256, the node sums, and F = 128, a feature chunk), each with
    # the launches counted at that shape in the main path's run (kernel 2)
    # and the rollout's (kernel 3); kernel 5 at the g2m exchange and its
    # reverse, with the launches counted at that shape in the W = 4 run
    main_case = {}
    for kernel, counts in (("sorted_segment_sum", main_rec["launches_by_shape"]),
                           ("sorted_row_gather", roll["launches_by_shape"])):
        for rec in records:
            if rec.get("kernel") != kernel or rec.get("relation") is None \
                    or rec["dtype"] != "float32":
                continue
            n = counts.get(shape_key(kernel, rec["E"], rec["N"], rec["F"], "float32"), 0)
            if n:
                main_case.setdefault(kernel, []).append(
                    (rec["case"], {kernel: n}, f"graphcast_{rec['relation']}_f{rec['F']}"))
    for rec in p2p["p2p_records"]:
        n = p2p["launches_by_shape"].get(p2p_shape_key("p2p_transport", rec["S"], rec["F"],
                                                       "float32", rec["sign"]), 0)
        main_case.setdefault("p2p_transport", []).append(
            (rec["case"], {"p2p_transport": n},
             f"graphcast_w4_{GC_P2P_REL}" + ("" if rec["sign"] == 1 else "_reverse")))
    for what, counts in (("graphcast_l6 f32", main_rec["launches_by_shape"]),
                         ("graphcast_l6 rollout", roll["launches_by_shape"]),
                         (p2p["config"], p2p["launches_by_shape"])):
        log(f"{what}: launches at each shape {counts}")
    return records, main_case, {"train": [main_rec, bf16, *w4],
                                "graphcast": {"rollout": roll, "step0_vs_cpu": small,
                                              "halo_l6_w4": halo}}


# --- phase 15 ----------------------------------------------------------------


# GraphCast over R = 2 replica groups of W = 2 graph ranks: bench_graphcast's
# width (73 channels, latent 256) on the experiment's level-4 181x360 grid,
# its depth cut from 16 to 4 processor layers so that four ranks sharing one
# card train both lowerings' steps inside the whole run's time limit
GC_R = dict(mesh_level=4, num_lat=181, num_lon=360, channels=73, latent=256,
            processor_layers=4)
GC_R_SHAPE = (2, 2)  # (replica groups R, graph ranks W)
GC_R_STEPS, GC_R_STEPS_NCCL = 2, 12  # steps a run: one card; a card a rank
GC_R_GRAD_TOL = 1e-5  # the synced gradient vs the one-rank mean, of each leaf's magnitude
GC_R_ALLREDUCE_REPS = 5  # timed calls of the gradient all-reduce a run
GC_R_KERNEL_REL = "mesh"  # kernel 2 timed at this relation's node sum (F = latent)


class ReplicaProbe(GraphCastProbe):
    """:class:`GraphCastProbe` on a replica run: also, at step 0, the graph
    group's own loss, the sample it trained on and (global rank 0) the
    synced gradients and rank 0's plan ids of GC_R_KERNEL_REL; at the last
    step the gradient all-reduce (``collectives.grad_sync`` over every
    rank) timed GC_R_ALLREDUCE_REPS times, every rank together, after the
    parameters are read."""

    def __call__(self, step, t, sm):
        import torch

        from dgraph_tpu_torch.comm import collectives

        out = super().__call__(step, t, sm)
        if step == 0:
            out.update(group_loss=float(t.group_loss), sample=t.sample_index(0))
            if t.global_rank == 0:
                out["grads"] = {k: p.grad.detach().cpu().numpy().copy()
                                for k, p in t.model.named_parameters()}
                plan = t.plans[GC_R_KERNEL_REL]
                out["kernel_plan"] = (plan.dst_index.cpu(), plan.n_dst_pad)
        if step == self.last:
            group, params = t.comm.group, list(t.model.parameters())
            sync = (lambda: torch.cuda.synchronize(group.device)) \
                if group.device.type == "cuda" else (lambda: None)
            ms = []
            for _ in range(GC_R_ALLREDUCE_REPS + 1):
                group.world_barrier()
                sync()
                t0 = time.perf_counter()
                collectives.grad_sync(params, group, prescaled=True)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            out["allreduce_ms"] = ms[1:]
            out["grad_elements"] = sum(p.numel() for p in params)
        return out


def replica_one_rank(base, samples: list) -> list:
    """One rank on the card (this process) at ``base``: for each sample, from
    the seeded weights, step 0's loss and gradients (``restart()`` between)."""
    import torch

    from dgraph_tpu_torch.train import graphcast as gc_cli

    t = gc_cli.build_graphcast(base)
    out = []
    for s in samples:
        t.restart()
        x, y = t.dataset.get_sharded(s)
        loss = float(t.train_step(torch.from_numpy(x[0]).to(t.device),
                                  torch.from_numpy(y[0]).to(t.device)).loss)
        out.append((loss, {k: p.grad.detach().cpu().numpy().copy()
                           for k, p in t.model.named_parameters()}))
    del t
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def replica_run(what, cfg, R: int, impl: str) -> tuple:
    """``train.graphcast``'s rank function on R replica groups of
    ``cfg.world_size`` ranks under ``impl`` with a :class:`ReplicaProbe`:
    (every rank's result, the run's seconds)."""
    from dgraph_tpu_torch.comm.dist import launch
    from dgraph_tpu_torch.train import graphcast as gc_cli

    env = halo_impl_env(impl) if impl != "all_to_all" else contextlib.nullcontext()
    t0 = time.perf_counter()
    with env, contextlib.redirect_stdout(sys.stderr):
        ranks = launch(gc_cli._train_rank, cfg.world_size, dataclasses.asdict(cfg),
                       ReplicaProbe(cfg.steps - 1, p2p_rel=GC_P2P_REL if impl == "pallas_p2p"
                                    else "", shapes=True),
                       num_replicas=R, device=cfg.device or "cuda", timeout=600,
                       threads=1 if cfg.device == "cpu" else 0)
    return ranks, time.perf_counter() - t0


def replica_checks(what, ranks, want, one_rank, W) -> dict:
    """Checks (a)-(d) of phase 15 on one run (see the module docstring);
    the run's record."""
    import numpy as np

    probes = [r["on_step"] for r in ranks]
    for g, p in enumerate(probes):
        graphcast_steps_check(f"{what} rank {g}", p, want)
    samples = [probes[rep * W][0]["sample"] for rep in range(len(probes) // W)]
    if len(set(samples)) != len(samples):
        fail(f"{what}: the replica groups trained on one sample: {samples}")
    rels = []
    for g, p in enumerate(probes):
        rep = g // W
        if p[0]["sample"] != samples[rep]:
            fail(f"{what}: rank {g} trained on sample {p[0]['sample']}, its group on "
                 f"{samples[rep]}")
        loss1 = one_rank[rep][0]
        rel = abs(p[0]["group_loss"] - loss1) / abs(loss1)
        if not rel <= GC_W4_TOL:
            fail(f"{what}: replica {rep}'s step-0 loss {p[0]['group_loss']} vs one rank's "
                 f"{loss1} on sample {samples[rep]} ({rel:.3g} relative, limit {GC_W4_TOL})")
        rels.append(rel)
    mean = {k: np.mean([g[k] for _, g in one_rank], axis=0) for k in one_rank[0][1]}
    got = probes[0][0]["grads"]
    grad_rel = {}
    for k, w in mean.items():
        scale = float(np.abs(w).max()) or 1.0
        grad_rel[k] = float(np.abs(got[k] - w).max()) / scale
    worst = max(grad_rel, key=grad_rel.get)
    if not grad_rel[worst] <= GC_R_GRAD_TOL:
        fail(f"{what}: global rank 0's synced gradient {worst} is {grad_rel[worst]:.3g} of its "
             f"magnitude from the mean of the one-rank gradients (limit {GC_R_GRAD_TOL})")
    last = [p[-1]["params"] for p in probes]
    for g in range(1, len(last)):
        for k, v in last[0].items():
            if not np.array_equal(last[g][k], v):
                fail(f"{what}: rank {g}'s {k} differs from rank 0's after the last step")
    ms = [r["step_ms"] for r in ranks]
    allreduce = [p[-1]["allreduce_ms"] for p in probes]
    return {"config": what, "samples": samples, "losses": ranks[0]["losses"],
            "group_losses": [p[0]["group_loss"] for p in probes[::W]],
            "loss_one_rank": [loss for loss, _ in one_rank], "step0_rel": rels,
            "grad_rel_max": grad_rel[worst], "grad_rel_worst_leaf": worst, "step_ms": ms,
            "step_ms_p50": [float(np.percentile(m[1:], 50)) for m in ms],
            "allreduce_ms_p50": [float(np.percentile(a, 50)) for a in allreduce],
            "grad_elements": probes[0][-1]["grad_elements"],
            "launches_per_step": want,
            "launches": {k: sum(p["counts"][k] for ps in probes for p in ps) for k in want},
            "impl": probes[0][0]["impl"]}


def replica_phase(cfg) -> tuple:
    """Phase 15, in the form of :func:`one_rank_phases`: GraphCast at GC_R
    over R x W = GC_R_SHAPE ranks under the default lowering and
    pallas_p2p, each held by checks (a)-(d) (see the module docstring);
    kernel 2 at the replica path's node-sum shape and kernel 5 at a replica
    group's g2m exchange; on a host of four cards R = 1 x W = 4 beside it
    under all_to_all."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.train.sampler import ReplicaSampler

    R, W = GC_R_SHAPE
    four = torch.cuda.device_count() >= R * W
    steps = GC_R_STEPS_NCCL if four else GC_R_STEPS
    where = "NCCL, a card a rank" if four else "gloo, one card"
    log(f"phase 15: replicas: GraphCast at level 4, 181x360, 73 channels, latent 256, 4 layers "
        f"over R = {R} replica groups of W = {W} ranks ({where}), under all_to_all and "
        f"pallas_p2p, {steps} steps each")
    base = graphcast_config(**GC_R, steps=steps, world_size=1, ema_decay=0.0, log_path="")
    cfg_r = dataclasses.replace(base, world_size=W)
    # the samples the replica groups train on at step 0: the dataset's 8
    samples = ReplicaSampler(8, R, seed=0).indices(0)
    layers, latent = GC_R["processor_layers"], GC_R["latent"]
    recs, runs = [], {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # one rank's step 0 on each sample, in this process, while the ranks start
        one = pool.submit(replica_one_rank, base, samples)
        for impl in ("all_to_all", "pallas_p2p"):
            what = f"graphcast R={R} W={W} {impl}"
            ranks, run_s = replica_run(what, cfg_r, R, impl)
            want = graphcast_want(layers, latent, p2p=impl == "pallas_p2p")
            one_rank = one.result()
            rec = replica_checks(what, ranks, want, one_rank, W)
            if set(rec["impl"].values()) != {impl}:
                fail(f"{what}: rank 0's plans resolved {rec['impl']}")
            rec.update(run_s=run_s, backend="nccl" if four else "gloo")
            runs[impl] = ranks
            recs.append(rec)
            log(f"{what}: samples {rec['samples']}; step-0 loss of each replica group "
                f"{[round(x, 6) for x in rec['group_losses']]} vs one rank's "
                f"{[round(x, 6) for x in rec['loss_one_rank']]} ({max(rec['step0_rel']):.3g} "
                f"relative at most, limit {GC_W4_TOL}); global rank 0's synced gradient vs the "
                f"one-rank mean {rec['grad_rel_max']:.3g} of {rec['grad_rel_worst_leaf']}'s "
                f"magnitude (limit {GC_R_GRAD_TOL}); parameters bit-equal over the "
                f"{R * W} ranks; launches a step a rank "
                f"{dict((k, v) for k, v in want.items() if v)}; step ms per rank "
                f"{[[round(x, 1) for x in m] for m in rec['step_ms']]}; the gradient "
                f"all-reduce ({rec['grad_elements']} f32 over {R * W} ranks) p50 per rank "
                f"{[round(x, 2) for x in rec['allreduce_ms_p50']]} ms; run {run_s:.1f} s "
                f"[{rec['backend']}]")
        if four:
            # R = 1 x W = 4 on the same configuration, a card a rank
            what = f"graphcast R=1 W={R * W} all_to_all"
            flat, run_s = replica_run(what, dataclasses.replace(base, world_size=R * W), 1,
                                      "all_to_all")
            ms = [r["step_ms"] for r in flat]
            ar = [r["on_step"][-1]["allreduce_ms"] for r in flat]
            recs.append({"config": what, "losses": flat[0]["losses"], "step_ms": ms,
                         "step_ms_p50": [float(np.percentile(m[1:], 50)) for m in ms],
                         "allreduce_ms_p50": [float(np.percentile(a, 50)) for a in ar],
                         "run_s": run_s, "backend": "nccl"})
            two = recs[0]
            log(f"four cards, all_to_all: a step's p50 a rank (steps 1-{steps - 1}) R={R} "
                f"W={W} {[round(x, 1) for x in two['step_ms_p50']]} ms, R=1 W={R * W} "
                f"{[round(x, 1) for x in recs[-1]['step_ms_p50']]} ms; the gradient "
                f"all-reduce p50 {[round(x, 2) for x in two['allreduce_ms_p50']]} ms against "
                f"{[round(x, 2) for x in recs[-1]['allreduce_ms_p50']]} ms; run {run_s:.1f} s")
    # kernel 2 at the replica path's node-sum shape (rank 0's plan), f32, F = latent
    ids, n = runs["all_to_all"][0]["on_step"][0]["kernel_plan"]
    plan = types.SimpleNamespace(dst_index=ids.to("cuda"), n_dst_pad=n)
    records = graphcast_kernel_cases(types.SimpleNamespace(plans={GC_R_KERNEL_REL: plan},
                                                           device=torch.device("cuda")),
                                     relations=(GC_R_KERNEL_REL,), widths=(latent,),
                                     dtypes=("float32",), kernels=("sorted_segment_sum",),
                                     label=f"graphcast r{R}w{W}")
    p2p_ranks = [r["on_step"] for r in runs["pallas_p2p"]][:W]
    failures = [f for probes in p2p_ranks for f in probes[-1]["p2p_failures"]]
    if failures:
        fail(f"graphcast R={R} W={W} pallas_p2p: kernel 5 at the {GC_P2P_REL} exchange: "
             f"{failures[:5]}")
    p2p_recs = [merged_p2p_record([probes[-1]["p2p_records"][i] for probes in p2p_ranks])
                for i in range(len(p2p_ranks[0][-1]["p2p_records"]))]
    records += p2p_recs

    def by_shape(impl):
        out = {}
        for r in runs[impl]:
            for k, v in r["on_step"][-1]["by_shape"].items():
                out[k] = out.get(k, 0) + v
        return out

    k2 = records[0]
    key2 = shape_key("sorted_segment_sum", k2["E"], k2["N"], k2["F"], "float32")
    main_case = {"sorted_segment_sum": [
        (k2["case"], {"sorted_segment_sum": sum(by_shape(i).get(key2, 0) for i in runs)},
         f"graphcast_r{R}w{W}_{GC_R_KERNEL_REL}_f{latent}")], "p2p_transport": []}
    p2p_shapes = by_shape("pallas_p2p")
    for rec in p2p_recs:
        n5 = p2p_shapes.get(p2p_shape_key("p2p_transport", rec["S"], rec["F"], "float32",
                                          rec["sign"]), 0)
        main_case["p2p_transport"].append(
            (rec["case"], {"p2p_transport": n5},
             f"graphcast_r{R}w{W}_{GC_P2P_REL}" + ("" if rec["sign"] == 1 else "_reverse")))
    for impl in runs:
        log(f"graphcast R={R} W={W} {impl}: launches at each shape {by_shape(impl)}")
    return records, main_case, {"train": recs}


# --- phase 16 ----------------------------------------------------------------


SERVE_W = 4
# (model, lowering) a turn of phase 16 serves, in the same rank processes:
# "auto" is the CLI's default (the unsplit plan: all_to_all). One card:
# GCN under the default and pallas_p2p (kernels 1 and 5), SAGE under the
# default (kernel 2); four cards: GCN under every lowering too
SERVE_W_TURNS = (("gcn", "auto"), ("gcn", "pallas_p2p"), ("sage", "auto"))
SERVE_W_TURNS_NCCL = SERVE_W_TURNS + tuple(
    ("gcn", impl) for impl in ("all_to_all", "ppermute", "overlap", "sched"))
# requests a GCN turn drives (two a bucket of 8..1024), a SAGE turn's; on
# four cards each forward takes milliseconds, not a host-staged half second
SERVE_W_REQUESTS = {"gcn": 16, "sage": 8}
SERVE_W_REQUESTS_NCCL = {"gcn": 64, "sage": 32}
SERVE_W_GROUP_TIMEOUT = 120.0  # s: a lost rank fails a request within it


def serve_w_want(cfg, model: str, split: bool, p2p: bool) -> dict:
    """Launches a forward of one rank, as the code derives them: GCN's
    fused kernel once a feature chunk and layer (twice on the split route,
    interior and boundary) and kernel 5 once a layer's exchange under
    pallas_p2p; SAGE's segment sums (:func:`sage_launches_per_forward`);
    nothing else (no backward kernel, the gather flag off)."""
    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.ops.kernels import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    if model == "gcn":
        chunks = cfg.num_layers * math.ceil(cfg.hidden / config.gather_col_block)
        want["sorted_segment_sum_bias_relu"] = chunks * (2 if split else 1)
    else:
        want["sorted_segment_sum"] = sage_launches_per_forward(cfg)
    want["p2p_transport"] = cfg.num_layers if p2p else 0
    return want


def serve_w_kernel_cases(group, graph, gen, model: str) -> list:
    """Kernel 1 (GCN: the weighted fused sum) or kernel 2 (SAGE: the plain
    sum) at this rank's serving shape (its unsplit plan's dst ids, F = 128,
    f32): bit patterns of two launches equal, within TOL of the plain
    version, each timed with CUDA events while the other ranks wait (the
    plain version and ``index_add_`` too), with its bound."""
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    dev = group.device
    plan = graph.plan.shard(group.rank).to(dev)
    ids, n, F = plan.dst_index, plan.n_dst_pad, 128
    e_pad, e_valid = ids.shape[0], int((ids < n).sum())
    data = torch.randn(e_pad, F, generator=gen, device=dev)
    bias = torch.randn(n, F, generator=gen, device=dev)
    if model == "gcn":
        kernel, tag, w = "sorted_segment_sum_bias_relu", "w", graph.edge_weight[group.rank].to(dev)
        run = lambda: seg.sorted_segment_sum_bias_relu(data, ids, bias, n, edge_weight=w)  # noqa: E731
        plain = lambda: seg.sorted_segment_sum_bias_relu_plain(  # noqa: E731
            data, ids, bias, n, edge_weight=w)
    else:
        kernel, tag = "sorted_segment_sum", "none"
        run = lambda: seg.sorted_segment_sum(data, ids, n)  # noqa: E731
        plain = lambda: seg.sorted_segment_sum_plain(data, ids, n)  # noqa: E731
    name = f"{kernel} float32 {tag} F={F} serve W={group.world_size}"
    got, want = run(), plain()
    torch.cuda.synchronize(dev)
    failures = []
    if not torch.equal(bits(got), bits(run())):
        failures.append(f"{name} rank {group.rank}: two launches differ")
    if not torch.allclose(got, want, rtol=TOL["float32"], atol=TOL["float32"]):
        failures.append(f"{name} rank {group.rank}: kernel != plain (max abs err "
                        f"{max_err(got, want)})")
    lib = library_call(kernel, tag, data, ids, n, e_valid, bias)
    nbytes, ops = main_shape_bytes(kernel, tag, e_pad, e_valid, n, F, 4)
    b_ms, b_by = bound(nbytes, ops)
    return [{"kernel": kernel, "case": name, "rank": group.rank, "E": e_pad,
             "E_valid": e_valid, "N": n, "F": F, "max_abs_err": max_err(got, want),
             "ms": in_turn(group, run), "plain_ms": in_turn(group, plain),
             "library_ms": None if lib is None else in_turn(group, lib),
             "bound_ms": b_ms, "bound_by": b_by, "failures": failures}]


def serve_w_rank(group, turns, requests: dict, t_launch: float) -> dict:
    """One of phase 16's ranks: each turn of ``turns`` pins its lowering,
    builds its engine through ``build_serving`` and, with every launch
    count set to 0 just before, serves: rank 0 warms every bucket, drives
    ``requests[model]`` requests through the batcher (latency a request),
    takes ``full_logits()``, checks the served rows against it bit for bit
    and stops the followers; ranks 1..W-1 follow. Then (not counted) the
    turn's kernel at this rank's shape: kernel 1 or 2 under the default
    lowering, kernel 5 at the exchange under pallas_p2p."""
    import numpy as np
    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.comm import DistComm
    from dgraph_tpu_torch.ops import kernels
    from dgraph_tpu_torch.serve.__main__ import build_serving

    start_s = time.time() - t_launch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=group.device).manual_seed(16 + group.rank)
    out = {"start_s": start_s, "turns": []}
    for model, impl in turns:
        config.halo_impl = impl
        cfg = dataclasses.replace(arxiv_config(model), world_size=group.world_size)
        t0 = time.perf_counter()
        engine, batcher, graph = build_serving(cfg, comm=DistComm(group))
        turn = {"model": model, "impl": impl, "halo_impl": engine.halo_impl,
                "build_s": time.perf_counter() - t0, "failures": []}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if batcher is None:
            turn["dispatches"] = engine.follow()
        else:
            try:
                turn["warmup_s"] = engine.warmup()["warmup_s"]
                rng, sizes = request_sizes(requests[model], engine.ladder, seed=1)
                served, lat = [], {}
                for n in sizes:
                    ids = rng.choice(engine.num_nodes, size=n, replace=False)
                    t = time.perf_counter()
                    served.append((ids, batcher.infer(ids)))
                    lat.setdefault(engine.ladder.bucket_for(n), []).append(
                        (time.perf_counter() - t) * 1e3)
                full = engine.full_logits()
            finally:
                batcher.stop()
                engine.stop()
            for ids, rows in served:
                r, s = engine.rank_slot(ids)
                if rows.shape != (len(ids), cfg.num_classes) or not np.array_equal(rows,
                                                                                  full[r, s]):
                    turn["failures"].append("served rows differ from full_logits()")
                    break
            turn["finite"] = bool(np.isfinite(full).all())
            turn["shape"] = full.shape
            r, s = engine.rank_slot(np.arange(engine.num_nodes))
            turn["logits"] = full[r, s]  # the original vertex numbering
            turn["requests"] = len(served)
            turn["buckets"] = {str(b): {"count": len(v), "p50_ms": float(np.percentile(v, 50)),
                                        "p99_ms": float(np.percentile(v, 99))}
                               for b, v in sorted(lat.items())}
        torch.cuda.synchronize(group.device)
        turn.update(serve_s=time.perf_counter() - t0, counts=kernels.launch_counts(),
                    forwards=engine.forwards, hub_rows=cached_hub_rows())
        group.barrier()
        if impl == "auto":
            turn["kernel_records"] = serve_w_kernel_cases(group, graph, gen, model)
        elif impl == "pallas_p2p":
            failures = []
            rec, _ = p2p_real_case(group, gen, w4_halo_arrays(graph.plan), cfg.hidden,
                                   "float32", 1, failures, tag=" serve")
            turn["kernel_records"] = [dict(rec, failures=failures)]
        del engine, batcher, graph
        torch.cuda.empty_cache()
        out["turns"].append(turn)
    config.halo_impl = "auto"
    return out


def serve_w_cpu_reference(models) -> dict:
    """Each model's logits on the CPU at one rank (plain path; the same
    seeded weights and graph), in the original vertex numbering."""
    import numpy as np

    from dgraph_tpu_torch.serve.__main__ import build_serving

    out = {}
    for model in models:
        t = time.perf_counter()
        engine, batcher, _ = build_serving(arxiv_config(model), device="cpu")
        batcher.stop()
        full = engine.full_logits()
        r, s = engine.rank_slot(np.arange(engine.num_nodes))
        out[model] = (full[r, s], time.perf_counter() - t)
    return out


def merged_rank_record(per_rank: list) -> dict:
    """One kernel-1 or kernel-2 record of phase 16 from every rank's: the
    times averaged over the ranks (each rank's kept), the largest error;
    logged."""
    import numpy as np

    rec = dict(per_rank[0], max_abs_err=max(r["max_abs_err"] for r in per_rank),
               **{f"{k}_per_rank": [r[k] for r in per_rank]
                  for k in ("ms", "plain_ms", "library_ms", "E", "N", "bound_ms")})
    for k in ("ms", "plain_ms", "bound_ms"):
        rec[k] = float(np.mean([r[k] for r in per_rank]))
    if rec["library_ms"] is not None:
        rec["library_ms"] = float(np.mean([r["library_ms"] for r in per_rank]))
    log(f"{rec['case']}: err {rec['max_abs_err']:.3g} kernel {rec['ms']:.4f} ms a rank "
        f"(in turn; per rank {[round(v, 4) for v in rec['ms_per_rank']]}, E "
        f"{rec['E_per_rank']}) plain {rec['plain_ms']:.3f} ms library {rec['library_ms']} ms "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def nvlink_rate() -> "float | None":
    """This card's NVLink bytes/s in one direction: the sum of its active
    links' speeds as ``nvidia-smi nvlink -s`` reports them (None without
    a link)."""
    import re

    try:
        text = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"], capture_output=True,
                              text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    rates = [float(x) for x in re.findall(r"Link \d+: ([\d.]+) GB/s", text)]
    log(f"nvidia-smi nvlink -s -i 0: {len(rates)} active links, {sum(rates):.3f} GB/s")
    return sum(rates) * 1e9 if rates else None


# kernel 5's earlier four-card shapes, whose NVLink bounds are logged
# beside the serving exchange's: (what, live tiles n, S, F, bytes an
# element) of the call a rank makes
KERNEL5_NVLINK_READINGS = (("W = 4 random-partition exchange f32 (phase 9)", 3, 41056, 256, 4),
                           ("W = 4 random-partition exchange bf16 (phase 9)", 3, 41056, 256, 2),
                           ("replica group g2m f32 (phase 15)", 1, 25520, 256, 4))


def serve_w_phase(cfg) -> tuple:
    """Phase 16, in the form of :func:`one_rank_phases`: GCN and GraphSAGE
    served over SERVE_W ranks at arxiv width (SERVE_W_TURNS; on four cards
    SERVE_W_TURNS_NCCL), each turn held to its checks (see the module
    docstring); kernels 1 and 2 at a rank's serving shape and kernel 5 at
    its exchange."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.comm.dist import launch

    four = torch.cuda.device_count() >= SERVE_W
    turns = SERVE_W_TURNS_NCCL if four else SERVE_W_TURNS
    requests = SERVE_W_REQUESTS_NCCL if four else SERVE_W_REQUESTS
    where = "NCCL, a card a rank" if four else "gloo, one card"
    log(f"phase 16: serve over {SERVE_W} ranks at arxiv width ({where}): "
        f"{', '.join(f'{m} {i}' for m, i in turns)}")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(serve_w_cpu_reference, sorted({m for m, _ in turns}))
        t_launch = time.time()
        t0 = time.perf_counter()
        ranks = launch(serve_w_rank, SERVE_W, turns, requests, t_launch, device="cuda",
                       timeout=900, group_timeout=SERVE_W_GROUP_TIMEOUT,
                       threads=max(1, (os.cpu_count() or 1) // SERVE_W))
        run_s = time.perf_counter() - t0
        cpu = cpu.result()
    log(f"serve W={SERVE_W}: {run_s:.1f} s with the spawn; the ranks started "
        f"{[round(r['start_s'], 2) for r in ranks]} s after the launch; the CPU references "
        f"{ {m: round(v[1], 1) for m, v in cpu.items()} } s beside")
    records, recs, launched = [], [], {}
    rate = nvlink_rate() if four else None
    for i, (model, impl) in enumerate(turns):
        what = f"serve {model} W={SERVE_W} {impl}"
        per_rank = [r["turns"][i] for r in ranks]
        front = per_rank[0]
        failures = [f for t in per_rank for f in t["failures"]]
        failures += [f for t in per_rank for k in t.get("kernel_records", [])
                     for f in k["failures"]]
        if failures:
            fail(f"{what}: {failures[:5]}")
        resolved = {t["halo_impl"] for t in per_rank}
        if impl != "auto" and resolved != {impl}:
            fail(f"{what}: the ranks resolved {resolved}")
        halo = resolved.pop()
        want = serve_w_want(arxiv_config(model), model, halo in ("overlap", "pallas_p2p"),
                            halo == "pallas_p2p")
        for r, t in enumerate(per_rank):
            if t["forwards"] != front["forwards"] or (r and t["dispatches"] != t["forwards"]):
                fail(f"{what}: rank {r} ran {t['forwards']} forwards and "
                     f"{t.get('dispatches')} dispatches, rank 0 {front['forwards']}")
            check_step_launches(f"{what} rank {r}", "all", t["counts"],
                                {k: v * t["forwards"] for k, v in want.items()},
                                hub_rows=t["hub_rows"])
        if not front["finite"] or front["shape"][0] != SERVE_W:
            fail(f"{what}: full logits non-finite or shape {front['shape']}")
        ref, cpu_s = cpu[model]
        err = float(np.abs(front["logits"] - ref).max())
        if not np.allclose(front["logits"], ref, rtol=SERVE_TOL, atol=SERVE_TOL):
            fail(f"{what}: full_logits() differs from the CPU at one rank (max abs err {err})")
        for k in want:
            launched[k] = launched.get(k, 0) + sum(t["counts"][k] for t in per_rank)
        rec = {"config": what, "halo_impl": halo, "world_size": SERVE_W,
               "backend": "nccl" if four else "gloo", "requests": front["requests"],
               "forwards": front["forwards"], "launches_per_forward": want,
               "cpu_max_abs_err": err, "buckets": front["buckets"],
               "warmup_s": front["warmup_s"], "build_s": [t["build_s"] for t in per_rank],
               "serve_s": front["serve_s"], "hub_rows": [t["hub_rows"] for t in per_rank]}
        recs.append(rec)
        log(f"{what}: resolved {halo}; {rec['requests']} requests, {rec['forwards']} forwards "
            f"a rank (every rank each dispatch rank 0 announced, all left follow() at stop); "
            f"launches a forward a rank {dict((k, v) for k, v in want.items() if v)}, no "
            f"backward kernel; served == full_logits bitwise; vs one rank on the CPU max abs "
            f"err {err:.3g}; build s per rank {[round(x, 1) for x in rec['build_s']]}, warmup "
            f"{rec['warmup_s']} s, serving {rec['serve_s']:.1f} s")
        for b, q in rec["buckets"].items():
            log(f"{what}: bucket {b}: n={q['count']} p50 {q['p50_ms']:.3f} ms "
                f"p99 {q['p99_ms']:.3f} ms")
        kernel_recs = [t["kernel_records"] for t in per_rank if "kernel_records" in t]
        for j in range(len(kernel_recs[0]) if kernel_recs else 0):
            rows = [k[j] for k in kernel_recs]
            if rows[0]["kernel"] == "p2p_transport":
                k5 = merged_p2p_record(rows)
                if rate:
                    k5["nvlink_bound_ms"] = k5["n"] * k5["S"] * k5["F"] * 4 / rate * 1e3
                    log(f"{k5['case']}: NVLink bound {k5['nvlink_bound_ms']:.4f} ms (the "
                        f"{k5['n']} tiles a rank puts over {rate / 1e9:.3f} GB/s)")
                records.append(k5)
            else:
                records.append(merged_rank_record(rows))
    if rate:
        for what, n, S, F, b in KERNEL5_NVLINK_READINGS:
            log(f"kernel 5 NVLink bound, {what} [{n}, {S}, {F}]: "
                f"{n * S * F * b / rate * 1e3:.4f} ms")
    main_case = {}
    for rec in records:
        main_case.setdefault(rec["kernel"], []).append(
            (rec["case"], launched, f"serve_w{SERVE_W}"))
    return records, main_case, {"train": [], "serve_w": recs, "nvlink_bytes_per_s": rate}


ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "case")


def main(argv) -> None:
    """Every phase; with ``--phase 9``, phases 1, 2 and 9 only (the
    multi-rank path, e.g. on a host with a card a rank; its W = 4 training
    in the turns W4_TURNS_ABBA); with ``--phase 11``, ``12``, ``13``,
    ``14``, ``15`` or ``16``, phases 1, 2 and that one."""
    only = {"9": lambda cfg: multi_rank_phase(cfg, W4_TURNS_ABBA), "11": ogb_raw_phase,
            "12": lambda cfg: skewed_phase(cfg, kernel_cases_too=True), "13": lowering_phase,
            "14": graphcast_phase, "15": replica_phase, "16": serve_w_phase}
    if argv and (len(argv) != 2 or argv[0] != "--phase" or argv[1] not in only):
        raise SystemExit("usage: chip_smoke.py [--phase 9|11|12|13|14|15|16]")
    t_start = time.perf_counter()
    log("phase 1: device")
    smi = phase_device()
    import torch

    log("phase 2: build")
    build = phase_build()
    cfg = arxiv_config("gcn")
    records, main_case, detail = [], {}, {"train": []}
    for phases in ([only[argv[1]]] if argv else
                   [one_rank_phases, multi_rank_phase, graph_model_phases, ogb_raw_phase,
                    skewed_phase, lowering_phase, graphcast_phase, replica_phase,
                    serve_w_phase]):
        r, m, d = phases(cfg)
        records += r
        for name, rows in m.items():
            main_case.setdefault(name, []).extend(rows)
        detail["train"] += d.pop("train")
        detail.update(d)

    log("kernels line")
    from dgraph_tpu_torch.ops.kernels import KERNELS

    line = []
    for name, k in KERNELS.items():
        if argv and name not in main_case:
            continue
        entry = None
        for case, path_launches, key in main_case[name]:
            rec = next((r for r in records if r["case"] == case), None)
            if rec is None and argv:  # phase 3 times this row: not run alone
                continue
            rec = rec or fail(f"{name}: no record of the case {case}")
            if path_launches[name] <= 0:
                fail(f"{name} was never launched on its path ({case})")
            row = {"launches": path_launches[name], **{f: rec[f] for f in ROW_KEYS}}
            for extra in ("plain_note", "kernel_ms", "max_degree", "n_hubs", "n_chunks",
                          "partial_bytes"):
                if rec.get(extra) is not None:
                    row[extra] = rec[extra]
            if entry is None:
                entry = {"name": name, "route": "cuda", "source": k.source,
                         "replaces": k.replaces, **row}
            else:  # beside the main row: the kernel's other dtype or path
                entry[key] = row
        if entry is not None:
            line.append(entry)
    os.makedirs(OUT_DIR, exist_ok=True)
    detail.update(nvidia_smi=smi, device=torch.cuda.get_device_name(0),
                  torch=torch.__version__, cuda=torch.version.cuda, build=build,
                  total_s=time.perf_counter() - t_start, phase_s=phase_seconds())
    log(f"seconds a phase: {detail['phase_s']}")
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    log(f"done in {detail['total_s']:.1f} s; details in {OUT_DIR}/chip_smoke.json")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
