#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (gloo_tpu_torch) on one GPU and checks it.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from gloo_tpu_torch/csrc (set-up time);
  3. hold each kernel against its plain PyTorch version on the card: the
     flash forward, and the flash backward (in f32 also against autograd
     through the materialized-scores reference), at FLASH_CASES, head dims
     8, 32 and 96 (zero-padded to the kernels' 64 and 128) among them;
  4. the serving path: the flagship forward of gloo_tpu_torch.entry at full
     width plus greedy serving, with the kernels' launch counts read around
     it, and its logits against the same model on the CPU (plain attention);
  5. exact greedy-decode parity on an f32 copy of the model;
  6. the training path: 5 steps of gloo_tpu_torch.entry.train_step at full
     width, with the launch counts read around them, a falling loss, and
     the first step's loss and gradients against the same model on the CPU;
  7. times of each kernel, its plain version and the library yardstick
     at FLASH_CASES (the entry shape, larger ones, the other head dims and
     the Ulysses path's whole-sequence shape; the backward's three launches
     each, beside SDPA's backward), and of the forward and the training
     step;
  8. the ring kernels (allreduce, reduce-scatter, allgather) against their
     plain versions on the card, bitwise, over worlds of 2 to 8 ranks on
     the card (RING_CASES), the DDP buffer and the torus composition on a
     2 x 2 mesh; the allreduce and the reduce-scatter (one-pass member-order
     sums) three times in a row at each case and along each axis of the
     2 x 2 mesh;
  9. the group path: CudaProcessGroup over a world of 4 ranks on the card,
     every collective against its closed form, with the ring kernels'
     launch counts read around it;
 10. the data-parallel path: 5 steps of gloo_tpu_torch.entry's
     ddp_train_entry (4 ranks on the card, batch 8 split 2 per rank), with
     the launch counts read around them, a falling loss, bitwise-equal
     replicas, and the first step against train_step over the whole batch
     on the same card;
 11. times of the ring kernels at the DDP gradient shape against their
     bound, plain versions and library yardsticks, and of the DDP step;
 12. the collective matmul kernels (B5a matmul_reduce_scatter, B5b
     allgather_matmul) against their plain versions on the card over
     worlds of 2 to 8 ranks (OVERLAP_CASES, each three times), at the
     fused MLP's full width (w as it lies and transposed), with a shared
     (stride-0) weight, chunk rows that are not multiples of 64, strides
     the wrapper pads, a W deeper than shared memory holds, and along
     "model" of a 2 x 2 mesh; gx bitwise the gathered input, replicated
     results bitwise equal on every rank of a ring;
 13. the fused Megatron-SP MLP (tensor-parallel path B): allgather_matmul
     up, tanh GELU, matmul_reduce_scatter down, forward and backward at
     full width over a ring of 4 ranks on the card, with the launch counts
     read around it, against the same MLP run densely on the card; the
     pair along "model" of a 2 x 2 mesh; both *_auto arms forced through
     TPUCOLL_TP_OVERLAP against the fused result; measure_fused_ratio on
     the card, and the fused arm that its cached probe selects;
 14. the dp x tp path (path A): 5 steps of gloo_tpu_torch.entry's
     dp_tp_train_entry (a 2 x 2 mesh of ranks on the card), with the launch
     counts read around them, a falling loss, bitwise-equal replicas and
     shards, and the first step against train_step over the whole batch;
 15. times of B5a and B5b at the fused MLP's shapes against their bound,
     plain versions and library yardsticks (kernel and whole call; B5a
     also with the backward's transposed w), of the fused MLP (per call
     and device time) and of the dp x tp step;
 16. the ring-attention step kernels (B6 out of place,
     flash_attention_step, and in place, flash_attention_step_into, the
     two bitwise equal; B7a + B7b as one fused launch:
     flash_attention_bwd_step with an f32 cotangent, and the ring
     backward's accumulating entry flash_attention_bwd_step_into over the
     whole ring with the cotangent in q's dtype) against their plain
     versions on the card at STEP_CASES, every ring step of each (so
     whole, diagonal and hidden blocks, and a carried state); that
     in-place B6 leaves the query tiles that see no key untouched; the
     guard that B7 keeps an f32
     cotangent's bits (GUARD_SHARE); and the all-to-all (B8) bitwise at
     A2A_CASES, three calls each: blocks of rows (the leading axis) and
     strided blocks (both Ulysses exchanges, a non-leading split along
     each axis of a 2 x 2 mesh, int32 of odd width);
 17. the long-context path (sp_entry, a global sequence of 4096 over 4
     ranks on the card): ring-flash forward + backward (B6 4, B7 4, B7's
     prep 1 and dQ finish 1) and Ulysses forward + backward (B8 8, B1 1,
     B2 1), with
     the launch counts read around each, and both and ring_attention
     against flash_attention (B1/B2) over the whole sequence;
 18. the MoE path (ep_entry): dispatch_combine forward + backward (B8 4)
     with the flagship's MLP as each rank's expert; kept tokens against
     their expert's MLP applied directly, dropped tokens exactly zero, the
     gradients against a dense reference;
 19. times of B6 (in place, as the path launches it, beside its byte
     bounds with only the rows that see a key and with every row's
     state, its operation bound and the out-of-place calls) and the fused
     B7 at the long-context path's ring steps
     (B7 with the path's bf16 cotangent and with an f32 one; its library
     yardstick, one call of aten._scaled_dot_product_flash_attention_
     backward per step, checked against the step's gradients first) and
     of B8 at a Ulysses exchange (as rows, the layout of the MoE path and
     the process group, and strided as the Ulysses path launches it),
     against their bound, plain versions and yardsticks, and of each of
     the three paths (every device item of the Ulysses path);
 20. the ring allreduce variants (B9 ring_allreduce_hbm, B10
     ring_allreduce_q8, B11 ring_allreduce_bidir) against their plain
     versions on the card, bitwise, at VARIANT_CASES (2 to 8 ranks, the
     dry run's shapes, B9's partial tiles, bf16, a 2 x 2 mesh, the path's
     shape, B10 past its register form's cap), three calls in a row each;
     B9 bitwise B3, B11's left half bitwise B3 on those columns,
     B10 within Q8_REL of the f64 sum and bitwise equal on every rank; and
     the sum collectives at int32, f16, f64, int64, int8, uint8, int16,
     uint16, uint32 and bool on B3, B4a and B4b against the same calls on
     the CPU, and over
     the tuple axis ("x", "y") of a 2 x 2 mesh;
 21. the ring-variant path (ring_variants_entry: the flagship's gradient
     buffer over 4 ranks on the card), each variant forward and backward
     with the launch counts read around it (2 each), y and the gradient
     against their closed forms (sum and 2 n sum); B10's error on the real
     gradient buffer of a DDP step, printed; B9 and B11 at every code of
     ring.SUM_DTYPES (the path's shape of elements, so a smaller type
     moves fewer bytes) bitwise against their plain versions, three calls
     each (variant_dtypes, run after phase 22's times);
 22. times of B9, B10 and B11 at the path's shape against their bound,
     plain versions, B3 at the same shape and the library yardstick; of
     B9, B10, B11, B3 and B4a at 64 MiB per rank (kernels and whole calls
     against their bounds; B3 and B4a also plain versions and
     yardsticks); of B9 at the path's shape and at 64 MiB per rank with
     each (tile, stages) of HBM_PROBES, bitwise B3 at each; and of B3 and
     B4a at the DDP shape and at 64 MiB per rank with SUM_PROBE_UNITS
     units per thread (the slice count of their launch); and of B4b at 64
     MiB per rank against its bound and yardstick; and B9's and B11's
     kernel ms at each sum dtype, one line per dtype;
 23. the FSDP path: FSDP_STEPS steps of fsdp_train_entry() (the flagship
     at full width sharded over 4 ranks on the card, SGD), with the launch
     counts read around them (per step 15 B4b and 15 B4a, one per leaf, 1
     B3, 8 B1 and 8 B2), a falling loss equal on every rank, and the first
     step against one model's full-batch SGD on the card and against the
     same step of the port on the CPU from the same weights;
 24. the pipeline path: pp_entry()'s GPipe forward (B1 once per tick, 11)
     and 1F1B step (B1 twice and B2 once per tick, 44 and 22) over 4
     stages of the flagship's block and 8 microbatches, the GPipe output
     and the 1F1B loss_sum and gradients against the sequential
     composition of the stages on the card (PP_TOL);
 25. times of the FSDP step, the 1F1B step and the GPipe forward (per
     call, device time and busy share), and the device time under
     gloo_tpu.fsdp.unshard, gloo_tpu.pp.fwd_shift, gloo_tpu.pp.bwd_shift
     and gloo_tpu.pp.stage_shift from one device_trace of each;
 26. the host plane (gloo_tpu_torch.Context, the C++ core built from
     csrc/ in phase 2) on CUDA tensors, in two worker processes of this
     script on the card over a FileStore: allreduce (sum, max), broadcast,
     allgather and reduce_scatter of f32, bf16 and int32 tensors of 1 KiB
     and 16 MiB, staged through pinned memory, each bitwise equal to the
     same call on CPU copies, three rounds;
 27. HostGradSync on the flagship's CUDA gradients in two processes: the
     sequential and bucketed arms and the sequential arm over the q8 wire,
     each bitwise equal to the same arm on CPU copies, three rounds; then
     5 steps of host_ddp_entry: the first step's loss (the processes'
     mean) and gradients against one model's full-batch step on the card
     (TRAIN_TOL), parameters bitwise equal across the processes;
 28. the two-level DDP: 5 steps of hier_ddp_entry in two processes of 2
     local ranks each, with (B1, B2, B3) = (4, 4, 1) launches per step per
     process, the first step against ddp_train_entry()'s on the card
     (TRAIN_TOL), parameters bitwise equal across the processes, a falling
     loss; the step's time (CUDA events), device time and busy share, and
     the host hop's D2H, host allreduce and H2D apart;
 29. elastic acceptance on the card: elastic_train_entry in ELASTIC_RANKS
     worker processes (init_from_env, rank 0 serving the TcpStore; 2
     local ranks each, make_hierarchical_ddp, Adam), rank 0 checkpointing
     every 2 steps with its state's sha256 in the store; launch rank 2
     SIGKILLs itself at step 4 (the one exit allowed other than 0); the
     survivors rebuild with rebuild_after_failure, restore with
     load_latest onto the card (sha256 equal to rank 0's) and train to
     step 8 with (B1, B2, B3) = (4, 4, 1) launches per step, a loss at
     step 8 below step 0's and bitwise-equal parameters (a host
     allgather); then run_elastic over one flagship replica per process
     (gradients through the epoch's bucketer, the port's
     StepCheckpointer), the same kill: one rebuild, a final size of 2,
     bitwise-equal parameters; the rebuild, save, load_latest and first
     resumed step's ms are printed;
 30. the rest of the host plane's Context surface in SURFACE_RANKS (3)
     worker processes: reduce (sum, max), gather, gatherv and scatter at
     every root, allgatherv and alltoallv with uneven counts holding a 0,
     alltoall, allreduce_multi of three tensors, reduce_scatter_inplace,
     allgather and reduce_scatter into output=, the async reduce-scatter
     and allgather, send/recv once around the ring, each plan replayed
     PLAN_REPLAYS times, and on f32 a callable sum and q8 encode/decode,
     on CUDA tensors of STAGE_DTYPES x STAGE_BYTES for HOST_ROUNDS rounds,
     each on cuda and bitwise equal to the same call on a CPU copy; then
     each call's host-clock ms at 16 MiB of f32 (a median of 10) and each
     plan's replay against its per-call form, in turns;
 31. the flagship at one head of 256 in f16 (entry.D256_F16_CONFIG):
     d256_f16_entry()'s forward and greedy generate (B1 once per layer)
     and 5 steps of d256_f16_train_entry() (B1, B2 once per layer and
     step), each against the same model on the CPU; ring-flash at one head
     of 256 in f16 over 4 ranks of 4096 tokens ((B6, B7, prep, finish) =
     (4, 4, 1, 1), against the same ring on the CPU); the fused MLP in f16
     over a ring of 4 at 1024 rows ((B5b, B5a, B4b) = (1, 2, 1), against
     the dense MLP); then each path's ms per call and busy share, and B6
     and B7 per launch at that ring beside their bounds and yardsticks.
     The new instances (f16, d 256 and its padded 136-248, b * h past
     65535) are held against their twins in phases 3, 12 and 16
     (FLASH_CASES, OVERLAP_CASES, STEP_CASES) and timed in phase 7; B5b
     and B5a in f16 at the fused MLP's shapes beside their plain
     versions, library yardsticks and f16 bounds (overlap_times, as
     phase 15 in bf16); one JSON line {"d256_f16_path": ...} gathers
     phase 31's paths and those kernels' rows;
 32. phase 28's two-level DDP traced and encrypted (traced_phase): two
     processes of 2 local ranks, each over Device(keyring=derive_keyring
     (...), encrypt=True), with the native tracer, the phase profiler,
     the span recorder and the fleet plane on and rank 0 serving
     telemetry: 5 steps with phase 28's launches and losses (TRAIN_TOL)
     and bitwise-equal parameters; /healthz 200 and /metrics parsed;
     fleet coverage 2 of 2; the ranks' traces merged; a critical path for
     every step's host allreduce; a 50 ms delay on rank 1's data sends in
     one step blamed on rank 1; tune() and sweep() at 1 KiB-1 MiB
     electing the same table on both ranks; the gradient buffer's host
     hop under the elected table (and with its schedule forced at the
     buffer's size) bitwise equal to the native dispatch and to the
     CPU-tensor call; then ms per step with the planes off and on, the
     busy share, and the encrypted hop beside a plaintext one.
The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or gloo_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

# Tolerances of a kernel against its plain version, as (rtol, atol) in
# max|a - b| <= atol + rtol * |b|. bf16: p and out are rounded to bf16, so a
# last-bit difference in the f32 sums before a rounding can flip one bf16
# ulp (2**-8 relative) of p and then of out; two ulps are allowed. f16: the
# same with f16's ulp (2**-11 relative), so the bf16 tolerances times 2**-3.
# f32: sums in another order. lse is f32 in all three.
KERNEL_TOL = {
    torch.bfloat16: {"out": (1.6e-2, 1e-2), "lse": (1e-5, 1e-4)},
    torch.float16: {"out": (2e-3, 1.25e-3), "lse": (1e-5, 1e-4)},
    torch.float32: {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-4)},
}
# The backward kernel against its plain version, (rtol, atol) as above but
# with atol relative to the largest |plain| of each gradient. bf16: p and ds
# are rounded to bf16 inside the sums and dq, dk, dv at the end, so a
# flipped ulp of one term or of the result moves an element by up to about
# one ulp of the largest terms (the same bound holds the plain version
# against JAX on the CPU). f32: sums in another order, dq's atomics in an
# order that changes from run to run. f16: bf16's bound at f16's ulp.
BWD_TOL = {torch.bfloat16: (1.6e-2, 8e-3), torch.float16: (2e-3, 1e-3),
           torch.float32: (1e-4, 1e-5)}
# f32 kernel gradients against autograd through reference_attention on the
# card (materialized softmax, no lse): same arithmetic, other order.
ORACLE_TOL = (1e-4, 1e-5)
# Entry logits on the card (kernel attention, cuBLAS bf16 products) against
# the same model on the CPU (plain attention, CPU bf16 products): bf16
# roundings that fall differently through two layers (the port against the
# JAX model on the CPU differs by ~1.1e-2 at this width).
LOGITS_TOL = (2e-2, 2e-2)
# First training step on the card against the same model on the CPU: loss
# rtol, and the per-tensor relative norm |g - g_cpu| / |g_cpu| of every
# parameter gradient. The forward's bf16 differences (LOGITS_TOL), carried
# back through two layers in bf16; the port against JAX on the CPU differs
# by up to ~1.8e-2 in this norm and ~5e-5 in the loss.
TRAIN_TOL = {"loss": 1e-3, "grad": 5e-2}
TRAIN_STEPS = 5
# The first DDP step (4 ranks of batch 2 on the card) against train_step
# over the whole batch of 8 on the same card is held to TRAIN_TOL: the
# model, weights and tokens are the same, and the only difference is that
# the bf16 products run over batch 2 instead of batch 8 (cuBLAS may pick
# other kernels and sum orders) and the mean over the batch is taken in two
# stages (per rank, then over the ring) in f32.
DDP_STEPS = 5

# (name, ranks, rows per rank, cols, dtype): the ring kernels against their
# plain versions, bitwise. rows = n * 8 as in the JAX tests; "ddp" cases
# take the DDP step's gradient buffer (its shape is set in phase 8).
RING_CASES = [
    ("P2_f32", 2, 16, 128, torch.float32),
    ("P3_f32", 3, 24, 128, torch.float32),
    ("P4_f32", 4, 32, 128, torch.float32),
    ("P8_f32", 8, 64, 128, torch.float32),
    ("P4_bf16", 4, 32, 128, torch.bfloat16),
    ("P4_f32_cols100", 4, 32, 100, torch.float32),
]

# (name, mesh axes, ring axis, rows of a B5a chunk per rank, k, cols, dtype,
# w): the collective matmuls against their plain versions, each case three
# times in a row (an ordering fault between TMA stores, flags and loads
# shows as a result that differs now and then). B5a takes x (P, n rows,
# k), B5b x (P, rows, k); w (P, k, cols) as it lies ("own"), one (k, cols)
# expanded to every rank (stride 0, "shared"), or the transposed view of a
# (P, cols, k) weight ("transposed", as B5b's VJP hands it to B5a). "mlp_*"
# are the fused MLP's shapes (phase 13): B5b x (4, 256, 256) @ w_up shards
# (4, 256, 256), B5a hidden (4, 1024, 256) @ w_down shards (4, 256, 256),
# and in the backward B5a dy (4, 1024, 256) @ w_up^T. Chunk rows of 8, 20
# and 100 are not multiples of the kernels' 64-row tiles; k 36 and cols
# 100 in bf16 are strides TMA cannot describe (padded by the wrapper); k
# 1024 streams W through the slab ring.
OVERLAP_CASES = [
    ("P2_f32", {"x": 2}, "x", 8, 16, 128, torch.float32, "own"),
    ("P3_f32", {"x": 3}, "x", 8, 16, 128, torch.float32, "own"),
    ("P4_f32", {"x": 4}, "x", 8, 16, 128, torch.float32, "own"),
    ("P8_f32", {"x": 8}, "x", 8, 16, 128, torch.float32, "own"),
    ("P2_bf16", {"x": 2}, "x", 8, 16, 128, torch.bfloat16, "own"),
    ("P3_bf16", {"x": 3}, "x", 8, 16, 128, torch.bfloat16, "own"),
    ("P4_bf16", {"x": 4}, "x", 8, 16, 128, torch.bfloat16, "own"),
    ("P8_bf16", {"x": 8}, "x", 8, 16, 128, torch.bfloat16, "own"),
    ("P4_shared_w", {"x": 4}, "x", 8, 16, 128, torch.float32, "shared"),
    ("2x2_model", {"data": 2, "model": 2}, "model", 8, 16, 128,
     torch.float32, "own"),
    ("P3_ragged_bf16", {"x": 3}, "x", 20, 40, 100, torch.bfloat16, "own"),
    ("P3_ragged_f32", {"x": 3}, "x", 20, 36, 100, torch.float32, "own"),
    ("mlp_bf16", {"x": 4}, "x", 256, 256, 256, torch.bfloat16, "own"),
    ("mlp_shared_bf16", {"x": 4}, "x", 256, 256, 256, torch.bfloat16,
     "shared"),
    ("mlp_bf16_wT", {"x": 4}, "x", 256, 256, 256, torch.bfloat16,
     "transposed"),
    ("P2_rows100_bf16", {"x": 2}, "x", 100, 64, 160, torch.bfloat16, "own"),
    ("P3_k36_bf16", {"x": 3}, "x", 20, 36, 64, torch.bfloat16, "own"),
    ("P8_k128_bf16", {"x": 8}, "x", 64, 128, 128, torch.bfloat16, "own"),
    ("P8_wT_bf16", {"x": 8}, "x", 8, 64, 64, torch.bfloat16,
     "transposed"),
    ("P4_deep_bf16", {"x": 4}, "x", 64, 1024, 128, torch.bfloat16, "own"),
    ("P2_deep_f32", {"x": 2}, "x", 32, 384, 96, torch.float32, "own"),
    ("P3_ragged_f16", {"x": 3}, "x", 20, 40, 100, torch.float16, "own"),
    ("mlp_f16", {"x": 4}, "x", 256, 256, 256, torch.float16, "own"),
]
# The fused MLP (phase 13) and the 2 x 2 pair against the same MLP run
# densely on the card, as the relative norm |a - b| / |b| of the output and
# of each gradient. bf16: the kernels round each ring partial to bf16
# before its add (n roundings where the dense product has one), and the
# backward carries that through GELU and a second pair; the norm moves by a
# few 1e-3.
MLP_TOL = 2e-2
# The *_auto arms against the fused result (dryrun_multichip's rtol, on its
# constant-filled inputs, f32).
AUTO_RTOL = 1e-5
DP_TP_STEPS = 5

# (name, ranks, b, h, h_kv, t_local, d, dtype, causal): B6 and the fused
# B7 against their plain versions over a world of ranks, at every step of its
# ring (each rank's own block, then the blocks before it, so whole,
# diagonal and hidden blocks, with the state carried from step to step).
# "pathS" is the long-context path's shape; "d32_gqa" and
# "d96_ragged_t200_full" run on the zero-padded d 64 and d 128 instances,
# each step taking the d-wide acc view the step before returned.
STEP_CASES = [
    ("pathS", 4, 2, 4, 4, 1024, 64, torch.bfloat16, True),
    ("pathS_full", 4, 2, 4, 4, 1024, 64, torch.bfloat16, False),
    ("gqa_h8_kv2", 4, 1, 8, 2, 256, 64, torch.bfloat16, True),
    ("d128_ragged_t200", 2, 1, 4, 4, 200, 128, torch.bfloat16, True),
    ("f32_d64", 4, 1, 2, 2, 128, 64, torch.float32, True),
    ("f32_d128_gqa_full", 2, 1, 4, 2, 100, 128, torch.float32, False),
    ("d32_gqa", 4, 1, 8, 2, 256, 32, torch.bfloat16, True),
    ("d96_ragged_t200_full", 2, 1, 4, 4, 200, 96, torch.bfloat16, False),
    ("d256_f16_pathS", 4, 2, 1, 1, 1024, 256, torch.float16, True),
    ("f16_gqa_h8_kv2", 4, 1, 8, 2, 256, 64, torch.float16, True),
    ("d256_f32_full", 2, 1, 2, 2, 100, 256, torch.float32, False),
    ("bh65540_step", 2, 16385, 4, 4, 64, 64, torch.bfloat16, True),
]
# The step kernels against their plain versions, (rtol, atol) with atol
# relative to the largest |plain| of each tensor. bf16: p (B6) and ds (B7)
# are rounded to bf16 inside the sums, so a last-bit difference of an f32
# score flips one bf16 ulp of a term (2**-8 relative), as for B1/B2
# (BWD_TOL); f16 the same at f16's ulp (2**-11). f32: products summed in
# another order. m and l are f32 in every dtype.
STEP_TOL = {torch.bfloat16: (1.6e-2, 8e-3), torch.float16: (2e-3, 1e-3),
            torch.float32: (1e-4, 1e-5)}
STATE_TOL = (1e-5, 1e-5)
# The unrounded-cotangent guard: the fused B7's max |dV - plain| with an
# f32 dO, as a share of what rounding that dO to bf16 moves the plain dV.
# The split products keep ~16 bits of dO and p (a share near 2**-8); a
# kernel that rounded dO to bf16 would show a share near 1.
GUARD_SHARE = 0.25
# (name, mesh axes, ring axis, local shape, dtype, split axis, concat
# axis): B8 against its plain version and lax.all_to_all's definition,
# bitwise, RING_RUNS calls each. "ulysses" is one exchange of the
# long-context path as rows (each rank's (heads, batch * t_local * d) with
# heads split), "ep" one of the MoE path (each rank's (experts, capacity *
# d_model)); "ulysses_in" and "ulysses_out" are its two strided exchanges
# as spmd.alltoall launches them ((b, h, t_local, d) split on heads,
# concatenated on the sequence, and back), then a non-leading split along
# each axis of a 2 x 2 mesh and int32 blocks of odd width.
A2A_CASES = [
    ("P2_f32", {"x": 2}, "x", (16, 128), torch.float32, 0, 0),
    ("P3_bf16", {"x": 3}, "x", (24, 100), torch.bfloat16, 0, 0),
    ("P4_int32", {"x": 4}, "x", (32, 7), torch.int32, 0, 0),
    ("P8_f32", {"x": 8}, "x", (64, 128), torch.float32, 0, 0),
    ("2x2_model", {"data": 2, "model": 2}, "model", (16, 128), torch.float32,
     0, 0),
    ("2x2_data_bf16", {"data": 2, "model": 2}, "data", (16, 128),
     torch.bfloat16, 0, 0),
    ("ulysses", {"seq": 4}, "seq", (4, 2 * 1024 * 64), torch.bfloat16, 0,
     0),
    ("ep", {"expert": 4}, "expert", (4, 64 * 256), torch.bfloat16, 0, 0),
    ("ulysses_in", {"seq": 4}, "seq", (2, 4, 1024, 64), torch.bfloat16, 1,
     2),
    ("ulysses_out", {"seq": 4}, "seq", (2, 1, 4096, 64), torch.bfloat16, 2,
     1),
    ("2x2_model_split1", {"data": 2, "model": 2}, "model", (6, 8, 4),
     torch.float32, 1, 0),
    ("2x2_data_split2", {"data": 2, "model": 2}, "data", (6, 8, 4),
     torch.float32, 2, 1),
    ("P3_int32_odd", {"x": 3}, "x", (4, 9, 5), torch.int32, 1, 2),
]
# The long-context path against flash_attention (B1/B2) over the whole
# 4096-token sequence on the card, as the relative norm |a - b| / |b| of
# the output and of each gradient: bf16, and the ring folds the blocks in
# another order (its own block first), so p rounds to bf16 against other
# running maxima; ring_attention (f32 softmax, one rounding at the end)
# differs by the bf16 rounding of p in the kernels.
SP_TOL = 2e-2
# The MoE path: kept tokens against their expert's MLP applied directly on
# the card (cuBLAS may pick other kernels, and so other f32 sum orders, for
# other row counts before the bf16 rounding), and the gradients against a
# dense f32 reference from the same bf16 inputs, as |a - b| / |b|.
EP_TOL = 2e-2

# B10's case past the register form's cap: 16 MiB per rank over a ring of
# 4, chunks of 1,048,576 f32 (262,144 16-byte units) where the resident
# grid holds at most Q8_REGISTER_UNITS units a thread in registers (the
# launch runs the out-of-register form; phase 20 checks that it does).
Q8_PAST_CAP_ROWS = 16384
# (name, variant, mesh axes, ring axis, rows per rank, cols, dtype): the
# ring allreduce variants against their plain versions, bitwise. At n = 8
# the dry run's shapes (__graft_entry__.py:371-373); B9's partial tiles at
# tests/test_pallas_ring.py:76's shapes; "path" the ring-variant path's
# gradient buffer; "past_cap" B10's out-of-register form.
VARIANT_CASES = (
    [(f"P{n}_f32", variant, {"x": n}, "x", per, cols, torch.float32)
     for n in (2, 3, 4, 8)
     for variant, per, cols in (("hbm", n * 8, 128), ("q8", n * 32, 128),
                                ("bidir", n * 8, 256))]
    + [(f"P{n}_rows{per}", "hbm", {"x": n}, "x", per, 128, torch.float32)
       for n, per in ((2, 528), (3, 792), (2, 1040))]
    + [("P4_bf16", "hbm", {"x": 4}, "x", 64, 128, torch.bfloat16),
       ("P4_bf16", "bidir", {"x": 4}, "x", 64, 256, torch.bfloat16)]
    + [(f"2x2_{axis}", variant, {"data": 2, "model": 2}, axis, 64, 256,
        torch.float32)
       for axis in ("data", "model") for variant in ("hbm", "q8", "bidir")]
    + [("path", variant, {"data": 4}, "data", 6912, 256, torch.float32)
       for variant in ("hbm", "q8", "bidir")]
    + [("past_cap", "q8", {"data": 4}, "data", Q8_PAST_CAP_ROWS, 256,
        torch.float32)])
# B10 against the f64 sum, max |q8 - sum| / max |sum|: the JAX package's
# criterion (tests/test_pallas_ring.py:119, __graft_entry__.py:362).
Q8_REL = 0.05
# B9 and B11 (and their gradients) against the f64 closed form, max |y -
# exact| / max |exact|: f32 adds of n values in ring order.
VARIANT_RTOL = 1e-5
# B9's, B11's, B3's and B4a's large-shard case: rows of 256 f32 per rank,
# 64 MiB.
BIG_ROWS = 65536
# (tile bytes, stages) that phase 22 tries for B9 (the wrapper's
# ring.HBM_TILE_BYTES and ring.HBM_STAGES set its launch).
HBM_PROBES = ((8192, 4), (16384, 4), (32768, 3))
# Units per thread that phase 22 tries for B3 and B4a (the wrapper's
# ring.SUM_UNITS_PER_THREAD sets the slices of their launch from it).
SUM_PROBE_UNITS = (1, 2, 4, 8, 16)
# Calls of each ring kernel in a row against its plain version (an
# ordering fault between flags and data shows now and then).
RING_RUNS = 3
# Steps of the FSDP path (phase 23). Its first step is held against one
# model's full-batch SGD on the card and against the port's CPU run with
# TRAIN_TOL: both are bf16 activations over f32 parameters, and the
# world's per-rank products, the kernels and the CPU twins round in other
# orders. The parameters are compared as the step's implied gradient
# (old - new) / lr, whose f32 rounding of the parameters adds up to
# ulp(p) / lr.
FSDP_STEPS = 5
# The pipeline path (phase 24) against the sequential composition of its
# stages on the card, as |a - b| / |b|: the GPipe output (bf16; the
# world's batched products may round differently from one stage's), the
# 1F1B loss_sum and each stage gradient summed over the microbatches.
PP_TOL = {"out": 2e-2, "loss": 1e-3, "grad": 5e-2}
# Calls of each path inside the one device_trace that phase 25 reads the
# scopes' device time from.
TRACE_CALLS = 3

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

# (name, b, h, h_kv, t, d, dtype, causal). The first is the shape the
# entry forward and the training step give the kernels, the last the one
# the Ulysses path gives them (the world flattened into the batch, h / n
# heads over the whole sequence). Head dims other than 64 and 128 run on
# the next instance, zero-padded: "dryrun_dp_tp_d8" is the dry run's dp x
# tp attention (__graft_entry__.py:125-135: batch 2 x dp 2, 4 heads of
# d_model 32, seq 16), "d32_gqa" the reference tests' GQA head_dim
# (tests/test_flash_attention.py:131) at a longer sequence.
FLASH_CASES = [
    ("entry", 8, 4, 4, 128, 64, torch.bfloat16, True),
    ("t1024_d128_causal", 4, 8, 8, 1024, 128, torch.bfloat16, True),
    ("t1024_d128_full", 4, 8, 8, 1024, 128, torch.bfloat16, False),
    ("gqa_h8_kv2", 2, 8, 2, 256, 64, torch.bfloat16, True),
    ("ragged_t200", 2, 4, 4, 200, 128, torch.bfloat16, True),
    ("f32_t256", 2, 4, 4, 256, 64, torch.float32, True),
    ("f32_d128_gqa_t100_full", 2, 4, 2, 100, 128, torch.float32, False),
    ("dryrun_dp_tp_d8", 4, 4, 4, 16, 8, torch.bfloat16, True),
    ("d32_gqa", 2, 8, 2, 256, 32, torch.bfloat16, True),
    ("d96_ragged_t200_full", 2, 4, 4, 200, 96, torch.bfloat16, False),
    ("f16_entry", 8, 4, 4, 128, 64, torch.float16, True),
    ("d256_f16_path", 8, 1, 1, 128, 256, torch.float16, True),
    ("d256_bf16_t1024_full", 2, 4, 4, 1024, 256, torch.bfloat16, False),
    ("d200_gqa_f16", 2, 8, 2, 256, 200, torch.float16, True),
    ("f32_d256_t100", 2, 2, 2, 100, 256, torch.float32, False),
    ("bh65540", 16385, 4, 4, 64, 64, torch.bfloat16, True),
    ("ulysses", 8, 1, 1, 4096, 64, torch.bfloat16, True),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True).stdout.strip()


def make_qkv(b, h, h_kv, t, d, dtype, gen, fused):
    """q (b, h, t, d), k/v (b, h_kv, t, d). `fused` takes them as views of
    one (b, t, (h + 2 h_kv) d) projection, the layout the transformer
    hands the kernel; otherwise contiguous."""
    if fused:
        qkv = torch.randn((b, t, (h + 2 * h_kv) * d), generator=gen,
                          device="cuda").to(dtype)
        q = qkv[..., :h * d].view(b, t, h, d).transpose(1, 2)
        k = qkv[..., h * d:(h + h_kv) * d].view(b, t, h_kv, d)
        v = qkv[..., (h + h_kv) * d:].view(b, t, h_kv, d)
        return q, k.transpose(1, 2), v.transpose(1, 2)
    return tuple(torch.randn((b, n, t, d), generator=gen, device="cuda")
                 .to(dtype) for n in (h, h_kv, h_kv))


def make_do(b, h, t, d, dtype, gen, fused):
    """The cotangent of out. `fused` takes it as the strided view that the
    transformer's backward hands over (the gradient of out.transpose(1, 2)
    reshaped to (b, t, h d))."""
    if fused:
        return torch.randn((b, t, h, d), generator=gen, device="cuda") \
            .to(dtype).transpose(1, 2)
    return torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)


def max_err(a, b, rtol, atol):
    """(max |a - b|, whether every element is within atol + rtol |b|)."""
    diff = (a.float() - b.float()).abs()
    ok = bool((diff <= atol + rtol * b.float().abs()).all())
    return float(diff.max()), ok


def event_ms(fn, iters=50):
    """Per-call time between CUDA events around back-to-back calls: the
    device's time when it is the bottleneck, the host's when that is."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters=20, want=(), sessions=6):
    """Per-call device time of fn from torch.profiler (CUPTI): (total ms or
    None where the trace shows no device time, [(ms, calls, name)] per
    kernel name, longest first). A session whose trace holds no device
    time, or for one of the names in `want` no kernel whose name contains
    it, is taken again, up to `sessions` times: now and then a session
    records nothing, or only part of the launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0:
                rows.append((us / 1e3 / iters, ev.count / iters, ev.key))
        rows.sort(reverse=True)
        if rows and all(any(w in r[2] for r in rows) for w in want):
            break
    total = sum(r[0] for r in rows)
    return (total if total > 0 else None), rows


def flash_bound(b, h, h_kv, t, d, dtype, causal):
    """Least time for the forward's work: each input read once and each
    output written once at the HBM rate, against the two products over
    the (q, k) pairs the mask keeps at the peak rate of the dtype."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * d * t * (2 * b * h + 2 * b * h_kv) + 4 * b * h * t
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * d * pairs * b * h
    return _bound(nbytes, flops, dtype)


def flash_bwd_bound(b, h, h_kv, t, d, dtype, causal):
    """Least time for the backward's work: q, do, dq (b h heads) and k, v,
    dk, dv (b h_kv heads) once each, lse and delta (f32), against the five
    products over the (q, k) pairs the mask keeps."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * d * t * (3 * b * h + 4 * b * h_kv) + 8 * b * h * t
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 10 * d * pairs * b * h
    return _bound(nbytes, flops, dtype)


def _bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bound_mixed(nbytes, bf16_flops, f32_flops):
    """_bound for work with products of two types: the bf16 ones at the
    tensor cores' rate, the f32 ones at the FMA units'."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (bf16_flops / PEAK_FLOPS[torch.bfloat16]
             + f32_flops / PEAK_FLOPS[torch.float32])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def timed(label, fn, iters=20):
    """Device ms per call from the profiler, or None where its trace shows
    no device time; the per-call time between CUDA events is printed
    beside it and never stands in for it."""
    dev = device_profile(fn, iters)[0]
    ev = event_ms(fn, max(5, iters))
    shown = "not measured" if dev is None else f"{dev:.6f} ms"
    print(f"  {label}: device {shown}, per call (events) {ev:.6f} ms")
    return dev


def timed_kernel(label, fn, name, each=()):
    """Device ms of one call of fn in the kernels whose names contain
    `name` (those of one CUDA source, each launched once per call), or None
    where the trace shows none. Each kernel counts its mean time per
    launch, so a record the trace drops does not lower the time. The
    kernels named in `each` are printed one by one, and each must be
    seen."""
    rows = device_profile(fn, want=(name, *each))[1]
    mine = [r for r in rows if name in r[2]]
    dev = sum(r[0] / r[1] for r in mine) if mine else None
    shown = "not measured" if dev is None else f"{dev:.6f} ms"
    seen = "+".join(f"{r[1]:g}" for r in mine)
    print(f"  {label}: device {shown} ({seen or 0} launches seen per call)")
    for kernel in each:
        found = [r for r in mine if f"{kernel}<" in r[2] or
                 f"{kernel}(" in r[2]]
        if not found:
            raise AssertionError(f"{label}: the trace shows no {kernel}")
        print(f"    {kernel}: {sum(r[0] / r[1] for r in found):.6f} ms")
    return dev


def check_bwd(attn, name, b, h, h_kv, t, d, dtype, causal, gen):
    """The backward kernel against its plain version at one shape, on B1's
    own out and lse; in f32 also against autograd through the
    materialized reference. Returns (max abs error over dq, dk, dv,
    whether every check held)."""
    fused = dtype != torch.float32
    q, k, v = make_qkv(b, h, h_kv, t, d, dtype, gen, fused)
    do = make_do(b, h, t, d, dtype, gen, fused)
    out, lse = attn.flash_attention_fwd(q, k, v, causal)
    grads = attn.flash_attention_bwd(q, k, v, out, lse, do, causal)
    plain = attn.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    rtol, atol = BWD_TOL[dtype]
    worst, ok, shown = 0.0, True, []
    for gname, a, r in zip(("dq", "dk", "dv"), grads, plain):
        peak = float(r.float().abs().max())
        err, good = max_err(a, r, rtol, atol * (peak if fused else 1.0))
        good = good and bool(torch.isfinite(a.float()).all()) \
            and a.dtype == r.dtype and a.shape == r.shape
        worst, ok = max(worst, err), ok and good
        shown.append(f"{gname} {err:.3e} (|plain| max {peak:.3f})")
    print(f"flash_bwd {name}: max_abs_err {', '.join(shown)}; "
          f"(rtol, atol) {BWD_TOL[dtype]}{' x |plain| max' if fused else ''}"
          f"{'' if ok else ' FAILED'}")
    if dtype == torch.float32:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        group = h // h_kv
        ref_out = attn.reference_attention(
            leaves[0], leaves[1].repeat_interleave(group, 1),
            leaves[2].repeat_interleave(group, 1), causal)
        oracle = torch.autograd.grad(ref_out, leaves, do)
        errs = [max_err(a, r, *ORACLE_TOL) for a, r in zip(grads, oracle)]
        good = all(e[1] for e in errs)
        ok = ok and good
        print(f"  {name} against autograd of reference_attention: "
              f"max_abs_err dq, dk, dv "
              f"{', '.join(f'{e[0]:.3e}' for e in errs)} "
              f"(rtol, atol {ORACLE_TOL}){'' if good else ' FAILED'}")
    return worst, ok


def ring_check(label, fn, plain, x, axis, mesh, want=None, runs=1):
    """One ring kernel against its plain version on the card, `runs`
    calls in a row, each held against it: (output, max |kernel - plain|,
    list of what failed). Every rank of a ring must also end bitwise equal
    to the first rank of its ring where the function says so (all but the
    reduce-scatter); `want` is the exact result where there is one (the
    allgather's), else the f64 sum is shown beside for information."""
    outs = [fn(x, axis, mesh) for _ in range(runs)]
    torch.cuda.synchronize()
    out = outs[0]
    ref = plain(x, axis, mesh)
    diff = max(float((o.float() - ref.float()).abs().max()) for o in outs)
    failed = [] if all(torch.equal(o, ref) for o in outs) \
        else ["differs from its plain version"]
    if fn.__name__ != "ring_reduce_scatter":
        first = [m[0] for m in mesh.ring_members(axis)]
        if not torch.equal(out, out[first]):
            failed.append("ranks of a ring differ")
    shown = ""
    if want is not None:
        if not torch.equal(out, want):
            failed.append("differs from the gathered input")
    else:
        exact = x.double()[torch.tensor(mesh.ring_members(axis))].sum(1)
        if fn.__name__ == "ring_reduce_scatter":
            n = mesh.shape[axis]
            idx = torch.tensor(mesh.ring_index(axis))
            exact = exact.view(x.shape[0], n, -1, x.shape[2])[
                torch.arange(x.shape[0]), idx]
        shown = f", vs the f64 sum {float((out.double() - exact).abs().max()):.3e}"
    print(f"{fn.__name__} {label}: {x.shape[0]} ranks of "
          f"{tuple(x.shape[1:])} {str(x.dtype)[6:]}, ring {axis!r} of "
          f"{mesh.shape[axis]}, {runs} run(s): max |kernel - plain| "
          f"{diff:.3e}{shown}{'; FAILED: ' + ', '.join(failed) if failed else ''}")
    return out, diff, failed


def overlap_close(a, b):
    """(max |a - b|, whether a is within the collective matmuls' tolerance
    of b): f32 (rtol, atol) (1e-5, 1e-5), the partial products summed in
    another order; bf16 and f16 two ulps of the largest |b| in the type
    (eps 2**-7 and 2**-10), a flipped last bit of a rounded partial and
    then of the add after it."""
    err = float((a.float() - b.float()).abs().max())
    if a.dtype == torch.float32:
        return err, max_err(a, b, 1e-5, 1e-5)[1]
    peak = float(b.float().abs().max())
    eps = torch.finfo(a.dtype).eps
    return err, err <= 2 * 2.0 ** math.floor(math.log2(peak)) * eps


def rel_norm(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def dense_dot(a, b):
    """a @ b accumulated in f32 and rounded once to a's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def overlap_cases(ov, make_mesh, gen):
    """Phase 12: B5a and B5b against their plain versions at
    OVERLAP_CASES. Returns {case: (B5a max abs err, B5b max abs err)}."""
    errs, failed = {}, []
    for name, axes, axis, rows, k, cols, dtype, w_kind in OVERLAP_CASES:
        ranks, n = math.prod(axes.values()), axes[axis]
        shared = w_kind == "shared"
        mesh = make_mesh(axes, devices=[torch.device("cuda")] * ranks)
        x = torch.randn((ranks, n * rows, k), generator=gen,
                        device="cuda").to(dtype)
        if w_kind == "transposed":
            w = (torch.randn((ranks, cols, k), generator=gen, device="cuda")
                 / math.sqrt(k)).to(dtype).transpose(1, 2)
        else:
            w = torch.randn((1 if shared else ranks, k, cols),
                            generator=gen, device="cuda") / math.sqrt(k)
            w = w.to(dtype).expand(ranks, -1, -1)
        xs = x[:, :rows].contiguous()
        a_err = b_err = 0.0
        a_ok = b_ok = gx_ok = True
        for _ in range(3):
            out = ov.matmul_reduce_scatter(x, w, axis, mesh)
            torch.cuda.synchronize()
            err, ok = overlap_close(
                out, ov.matmul_reduce_scatter_plain(x, w, axis, mesh))
            a_err, a_ok = max(a_err, err), a_ok and ok
            y, gx = ov.allgather_matmul_fwd(xs, w, axis, mesh)
            torch.cuda.synchronize()
            ry, _ = ov.allgather_matmul_plain(xs, w, axis, mesh)
            err, ok = overlap_close(y, ry)
            b_err, b_ok = max(b_err, err), b_ok and ok
            members = mesh.ring_members(axis)
            gathered = torch.stack([xs[m].reshape(n * rows, k)
                                    for m in members])
            gx_ok = gx_ok and torch.equal(gx, gathered)
        first = [m[0] for m in members]
        bad = [] if a_ok and b_ok else ["differs from its plain version"]
        if not gx_ok:
            bad.append("gx differs from the gathered input")
        if shared and not torch.equal(y, y[first]):
            bad.append("ranks of a ring differ")
        print(f"overlap {name}: {ranks} ranks, ring {axis!r} of {n}, "
              f"{str(dtype)[6:]}, B5a x {tuple(x.shape[1:])} -> "
              f"{tuple(out.shape[1:])}, B5b x {tuple(xs.shape[1:])} -> "
              f"{tuple(y.shape[1:])}, {w_kind} w, 3 runs: max "
              f"|kernel - plain| B5a {a_err:.3e}, B5b {b_err:.3e}; gx "
              f"bitwise {gx_ok}"
              f"{'; FAILED: ' + ', '.join(bad) if bad else ''}")
        failed += [f"{name}: {b}" for b in bad]
        errs[name] = (a_err, b_err)
    if failed:
        raise AssertionError(f"the collective matmul kernels disagree: "
                             f"{failed}")
    return errs


def mlp_pair(tp, x, w_up, w_down, axis, mesh, act=True):
    """The Megatron-SP MLP: allgather_matmul up, tanh GELU, matmul_
    reduce_scatter down (dryrun_multichip's pair without the GELU when
    act is False)."""
    h = tp.allgather_matmul_dense(x, w_up, axis, mesh=mesh)
    if act:
        h = F.gelu(h, approximate="tanh")
    return tp.row_parallel_dense_scattered(h, w_down, axis, mesh=mesh)


def fused_mlp_path(ov, tp, counters, make_mesh, gen, cfg):
    """Phase 13, at the widths of `cfg` (the flagship's d_model and d_ff)
    and its batch 8 x seq 128 token rows over a ring of 4. Returns
    (launches (B5b, B5a, B4b, B4a, B3), what phase 15 times)."""
    n, d, f = 4, cfg.d_model, cfg.d_ff
    rows = 8 * cfg.max_seq_len // n
    dev = torch.device("cuda")
    mesh = make_mesh({"x": n}, devices=[dev] * n)
    big_x = torch.randn((n * rows, d), generator=gen, device=dev).bfloat16()
    big_up = (torch.randn((d, f), generator=gen, device=dev)
              / math.sqrt(d)).bfloat16()
    big_down = (torch.randn((f, d), generator=gen, device=dev)
                / math.sqrt(f)).bfloat16()
    dy = torch.randn((n * rows, d), generator=gen, device=dev).bfloat16()
    x = big_x.view(n, rows, d).clone().requires_grad_()
    w_up = big_up.view(d, n, f // n).permute(1, 0, 2).contiguous() \
        .requires_grad_()
    w_down = big_down.view(n, f // n, d).clone().requires_grad_()
    for c in counters:
        c.launches = 0
    y = mlp_pair(tp, x, w_up, w_down, "x", mesh)
    y.backward(dy.view(n, rows, d))
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    leaves = [t.detach().clone().requires_grad_()
              for t in (big_x, big_up, big_down)]
    ref = dense_dot(F.gelu(dense_dot(leaves[0], leaves[1]),
                           approximate="tanh"), leaves[2])
    ref.backward(dy)
    rels = {"y": rel_norm(y.detach().reshape(n * rows, d), ref.detach()),
            "dx": rel_norm(x.grad.reshape(n * rows, d), leaves[0].grad),
            "dw_up": rel_norm(w_up.grad.permute(1, 0, 2).reshape(d, f),
                              leaves[1].grad),
            "dw_down": rel_norm(w_down.grad.reshape(f, d), leaves[2].grad)}
    print(f"fused MLP path: {n} ranks x {rows} rows, d_model {d}, d_ff {f} "
          f"({f // n} per rank), bf16, forward + backward; launches "
          f"allgather_matmul, matmul_reduce_scatter, ring_allgather, "
          f"ring_reduce_scatter, ring_allreduce {launches}; against the "
          f"dense MLP on the card |a - b| / |b|: "
          f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())} (tol "
          f"{MLP_TOL})")
    if launches != (1, 2, 1, 0, 0):
        raise AssertionError(f"the fused MLP launched {launches}, expected "
                             f"(1, 2, 1, 0, 0)")
    if max(rels.values()) > MLP_TOL \
            or not bool(torch.isfinite(y.detach().float()).all()):
        raise AssertionError("the fused MLP disagrees with the dense MLP")

    # The pair along "model" of a 2 x 2 mesh: each data group its own
    # tokens, the weights split over "model" and the same on both groups.
    mesh22 = make_mesh({"data": 2, "model": 2}, devices=[dev] * 4)
    f2 = 2 * (f // n)
    xs = torch.randn((2, 2 * rows, d), generator=gen, device=dev).bfloat16()
    up2 = (torch.randn((d, f2), generator=gen, device=dev)
           / math.sqrt(d)).bfloat16()
    down2 = (torch.randn((f2, d), generator=gen, device=dev)
             / math.sqrt(f2)).bfloat16()
    data, model = mesh22.ring_index("data"), mesh22.ring_index("model")
    h2 = f2 // 2
    x22 = torch.stack([xs[data[r], model[r] * rows:(model[r] + 1) * rows]
                       for r in range(4)])
    up22 = torch.stack([up2[:, i * h2:(i + 1) * h2] for i in model])
    down22 = torch.stack([down2[i * h2:(i + 1) * h2] for i in model])
    with torch.no_grad():
        y22 = mlp_pair(tp, x22, up22, down22, "model", mesh22)
    dense = [dense_dot(F.gelu(dense_dot(xs[g], up2), approximate="tanh"),
                       down2) for g in range(2)]
    want = torch.stack([dense[data[r]][model[r] * rows:(model[r] + 1) * rows]
                        for r in range(4)])
    rel22 = rel_norm(y22, want)
    print(f"fused MLP pair along 'model' of a 2 x 2 mesh: 4 ranks x {rows} "
          f"rows, d_ff {f2} per data group: |a - b| / |b| {rel22:.3e} "
          f"against the dense MLP of each data group (tol {MLP_TOL})")
    if rel22 > MLP_TOL:
        raise AssertionError("the 2 x 2 pair disagrees with the dense MLP")

    # Both *_auto arms, forced, against the fused pair: dryrun_multichip's
    # constant-filled f32 inputs (rtol AUTO_RTOL), then the random bf16
    # inputs above (MLP_TOL in relative norm).
    const = (torch.full((n, rows, d), 0.01, device=dev),
             torch.full((n, d, f // n), 0.02, device=dev),
             torch.full((n, f // n, d), 0.03, device=dev))
    rand = tuple(t.detach() for t in (x, w_up, w_down))
    saved = os.environ.get("TPUCOLL_TP_OVERLAP")
    failed = []
    try:
        with torch.no_grad():
            for label, args in (("f32 constants", const),
                                ("bf16 random", rand)):
                os.environ.pop("TPUCOLL_TP_OVERLAP", None)
                fused = mlp_pair(tp, *args, "x", mesh, act=False)
                for arm in ("fused", "unfused"):
                    os.environ["TPUCOLL_TP_OVERLAP"] = arm
                    for c in counters:
                        c.launches = 0
                    out = tp.row_parallel_dense_scattered_auto(
                        tp.allgather_matmul_dense_auto(
                            args[0], args[1], "x", mesh=mesh),
                        args[2], "x", mesh=mesh)
                    torch.cuda.synchronize()
                    got = tuple(c.launches for c in counters)
                    if label == "f32 constants":
                        diff = (out - fused).abs()
                        shown = f"max |a - b| / |b| " \
                            f"{float((diff / fused.abs()).max()):.3e}"
                        ok = bool((diff <= AUTO_RTOL * fused.abs()).all())
                    else:
                        rel = rel_norm(out, fused)
                        shown, ok = f"|a - b| / |b| {rel:.3e}", rel <= MLP_TOL
                    want = (1, 1, 0, 0, 0) if arm == "fused" \
                        else (0, 0, 1, 1, 0)
                    print(f"  *_auto arm {arm}, {label}: {shown} against "
                          f"the fused pair; launches {got}")
                    if not ok or got != want:
                        failed.append(f"{arm} {label}")
        # The probe: B5a over a world of n ranks against torch.matmul of the
        # same FLOPs at the down projection's (m, k), cached for the
        # process; with it cached, auto dispatch can take the fused arm.
        os.environ.pop("TPUCOLL_TP_OVERLAP", None)
        tp._PROBE_CACHE.clear()
        m_down, k_down = n * rows, f // n
        ratio = tp.measure_fused_ratio(m_down, k_down, n, torch.bfloat16)
        cached = tp._PROBE_CACHE.get((m_down, k_down, n, str(torch.bfloat16)))
        with torch.no_grad():
            hidden = F.gelu(tp.allgather_matmul_dense(rand[0], rand[1], "x",
                                                      mesh=mesh),
                            approximate="tanh")
            for c in counters:
                c.launches = 0
            tp.row_parallel_dense_scattered_auto(hidden, rand[2], "x",
                                                 comm_share=1.0, mesh=mesh)
        torch.cuda.synchronize()
        probe_launches = tuple(c.launches for c in counters)
        print(f"  measure_fused_ratio(m {m_down}, k {k_down}, {n} ranks, "
              f"bf16): B5a at {ratio:.4f} of torch.matmul's throughput, "
              f"cached {cached == ratio}; auto with that probe and share 1 "
              f"launches {probe_launches}")
        if not (math.isfinite(ratio) and ratio > 0 and cached == ratio) \
                or probe_launches != (0, 1, 0, 0, 0):
            failed.append("measure_fused_ratio")
        tp._PROBE_CACHE.clear()
    finally:
        if saved is None:
            os.environ.pop("TPUCOLL_TP_OVERLAP", None)
        else:
            os.environ["TPUCOLL_TP_OVERLAP"] = saved
    if failed:
        raise AssertionError(f"the *_auto arms disagree: {failed}")
    return launches, (mesh, rand, hidden, (x, w_up, w_down), dy)


def overlap_times(ov, mesh, x_b, up_b, down_b, hidden):
    """Device ms of B5b (x_b against up_b) and B5a (hidden against down_b,
    and against up_b transposed as the backward takes it) over the ring of
    `mesh`'s axis "x", each beside its whole call, its plain version, its
    library yardstick and its bound, in the tensors' dtype. Bounds: each
    input read once and each output written once at the HBM rate, against
    the products at the dtype's peak. The yardsticks are PyTorch calls the
    port never makes: for B5a the world product summed over the ring (each
    rank's rows a view of the sum), for B5b the world product of the
    expanded gathered x. Returns {name: (ms, plain, library, bound,
    bound_by)}."""
    n = mesh.shape["x"]
    dtype = x_b.dtype
    elt = x_b.element_size()
    gathered = x_b.reshape(1, -1, x_b.shape[2]).expand(n, -1, -1)
    up_t = up_b.transpose(1, 2)
    rows = {}
    for name, label, fn, plain, lib_label, lib_fn, nbytes, flops in (
            ("allgather_matmul", "ag_matmul_kernel",
             lambda: ov.allgather_matmul_fwd(x_b, up_b, "x", mesh),
             lambda: ov.allgather_matmul_plain(x_b, up_b, "x", mesh),
             "torch.matmul(expanded gathered x, w)",
             lambda: torch.matmul(gathered, up_b),
             elt * (x_b.numel() + up_b.numel() + n * x_b.numel()
                    + n * x_b.shape[0] * x_b.shape[1] * up_b.shape[2]),
             2 * n * n * x_b.shape[1] * x_b.shape[2] * up_b.shape[2]),
            ("matmul_reduce_scatter", "matmul_rs_kernel",
             lambda: ov.matmul_reduce_scatter(hidden, down_b, "x", mesh),
             lambda: ov.matmul_reduce_scatter_plain(hidden, down_b, "x",
                                                    mesh),
             "torch.matmul(h, w).sum(0), two calls",
             lambda: torch.matmul(hidden, down_b).sum(0),
             elt * (hidden.numel() + down_b.numel()
                    + hidden.numel() // n * down_b.shape[2]
                    // hidden.shape[2]),
             2 * hidden.numel() * down_b.shape[2]),
            # The backward's B5a: the cotangent's shape (that of the
            # hidden) against w_up^T as it lies (K-major, no copy).
            ("matmul_reduce_scatter (w^T)", "matmul_rs_kernel",
             lambda: ov.matmul_reduce_scatter(hidden, up_t, "x", mesh),
             lambda: ov.matmul_reduce_scatter_plain(hidden, up_t, "x",
                                                    mesh),
             "torch.matmul(h, w^T).sum(0), two calls",
             lambda: torch.matmul(hidden, up_t).sum(0),
             elt * (hidden.numel() + up_t.numel()
                    + hidden.numel() // n * up_t.shape[2]
                    // hidden.shape[2]),
             2 * hidden.numel() * up_t.shape[2])):
        with torch.no_grad():
            ms = timed_kernel(f"{name} kernel", fn, label)
            timed(f"{name} whole call (flags, buffers, kernel)", fn)
            plain_ms = timed(f"{name} plain", plain, iters=5)
            lib_ms = timed(f"{name} yardstick {lib_label}", lib_fn)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        bound, bound_by = _bound(nbytes, flops, dtype)
        print(f"  {name} bound {bound:.6f} ms ({bound_by}: {nbytes} bytes "
              f"{t_bytes:.6f} ms, {flops} operations {t_ops:.6f} ms)")
        rows[name] = (ms, plain_ms, lib_ms, bound, bound_by)
    return rows


def overlap_probes(ov, make_mesh, gen, x_b, up_b):
    """What bounds B5a and B5b: the ring's chain of steps. The fused MLP's
    per-rank shapes over rings of 2 and 8 ranks give the time of one ring
    step (a hand-off between neighbours behind a tile's product) and the
    rest. Then both in f32 (FMA, no TF32) at the fused MLP's shapes, off
    the main path."""
    print("collective matmul kernels against the ring's length (per rank "
          "the fused MLP's shapes):")
    for name, label, run in (
            ("allgather_matmul", "ag_matmul_kernel",
             lambda x, w, mesh: ov.allgather_matmul_fwd(x, w, "x", mesh)),
            ("matmul_reduce_scatter", "matmul_rs_kernel",
             lambda x, w, mesh: ov.matmul_reduce_scatter(x, w, "x", mesh))):
        times = {}
        for n in (2, 8):
            mesh = make_mesh({"x": n}, devices=[torch.device("cuda")] * n)
            rows = x_b.shape[1] * (n if name == "matmul_reduce_scatter"
                                   else 1)
            x = torch.randn((n, rows, x_b.shape[2]), generator=gen,
                            device="cuda").bfloat16()
            w = (torch.randn((n,) + tuple(up_b.shape[1:]), generator=gen,
                             device="cuda") / math.sqrt(up_b.shape[1])) \
                .bfloat16()
            with torch.no_grad():
                times[n] = timed_kernel(
                    f"{name} kernel, ring of {n}",
                    lambda: run(x, w, mesh), label)  # noqa: B023
        if None not in times.values():
            step = (times[8] - times[2]) / 6
            print(f"  {name}: {step:.6f} ms per ring step, "
                  f"{times[2] - step:.6f} ms besides")
    n = x_b.shape[0]
    mesh = make_mesh({"x": n}, devices=[torch.device("cuda")] * n)
    x, w = x_b.float(), up_b.float()
    h = x.repeat(1, n, 1)
    with torch.no_grad():
        timed_kernel("allgather_matmul kernel, f32",
                     lambda: ov.allgather_matmul_fwd(x, w, "x", mesh),
                     "ag_matmul_kernel")
        timed_kernel("matmul_reduce_scatter kernel, f32",
                     lambda: ov.matmul_reduce_scatter(h, w, "x", mesh),
                     "matmul_rs_kernel")


def rotate(spmd, x, axis, mesh, steps):
    """x shifted `steps` ranks along the ring (spmd.shift, as the ring
    loops rotate k and v)."""
    for _ in range(steps):
        x = spmd.shift(x, axis, 1, mesh=mesh)
    return x


def ring_steps(sp, spmd, q, k, v, axis, mesh, causal):
    """The launch arguments of each ring step of ring_flash_attention over
    the world tensors q, k, v: [(k_i, v_i, k_off_i)] with q flattened to
    (P b h, t, d), the q offsets, the GQA group."""
    ranks, b, h, t, d = q.shape
    q_off, k_offs = sp._offset_tables(mesh, axis, b * h, t, q.device)
    steps = [(rotate(spmd, k, axis, mesh, i).reshape(-1, t, d),
              rotate(spmd, v, axis, mesh, i).reshape(-1, t, d), k_offs[i])
             for i in range(mesh.shape[axis])]
    return q.reshape(ranks * b * h, t, d), steps, q_off, h // k.shape[2]


def visible_pairs(q_off, k_off, t, causal):
    """(q, k) pairs the mask keeps over every row of one step launch."""
    if not causal:
        return q_off.numel() * t * t
    delta = (q_off - k_off).long().cpu()[:, None] + torch.arange(t)
    return int((delta + 1).clamp(0, t).sum())


def step_close(a, b, dtype, state=False):
    """(max |a - b|, within STEP_TOL (STATE_TOL for m and l), atol relative
    to the largest finite |b|); inf must match inf."""
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin):
        return float("inf"), False
    rtol, atol = STATE_TOL if state else STEP_TOL[dtype]
    a, b = a[fin].float(), b[fin].float()
    if not b.numel():
        return 0.0, True
    peak = float(b.abs().max())
    err = float((a - b).abs().max())
    return err, bool(((a - b).abs() <= atol * peak + rtol * b.abs()).all())


def step_cases(attn, sp, spmd, make_mesh, gen):
    """Phase 16, the step kernels: every ring step of each STEP_CASES
    world, B6 from the state its previous step left, out of place
    (flash_attention_step) and in place (flash_attention_step_into, on a
    copy of that state), each against the twin and the two bitwise equal;
    the fused B7a + B7b
    from the completed forward's lse, fresh (flash_attention_bwd_step)
    with an f32 cotangent, and accumulating (flash_attention_bwd_step_into,
    the ring backward's entry) with the cotangent in q's dtype, as sp_step
    hands it over, into one dQ buffer and one dK/dV carrier per kv block.
    Returns {case: (B6 acc err, B7 dq err, B7 dk/dv err)}."""
    errs, failed = {}, []
    dev = torch.device("cuda")
    for name, ranks, b, h, h_kv, t, d, dtype, causal in STEP_CASES:
        mesh = make_mesh({"seq": ranks}, devices=[dev] * ranks)
        q = torch.randn((ranks, b, h, t, d), generator=gen, device=dev)
        k, v = (torch.randn((ranks, b, h_kv, t, d), generator=gen,
                            device=dev) for _ in range(2))
        q, k, v = (x.to(dtype) for x in (q, k, v))
        qf, steps, q_off, group = ring_steps(sp, spmd, q, k, v, "seq", mesh,
                                             causal)
        bh = qf.shape[0]
        state = (torch.zeros((bh, t, d), device=dev),
                 torch.full((bh, t, 1), -math.inf, device=dev),
                 torch.zeros((bh, t, 1), device=dev))
        worst = [0.0, 0.0, 0.0]
        bad = []
        for i, (ks, vs, k_off) in enumerate(steps):
            got = attn.flash_attention_step(qf, ks, vs, *state, q_off, k_off,
                                            causal, group)
            into = [x.clone() for x in state]
            attn.flash_attention_step_into(qf, ks, vs, *into, q_off, k_off,
                                           causal, group)
            ref = attn.flash_attention_step_plain(qf, ks, vs, *state, q_off,
                                                  k_off, causal, group)
            torch.cuda.synchronize()
            for j, (a, b_, r) in enumerate(zip(got, into, ref)):
                for form, x in (("", a), (" in place", b_)):
                    err, ok = step_close(x, r, dtype, state=j > 0)
                    if j == 0:
                        worst[0] = max(worst[0], err)
                    if not ok:
                        bad.append(f"B6{form} step {i} "
                                   f"{('acc', 'm', 'l')[j]}")
                if not torch.equal(a, b_):
                    bad.append(f"B6 step {i} {('acc', 'm', 'l')[j]}: in "
                               f"place and out of place differ")
            state = got
        l_safe = state[2].clamp_min(1e-30)
        lse = state[1] + torch.log(l_safe)
        out = (state[0] / l_safe).to(dtype).float()
        do = torch.randn((bh, t, d), generator=gen, device=dev)
        delta = (do * out).sum(-1, keepdim=True)
        for i, (ks, vs, k_off) in enumerate(steps):
            args = (qf, ks, vs, do, delta, lse, q_off, k_off, causal, group)
            got = attn.flash_attention_bwd_step(*args)
            ref = attn.flash_attention_bwd_step_plain(*args)
            torch.cuda.synchronize()
            for j, (a, r) in enumerate(zip(got, ref)):
                err, ok = step_close(a, r, dtype)
                worst[min(j, 1) + 1] = max(worst[min(j, 1) + 1], err)
                if not ok:
                    bad.append(f"B7 step {i} {('dq', 'dk', 'dv')[j]}")
        # The accumulating entry over the whole ring, as the ring backward
        # runs it: the carrier of kv block src rides with the block.
        do_in = do.to(dtype)
        delta = (do_in.float() * out).sum(-1, keepdim=True)
        cot = attn.prepare_bwd_step(qf, do_in, delta, lse)
        width = attn.kernel_head_dim(d)
        kv_rows = steps[0][0].shape[0] // ranks
        bufs = [torch.zeros((bh, t, width), device=dev),
                torch.zeros((2, ranks, kv_rows, t, width), device=dev)]
        plain = [x.clone() for x in bufs]
        my = torch.tensor(mesh.ring_index("seq"), device=dev)
        for i, (ks, vs, k_off) in enumerate(steps):
            src = (my - i) % ranks
            for (dq, car), into in (
                    (bufs, attn.flash_attention_bwd_step_into),
                    (plain, None)):
                kv = car[:, src].reshape(2, -1, t, width)
                if into is None:
                    attn.flash_attention_bwd_step_into_plain(
                        qf, ks, vs, do_in, delta, lse, q_off, k_off, dq,
                        kv[0], kv[1], causal, group)
                else:
                    into(qf, ks, vs, cot, q_off, k_off, dq, kv[0], kv[1],
                         causal, group)
                car[:, src] = kv.view(2, ranks, kv_rows, t, width)
        torch.cuda.synchronize()
        for label, a, r in (("dq", bufs[0], plain[0]),
                            ("dk", bufs[1][0], plain[1][0]),
                            ("dv", bufs[1][1], plain[1][1])):
            err, ok = step_close(a, r, dtype)
            worst[1 + (label != "dq")] = max(worst[1 + (label != "dq")], err)
            if not ok:
                bad.append(f"B7 into {label}")
        print(f"step kernels {name}: {ranks} ranks x (b {b}, h {h}, h_kv "
              f"{h_kv}, t {t}, d {d}) {str(dtype)[6:]} "
              f"{'causal' if causal else 'full'}, {len(steps)} ring steps: "
              f"max |kernel - plain| B6 acc {worst[0]:.3e}, B7 dq "
              f"{worst[1]:.3e}, B7 dk/dv {worst[2]:.3e} (fresh with an f32 "
              f"cotangent, accumulating over the ring with one in "
              f"{str(dtype)[6:]}; rtol, atol {STEP_TOL[dtype]} x |plain| "
              f"max; m, l {STATE_TOL})"
              f"{'; FAILED: ' + ', '.join(bad) if bad else ''}")
        failed += [f"{name}: {x}" for x in bad]
        errs[name] = tuple(worst)
    if failed:
        raise AssertionError(f"the step kernels disagree: {failed}")
    return errs


def unrounded_guard(attn, sp, spmd, make_mesh, gen):
    """Phase 16: that the fused B7 keeps the f32 cotangent's bits. At
    pathS's first ring step with an f32 torch.randn dO, the kernel's max
    |dV - plain| must be at most GUARD_SHARE of what the plain version
    itself moves when it is fed dO rounded to bf16."""
    name, ranks, b, h, h_kv, t, d, dtype, causal = STEP_CASES[0]
    dev = torch.device("cuda")
    mesh = make_mesh({"seq": ranks}, devices=[dev] * ranks)
    q = torch.randn((ranks, b, h, t, d), generator=gen, device=dev)
    k, v = (torch.randn((ranks, b, h_kv, t, d), generator=gen,
                        device=dev) for _ in range(2))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    with torch.no_grad():
        out, lse = sp._ring_flash_forward(q, k, v, "seq", causal, mesh)
    qf, steps, q_off, group = ring_steps(sp, spmd, q, k, v, "seq", mesh,
                                         causal)
    ks, vs, k_off = steps[0]
    do = torch.randn(qf.shape, generator=gen, device=dev)
    delta = (do * out.float().reshape(qf.shape)).sum(-1, keepdim=True)
    args = (qf, ks, vs, do, delta, lse, q_off, k_off, causal, group)
    dv = attn.flash_attention_bwd_step(*args)[2]
    dv_plain = attn.flash_attention_bwd_dkv_step_plain(*args)[1]
    rounded = attn.flash_attention_bwd_dkv_step_plain(
        qf, ks, vs, do.bfloat16().float(), *args[4:])[1]
    torch.cuda.synchronize()
    err = float((dv - dv_plain).abs().max())
    moved = float((rounded - dv_plain).abs().max())
    print(f"unrounded-dO guard at {name} ring step 0 (f32 randn dO): "
          f"kernel max |dV - plain| {err:.3e}; plain fed dO rounded to "
          f"bf16 moves dV by {moved:.3e}; ratio {err / moved:.4f} (limit "
          f"{GUARD_SHARE})")
    if not err <= GUARD_SHARE * moved:
        raise AssertionError("the fused B7 rounds the f32 cotangent away")
    return err, moved


def hidden_tiles_untouched(attn, sp, spmd, make_mesh, gen):
    """Phase 16: that in-place B6 leaves the query tiles that see no key
    of the block as they were. At pathS's last ring step (three of its
    four ranks see none of the arriving keys) the state holds a sentinel
    that a step would rewrite (acc 5, m -inf, l 7); the hidden tiles must
    keep it bit for bit, and every other tile must take the twin's
    values."""
    name, ranks, b, h, h_kv, t, d, dtype, causal = STEP_CASES[0]
    dev = torch.device("cuda")
    mesh = make_mesh({"seq": ranks}, devices=[dev] * ranks)
    q = torch.randn((ranks, b, h, t, d), generator=gen, device=dev)
    k, v = (torch.randn((ranks, b, h_kv, t, d), generator=gen,
                        device=dev) for _ in range(2))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, steps, q_off, group = ring_steps(sp, spmd, q, k, v, "seq", mesh,
                                         causal)
    ks, vs, k_off = steps[-1]
    bh = qf.shape[0]
    bufs = [torch.full((bh, t, d), 5.0, device=dev),
            torch.full((bh, t, 1), -math.inf, device=dev),
            torch.full((bh, t, 1), 7.0, device=dev)]
    ref = attn.flash_attention_step_plain(qf, ks, vs, *bufs, q_off, k_off,
                                          causal, group)
    keep = [x.clone() for x in bufs]
    attn.flash_attention_step_into(qf, ks, vs, *bufs, q_off, k_off, causal,
                                   group)
    torch.cuda.synchronize()
    seen = attn.visible_tiles(q_off, k_off, t, causal)
    hidden_ok = all(torch.equal(a[~seen.expand_as(a)],
                                kp[~seen.expand_as(a)])
                    for a, kp in zip(bufs, keep))
    seen_ok = all(step_close(a[seen.expand_as(a)], r[seen.expand_as(a)],
                             dtype, state=j > 0)[1]
                  for j, (a, r) in enumerate(zip(bufs, ref)))
    hidden = int((~seen).sum())
    print(f"B6 in place at {name}'s last ring step: {hidden} of {bh * t} "
          f"query rows in tiles that see no key, left untouched "
          f"{hidden_ok}; the others within STEP_TOL of the twin {seen_ok}")
    if not (hidden and hidden_ok and seen_ok):
        raise AssertionError("in-place B6 touched a hidden tile, or missed "
                             "a visible one")


def alltoall_cases(ring, make_mesh, gen):
    """Phase 16, B8 bitwise against its twin and lax.all_to_all's
    definition (rank r's result: block my[r] along the split axis of each
    ring member, concatenated along the concat axis in ring order) at
    A2A_CASES, RING_RUNS calls each. Returns the worst max |kernel - plain|
    (0 when all agree)."""
    failed = []
    dev = torch.device("cuda")
    for name, axes, axis, local, dtype, split, concat in A2A_CASES:
        ranks = math.prod(axes.values())
        mesh = make_mesh(axes, devices=[dev] * ranks)
        x = torch.randint(-2 ** 20, 2 ** 20, (ranks, *local), generator=gen,
                          device=dev).to(dtype)
        ref = ring.alltoall_plain(x, axis, mesh, split, concat)
        n = axes[axis]
        c = local[split] // n
        members = mesh.ring_members(axis)
        my = mesh.ring_index(axis)
        want = torch.stack([torch.cat(
            [x[m].narrow(split, my[r] * c, c) for m in members[r]], concat)
            for r in range(ranks)])
        ok = torch.equal(ref, want)
        for _ in range(RING_RUNS):
            out = ring.alltoall(x, axis, mesh, split, concat)
            torch.cuda.synchronize()
            ok = ok and torch.equal(out, ref)
        print(f"alltoall {name}: {ranks} ranks, ring {axis!r} of {n}, "
              f"{tuple(local)} {str(dtype)[6:]}, split {split}, concat "
              f"{concat}: {RING_RUNS} calls bitwise equal to its plain "
              f"version and the block exchange {ok}")
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"the all-to-all kernel disagrees: {failed}")
    return 0.0


def world_to_global(x):
    """(P, b, h, t_local, d) -> (b, h, P t_local, d)."""
    ranks, b, h, t, d = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(b, h, ranks * t, d)


def sp_path(attn, ring, sp_entry):
    """Phase 17: the long-context path with its launch counts, against
    flash_attention over the whole sequence. Returns (launches per path,
    the entry's paths)."""
    paths = sp_entry()
    counters = (attn.flash_attention_step, attn.flash_attention_bwd_step,
                attn.prepare_bwd_step, attn.flash_bwd_step_finish,
                ring.alltoall, attn.flash_attention_fwd,
                attn.flash_attention_bwd)
    results, launches = {}, {}
    for name in ("ring_flash", "ulysses", "ring_attention"):
        fn, args = paths[name]
        for c in counters:
            c.launches = 0
        results[name] = fn(*args)
        torch.cuda.synchronize()
        launches[name] = tuple(c.launches for c in counters)
    _, q, k, v, mesh = paths["ring_flash"][1]
    leaves = [world_to_global(x).detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        ref = attn.flash_attention(*leaves, causal=True)
        ref_grads = torch.autograd.grad(torch.sin(ref).sum(), leaves)
    ref = ref.detach()
    rels = {}
    for name in ("ring_flash", "ulysses"):
        out, grads = results[name]
        rels[name] = [rel_norm(world_to_global(out), ref)] + [
            rel_norm(world_to_global(g), r) for g, r in zip(grads, ref_grads)]
    rels["ring_attention"] = [rel_norm(world_to_global(
        results["ring_attention"]), ref)]
    print(f"long-context path: {tuple(q.shape)} world q/k/v (global seq "
          f"{q.shape[0] * q.shape[3]}), bf16, causal; launches (B6, B7, "
          f"B7's prep, B7's dQ finish, B8, B1, B2): ring_flash "
          f"{launches['ring_flash']}, ulysses "
          f"{launches['ulysses']}, ring_attention "
          f"{launches['ring_attention']}; against flash_attention over the "
          f"whole sequence |a - b| / |b| (out, dq, dk, dv): "
          + "; ".join(f"{n} {', '.join(f'{x:.3e}' for x in r)}"
                      for n, r in rels.items()) + f" (tol {SP_TOL})")
    want = {"ring_flash": (4, 4, 1, 1, 0, 0, 0),
            "ulysses": (0, 0, 0, 0, 8, 1, 1),
            "ring_attention": (0, 0, 0, 0, 0, 0, 0)}
    if launches != want:
        raise AssertionError(f"the long-context path launched {launches}, "
                             f"expected {want}")
    finite = all(bool(torch.isfinite(t.float()).all())
                 for name in ("ring_flash", "ulysses")
                 for t in (results[name][0], *results[name][1]))
    if not finite or max(max(r) for r in rels.values()) > SP_TOL:
        raise AssertionError("the long-context path disagrees with "
                             "flash_attention over the whole sequence")
    return launches, paths


def ep_path(ring, ep_entry, expert_mlp):
    """Phase 18: the MoE path with its launch count, against each expert's
    MLP applied directly and a dense reference. Returns (B8 launches, the
    entry's (fn, args))."""
    fn, args = ep_entry()
    tokens, idx, w_up, w_down, mesh = args
    ring.alltoall.launches = 0
    out, grads = fn(*args)
    torch.cuda.synchronize()
    launches = ring.alltoall.launches
    n = mesh.shape["expert"]
    capacity = 64
    one_hot = idx[..., None] == torch.arange(n, device=idx.device)
    pos = ((torch.cumsum(one_hot.long(), 1) - 1) * one_hot).sum(-1)
    keep = pos < capacity
    leaves = [x.detach().float().requires_grad_()
              for x in (tokens, w_up, w_down)]
    direct, dense = torch.zeros_like(out), torch.zeros(out.shape,
                                                        device=out.device)
    with torch.enable_grad():
        for e in range(n):
            sel = torch.nonzero(keep & (idx == e), as_tuple=True)
            direct[sel] = expert_mlp(tokens[sel][None], w_up[e:e + 1],
                                     w_down[e:e + 1])[0]
            dense = dense.index_put(sel, expert_mlp(
                leaves[0][sel][None], leaves[1][e:e + 1],
                leaves[2][e:e + 1])[0])
        ref_grads = torch.autograd.grad(torch.sin(dense).sum(), leaves)
    kept_rel = rel_norm(out[keep], direct[keep])
    dropped = int((~keep).sum())
    zero = not bool(out[~keep].any())
    grad_rels = [rel_norm(g, r) for g, r in zip(grads, ref_grads)]
    print(f"MoE path: {tuple(tokens.shape)} tokens bf16 over {n} experts "
          f"(d_ff {w_up.shape[2]}), capacity {capacity}: {dropped} of "
          f"{keep.numel()} tokens dropped, all exactly zero {zero}; kept "
          f"tokens against their expert's MLP applied directly |a - b| / |b| "
          f"{kept_rel:.3e}; grads (tokens, w_up, w_down) against the dense "
          f"f32 reference {', '.join(f'{x:.3e}' for x in grad_rels)} (tol "
          f"{EP_TOL}); B8 launches {launches}")
    if launches != 4:
        raise AssertionError(f"the MoE path launched B8 {launches} times, "
                             f"expected 4")
    if not zero or not dropped or kept_rel > EP_TOL \
            or max(grad_rels) > EP_TOL:
        raise AssertionError("the MoE path disagrees with its references")
    return launches, (fn, args)


def path_time(label, fn, items=8):
    """(ms per call by CUDA events, device ms, busy share) of one path;
    prints its `items` longest device items."""
    ms = event_ms(fn, iters=10)
    dev, rows = device_profile(fn, iters=5)
    busy = "not measured" if dev is None else f"{dev / ms:.3f}"
    print(f"{label}: {ms:.6f} ms per call, device time {dev} ms, device "
          f"busy share {busy}")
    for dev_ms, calls, kname in rows[:items]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")
    return ms, dev


def b6_bytes(qf, steps, q_off, only_seen):
    """B6's bytes per launch over the causal ring steps, on average: q
    (bf16), the f32 state (acc, m, l) read and written, and k and v. With
    `only_seen`, those of the queries that see a key of the step's block
    and of the keys some query sees (the in-place launch leaves the rest
    alone); else every row's and every key's."""
    bh, t, d = qf.shape
    elt = qf.element_size()
    group = bh // steps[0][0].shape[0]
    total = 0
    for _, _, k_off in steps:
        seen = (q_off.long() + t - k_off.long()).clamp(0, t).cpu()
        if not only_seen:
            seen = torch.full_like(seen, t)
        keys = seen.view(-1, group).amax(1)  # per kv row
        total += int(seen.sum()) * (elt * d + 2 * 4 * (d + 2))
        total += int(keys.sum()) * 2 * elt * d
    return total // len(steps)


def b7_bound(qf, steps, q_off, pairs, cot_bytes, passes):
    """The fused B7's least time per launch over the ring steps: the bytes
    of the rows whose block some query sees (q, the cotangent, the lse and
    delta rows, k and v once; dQ, dK and dV read and written as f32
    carriers: the accumulating form), against `passes` bf16 wgmma passes
    of 2 d operations per visible (q, k) pair at 989 TFLOP/s (an f32 x f32
    product counts as its three passes). (ms, bound by, bytes), per
    launch."""
    bh, t, d = qf.shape
    group = bh // steps[0][0].shape[0]
    n_q = -(-t // 64)
    nbytes = 0
    for _, _, k_off in steps:
        seen = int(((q_off.long() + t - 1) >= k_off.long()).sum())
        nbytes += seen * (t * d * (2 + cot_bytes + 8) + n_q * 512)
        nbytes += seen // group * t * d * (2 * 2 + 4 * 4)
    bound, bound_by = _bound(nbytes, 2 * d * pairs * passes, torch.bfloat16)
    return bound / len(steps), bound_by, nbytes // len(steps)


def b7_library(qf, steps, q_off, out, lse, g, rows_per_rank):
    """B7's library yardstick: per ring step one call of
    aten._scaled_dot_product_flash_attention_backward on the global out and
    lse and the bf16 cotangent g (step 0 causal over every row, step i > 0
    full over the contiguous rows of the ranks whose block is visible; the
    other rows' blocks are hidden), its philox seed and offset from one
    _scaled_dot_product_flash_attention forward on the same shapes.
    Returns (fn over the n steps, [(rows, dq, dk, dv) of each step])."""
    bh, t, d = qf.shape
    calls = []
    for i, (ks, vs, _) in enumerate(steps):
        r0 = i * rows_per_rank
        q4, k4, v4, o4, g4 = (x.reshape(1, bh, t, d)[:, r0:] for x in
                              (qf, ks, vs, out, g))
        l4 = lse.reshape(1, bh, t)[:, r0:].contiguous()
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            q4, k4, v4, 0.0, i == 0)
        calls.append((r0, (g4, q4, k4, v4, o4, l4, fwd[2], fwd[3], t, t,
                           0.0, i == 0, fwd[6], fwd[7])))

    def run():
        return [torch.ops.aten._scaled_dot_product_flash_attention_backward(
            *args) for _, args in calls]

    return run, [(r0, *grads) for (r0, _), grads in zip(calls, run())]


def b7_times(attn, qf, steps, q_off, out, lse, pairs, n):
    """Phase 19's B7: the fused launch over the path's ring steps as the
    ring backward makes it (prepare_bwd_step once, then
    flash_attention_bwd_step_into into f32 carriers), with the path's own
    cotangent (cos(out) in q's dtype, as sp_step's loss hands it over) and
    with an f32 torch.randn one; the plain version; the library yardstick,
    checked against the fresh step of the plain version. Returns the
    kernels line's (ms, plain ms, library ms, bound, bound by) of the
    path's cotangent."""
    bh, t, d = qf.shape
    kv_rows = steps[0][0].shape[0]
    outf = out.reshape(qf.shape)
    path = f"{str(qf.dtype)[6:]} (the path's)"
    cotangents = {path: torch.cos(outf),
                  "f32": torch.randn(qf.shape, device=qf.device)}
    results = {}
    for label, g in cotangents.items():
        delta = (g.float() * outf.float()).sum(-1, keepdim=True)
        cot = attn.prepare_bwd_step(qf, g, delta, lse)
        bufs = [torch.zeros((bh, t, d), device=qf.device)] + [
            torch.zeros((kv_rows, t, d), device=qf.device)
            for _ in range(2)]

        def fused(cot=cot, bufs=bufs):
            for ks, vs, k_off in steps:
                attn.flash_attention_bwd_step_into(qf, ks, vs, cot, q_off,
                                                   k_off, *bufs)

        def plain(g=g, delta=delta, bufs=bufs):
            for ks, vs, k_off in steps:
                attn.flash_attention_bwd_step_into_plain(
                    qf, ks, vs, g, delta, lse, q_off, k_off, *bufs)

        with torch.no_grad():
            ms = timed_kernel(f"flash_bwd_step kernel, {label} cotangent",
                              fused, "bwd_step_wgmma_kernel")
            whole = timed(f"flash_bwd_step {n} whole calls, {label} "
                          f"cotangent", fused)
            plain_ms = timed(f"flash_bwd_step plain, {n} steps, {label} "
                             f"cotangent", plain, iters=3)
        plain_ms = None if plain_ms is None else plain_ms / n
        passes = 6 if g.dtype != torch.float32 else 8
        bound, bound_by, nbytes = b7_bound(qf, steps, q_off, pairs,
                                           g.element_size(), passes)
        print(f"  flash_bwd_step ({label} cotangent): {ms} ms per launch "
              f"(whole calls {whole} ms per {n}), plain {plain_ms} ms per "
              f"step; bound {bound:.6f} ms per launch ({bound_by}: "
              f"{nbytes} bytes and {2 * d * pairs * passes // n} operations, "
              f"{passes} bf16 passes per pair, per launch on average)")
        results[label] = (ms, plain_ms, bound, bound_by, g, delta)
    ms, plain_ms, bound, bound_by, g, delta = results[path]
    rows_per_rank = bh // len(steps)
    lib_fn, lib_out = b7_library(qf, steps, q_off, out, lse, g,
                                 rows_per_rank)
    worst, ok = 0.0, True
    for (r0, *grads), (ks, vs, k_off) in zip(lib_out, steps):
        ref = attn.flash_attention_bwd_step_plain(qf, ks, vs, g, delta, lse,
                                                  q_off, k_off)
        for a, r in zip(grads, ref):
            err, close = step_close(a[0].float(), r[r0:], qf.dtype)
            worst, ok = max(worst, err), ok and close
    with torch.no_grad():
        lib = timed(f"flash_bwd_step yardstick: {n} calls of "
                    f"aten._scaled_dot_product_flash_attention_backward",
                    lib_fn)
    lib = None if lib is None else lib / n
    print(f"  flash_bwd_step library: {lib} ms per step; its (dq, dk, dv) "
          f"against the plain step's on the visible rows: max err "
          f"{worst:.3e}, within STEP_TOL {ok}")
    if not ok:
        raise AssertionError("the library yardstick does not reproduce the "
                             "ring step's gradients")
    return ms, plain_ms, lib, bound, bound_by


def step_kernel_times(attn, sp, spmd, q, k, v, mesh, card, label):
    """B6 (in place, as the ring forward launches it) and the fused B7 (as
    the ring backward launches it, with the path's cotangent in q's dtype
    and with an f32 one) over the ring steps of ring_flash_attention on
    the world tensors q, k, v along "seq", causal: ms per launch
    (averaged), bounds, plain versions and yardsticks. Returns {"flash_
    step": row, "flash_bwd_step": row}, rows as the kernels line's (ms,
    plain ms, library ms or None, bound ms, bound by)."""
    qf, steps, q_off, group = ring_steps(sp, spmd, q, k, v, "seq", mesh,
                                         True)
    bh, t, d = qf.shape
    n = len(steps)
    with torch.no_grad():
        out, lse = sp._ring_flash_forward(q, k, v, "seq", True, mesh)
    states, state = [], (torch.zeros((bh, t, d), device=qf.device),
                         torch.full((bh, t, 1), -math.inf, device=qf.device),
                         torch.zeros((bh, t, 1), device=qf.device))
    for ks, vs, k_off in steps:
        states.append(state)
        state = attn.flash_attention_step(qf, ks, vs, *state, q_off, k_off)
    pairs = sum(visible_pairs(q_off, k_off, t, True) for _, _, k_off in steps)
    print(f"ring-attention step times at {label} {n} ring steps ({bh} "
          f"rows x t {t}, d {d}, {str(qf.dtype)[6:]}, causal; {pairs} "
          f"visible (q, k) pairs over the {n} launches) on {card}:")

    def b6(fn):
        return lambda: [fn(qf, ks, vs, *st, q_off, k_off)
                        for (ks, vs, k_off), st in zip(steps, states)]

    def b6_into(fn):
        # Each step's state in buffers of its own, folded into in place.
        bufs = [[x.clone() for x in st] for st in states]
        return lambda: [fn(qf, ks, vs, *st, q_off, k_off)
                        for (ks, vs, k_off), st in zip(steps, bufs)]

    rows = {}
    with torch.no_grad():
        ms = timed_kernel("flash_step kernel, in place (the path's form)",
                          b6_into(attn.flash_attention_step_into),
                          "flash_step_wgmma_kernel")
        whole = timed(f"flash_step_into {n} whole calls (wrapper, kernel)",
                      b6_into(attn.flash_attention_step_into))
        timed(f"flash_step {n} whole calls, out of place (state copies, "
              f"kernel)", b6(attn.flash_attention_step))
        plain_ms = timed(f"flash_step_into plain, {n} steps",
                         b6_into(attn.flash_attention_step_into_plain),
                         iters=3)
    every, seen = (b6_bytes(qf, steps, q_off, only_seen) for only_seen
                   in (False, True))
    flops = 4 * d * pairs // n
    old_bound = _bound(every, flops, torch.bfloat16)
    bound, bound_by = _bound(seen, flops, torch.bfloat16)
    plain_ms = None if plain_ms is None else plain_ms / n
    print(f"  flash_step: {ms} ms per launch (whole calls {whole} ms per "
          f"{n}), plain {plain_ms} ms per step; bound in place "
          f"{bound:.6f} ms per launch ({bound_by}: {seen} bytes of the "
          f"rows that see a key, {flops} bf16 operations per launch on "
          f"average, "
          f"{flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.6f} ms of them); "
          f"with every row's state read and written {old_bound[0]:.6f} ms "
          f"({old_bound[1]}: {every} bytes); library: none (no PyTorch "
          f"call folds one block into carried state)")
    rows["flash_step"] = (ms, plain_ms, None, bound, bound_by)
    rows["flash_bwd_step"] = b7_times(attn, qf, steps, q_off, out, lse,
                                      pairs, n)
    return rows


def slice5_times(attn, sp, spmd, ring, paths, ep, card):
    """Phase 19: B6 and the fused B7 over the long-context path's four
    ring steps (ms per launch, averaged; B7 as the ring backward launches
    it, with the path's bf16 cotangent and with an f32 one), B8 at its
    Ulysses exchange, against their bounds, plain versions and
    yardsticks; the three paths. Returns {kernel: (ms, plain ms, library
    ms or None, bound ms, bound by)}."""
    _, q, k, v, mesh = paths["ring_flash"][1]
    rows = step_kernel_times(attn, sp, spmd, q, k, v, mesh, card,
                             "the long-context path's")

    # Path-level yardsticks over the whole sequence: SDPA and B1 + B2, each
    # forward and backward of sum(sin(out)).
    leaves = [world_to_global(x).detach().requires_grad_() for x in (q, k, v)]

    def fwd_bwd(f):
        def run():
            with torch.enable_grad():
                o = f(*leaves)
                torch.autograd.grad(torch.sin(o).sum(), leaves)
        return run

    timed("path yardstick: SDPA forward + backward over the whole sequence",
          fwd_bwd(lambda a, b_, c: F.scaled_dot_product_attention(
              a, b_, c, is_causal=True)))
    timed("path yardstick: B1 + B2 (flash_attention) over the whole sequence",
          fwd_bwd(lambda a, b_, c: attn.flash_attention(a, b_, c)))

    # B8 at a Ulysses exchange, as rows (q's heads split, (4, 4, 2 t_local
    # d): the leading-axis layout of the MoE path and the process group)
    # and as the path launches it (spmd.alltoall over q's (b, h, t_local,
    # d) with split 1 and concat 2: strided blocks, no copy around it).
    n_seq = mesh.shape["seq"]
    ranks, b, h, t_local, d = q.shape
    x = q.movedim(2, 1).reshape(ranks, h, -1).contiguous()
    leading = (lambda: ring.alltoall(x, "seq", mesh),
               lambda: ring.alltoall_plain(x, "seq", mesh),
               "x.view(n, n, c, cols).transpose(0, 1).contiguous()",
               lambda: x.view(n_seq, n_seq, -1).transpose(0, 1).contiguous())
    strided = (lambda: spmd.alltoall(q, "seq", split_axis=1, concat_axis=2,
                                     mesh=mesh),
               lambda: ring.alltoall_plain(q, "seq", mesh, 1, 2),
               "q.view(n, b, n, h / n, t, d).permute(2, 1, 3, 0, 4, "
               "5).contiguous()",
               lambda: q.view(n_seq, b, n_seq, h // n_seq, t_local, d)
               .permute(2, 1, 3, 0, 4, 5).contiguous())
    nbytes = 2 * q.numel() * q.element_size()
    bound, bound_by = _bound(nbytes, 0, torch.bfloat16)
    timings = {}
    for label, (call, plain, lib_label, lib_call) in (
            ("alltoall rows", leading), ("alltoall strided", strided)):
        with torch.no_grad():
            ms = timed_kernel(f"{label} kernel", call, "alltoall_kernel")
            timed(f"{label} whole call (output, flags' fill, kernel)", call)
            plain_ms = timed(f"{label} plain", plain)
            lib = timed(f"{label} yardstick {lib_label}", lib_call)
        print(f"  {label}: {ms} ms, plain {plain_ms} ms, yardstick {lib} "
              f"ms; bound {bound:.6f} ms ({bound_by}: {nbytes} bytes)")
        timings[label] = (ms, plain_ms, lib, bound, bound_by)
    # The kernels line carries the rows, as in every earlier run; the
    # strided exchange is printed beside it.
    rows["alltoall"] = timings["alltoall rows"]

    # Every device item of the Ulysses path, so that what is left around
    # B8 shows.
    for name, items in (("ring_flash", 8), ("ulysses", 64)):
        fn, args = paths[name]
        path_time(f"long-context path {name} forward + backward",
                  lambda: fn(*args), items)
    fn, args = paths["ring_attention"]
    path_time("long-context path ring_attention forward (plain torch)",
              lambda: fn(*args))
    fn, args = ep
    path_time("MoE path dispatch_combine forward + backward",
              lambda: fn(*args))
    return rows


def variant_cases(ring, make_mesh, gen):
    """Phase 20: B9, B10 and B11 against their plain versions at
    VARIANT_CASES, RING_RUNS calls in a row, each bitwise, every rank of a
    ring bitwise equal; B9 against B3 and B11's left half against B3,
    bitwise; B10 within Q8_REL of the f64 sum, in the form its chunk
    calls for (the out-of-register one at "past_cap" only). Returns
    {variant: max
    |kernel - plain|} at the path's shape."""
    dev = torch.device("cuda")
    failed, errs = [], {}
    for name, variant, axes, axis, rows, cols, dtype in VARIANT_CASES:
        ranks = math.prod(axes.values())
        mesh = make_mesh(axes, devices=[dev] * ranks)
        x = torch.randn((ranks, rows, cols), generator=gen,
                        device="cuda").to(dtype)
        fn = getattr(ring, f"ring_allreduce_{variant}")
        outs = [fn(x, axis, mesh) for _ in range(RING_RUNS)]
        torch.cuda.synchronize()
        out = outs[0]
        ref = getattr(ring, f"ring_allreduce_{variant}_plain")(x, axis, mesh)
        bad = [] if all(torch.equal(o, ref) for o in outs) \
            else ["differs from its plain version"]
        if not torch.equal(out, out[[m[0] for m in
                                     mesh.ring_members(axis)]]):
            bad.append("ranks of a ring differ")
        exact = x.double()[torch.tensor(mesh.ring_members(axis))].sum(1)
        rel = float((out.double() - exact).abs().max() / exact.abs().max())
        form = ""
        if variant == "q8":
            if not rel < Q8_REL:
                bad.append(f"rel {rel:.3e} to the sum")
            resident = next(iter(ring._var_max_blocks[
                (ring._Q8, 0, 0)].values()))
            regs = ring.q8_in_registers(rows // axes[axis] * cols // 4,
                                        ranks, resident)
            form = f", {'register' if regs else 'out-of-register'} form"
            if regs == (name == "past_cap"):
                bad.append("the other form ran")
        h = cols // 2
        if variant == "hbm" and not torch.equal(
                out, ring.ring_allreduce(x, axis, mesh)):
            bad.append("differs from B3")
        if variant == "bidir" and not torch.equal(
                out[..., :h],
                ring.ring_allreduce(x[..., :h].contiguous(), axis, mesh)):
            bad.append("its left half differs from B3")
        diff = max(float((o.double() - ref.double()).abs().max())
                   for o in outs)
        print(f"ring_allreduce_{variant} {name}: {ranks} ranks, ring "
              f"{axis!r} of {axes[axis]}, {(rows, cols)} {str(dtype)[6:]}"
              f"{form}, {RING_RUNS} runs: max |kernel - plain| {diff:.3e}, "
              f"max |out - sum| / max |sum|"
              f" {rel:.3e}{'; FAILED: ' + ', '.join(bad) if bad else ''}")
        failed += [f"{variant} {name}: {b}" for b in bad]
        if name == "path":
            errs[variant] = diff
    if failed:
        raise AssertionError(f"the ring variant kernels disagree: {failed}")
    return errs


def sum_dtype_cases(ring, spmd, make_mesh, gen):
    """Phase 20: the sum collectives at int32, f16, f64, int64, int8,
    uint8, int16, uint16, uint32 and bool on the card (allreduce and
    reduce_scatter on B3 and B4a, allgather and the product allreduce on
    B4b, uint16 and uint32 the max allreduce in the product's place; bool:
    the allreduce as int32 counts and the allgather, its reduce-scatter
    refused) against the same calls on the CPU's twins, bitwise. f16 and
    f64 take values in [-4, 4], so every sum and product is exact; the
    integers take values over 16 bits (uint32 32), so their sums wrap in
    the type.
    Then every sum collective over the tuple axis ("x", "y") of a 2 x 2
    mesh, against the CPU."""
    dev = torch.device("cuda")
    mesh = make_mesh({"data": 4}, devices=[dev] * 4)
    cpu = make_mesh({"data": 4}, devices=["cpu"] * 4)
    counters = (ring.ring_allreduce, ring.ring_reduce_scatter,
                ring.ring_allgather)
    failed = []
    for dtype in (torch.int32, torch.float16, torch.float64, torch.int64,
                  torch.int8, torch.uint8, torch.int16, torch.uint16,
                  torch.uint32, torch.bool):
        if dtype.is_floating_point:
            x = torch.randint(-4, 5, (4, 16, 24), generator=gen,
                              device=dev).to(dtype)
        else:
            bits = 31 if dtype == torch.uint32 else 15
            x = torch.randint(-2 ** bits, 2 ** bits, (4, 16, 24),
                              generator=gen, device=dev)
            x = x % 3 == 0 if dtype == torch.bool else x.to(dtype)
        calls = {
            "allreduce": lambda t, m: spmd.allreduce(t, "data", mesh=m),
            "reduce_scatter": lambda t, m: spmd.reduce_scatter(
                t, "data", mesh=m),
            "allgather": lambda t, m: spmd.allgather(t, "data", mesh=m),
            "product": lambda t, m: spmd.allreduce(t, "data", "product",
                                                   mesh=m)}
        want_launches = (1, 1, 2)
        if dtype in ring.WIDENED:
            # The reference's group takes max for them, not the product.
            del calls["product"]
            calls["max"] = lambda t, m: spmd.allreduce(t, "data", "max",
                                                       mesh=m)
            want_launches = (1, 1, 1)
        if dtype == torch.bool:
            try:
                spmd.reduce_scatter(x, "data", mesh=mesh)
                failed.append("a bool reduce-scatter was not refused")
            except TypeError:
                pass
            del calls["reduce_scatter"], calls["product"]
            want_launches = (1, 0, 1)
        for c in counters:
            c.launches = 0
        got = {k: f(x, mesh) for k, f in calls.items()}
        torch.cuda.synchronize()
        launches = tuple(c.launches for c in counters)
        out_dtype = {"allreduce": torch.int32} if dtype == torch.bool else {}
        wrong = [k for k, f in calls.items()
                 if got[k].dtype != out_dtype.get(k, dtype)
                 or not torch.equal(got[k].cpu(), f(x.cpu(), cpu))]
        print(f"sum collectives at {str(dtype)[6:]} on the card: "
              f"{', '.join(calls)} against the CPU's twins "
              f"{'all equal' if not wrong else 'FAILED ' + str(wrong)}; "
              f"launches B3, B4a, B4b {launches}")
        if wrong or launches != want_launches:
            failed.append(f"{dtype}: {wrong}, launches {launches}")
    axes, axis = {"y": 2, "x": 2}, ("x", "y")
    torus = make_mesh(axes, devices=[dev] * 4)
    torus_cpu = make_mesh(axes, devices=["cpu"] * 4)
    x = torch.randn((4, 16, 24), generator=gen, device=dev)
    for c in counters:
        c.launches = 0
    got = {name: getattr(spmd, name)(x, axis, mesh=torus)
           for name in ("allreduce", "reduce_scatter", "allgather")}
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    wrong = [name for name, out in got.items()
             if not torch.equal(out.cpu(), getattr(spmd, name)(
                 x.cpu(), axis, mesh=torus_cpu))]
    print(f"sum collectives over the tuple axis {axis} of a 2 x 2 mesh on "
          f"the card against the CPU's twins: "
          f"{'all equal' if not wrong else 'FAILED ' + str(wrong)}; "
          f"launches B3, B4a, B4b {launches}")
    if wrong or launches != (1, 1, 1):
        failed.append(f"tuple axis {axis}: {wrong}, launches {launches}")
    if failed:
        raise AssertionError(f"the sum collectives failed: {failed}")


def variants_path(ring, ring_variants_entry):
    """Phase 21: each variant forward and backward on the flagship's
    gradient buffer, with the launch counts read around it. Returns
    ({variant: launches}, the entry's paths)."""
    paths = ring_variants_entry()
    counters = {"hbm": ring.ring_allreduce_hbm, "q8": ring.ring_allreduce_q8,
                "bidir": ring.ring_allreduce_bidir,
                "b3": ring.ring_allreduce}
    launches, failed = {}, []
    for name, (fn, args) in paths.items():
        for c in counters.values():
            c.launches = 0
        y, g = fn(*args)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        launches[name] = got[name]
        _, x, _ = args
        n = x.shape[0]
        exact = x.double().sum(0)
        rels = [float((t.double() - w).abs().max() / w.abs().max())
                for t, w in ((y, exact), (g, 2 * n * exact))]
        same = all(torch.equal(t[r], t[0]) for t in (y, g)
                   for r in range(n))
        tol = Q8_REL if name == "q8" else VARIANT_RTOL
        print(f"ring-variant path {name}: {n} ranks x {tuple(x.shape[1:])} "
              f"f32, forward + backward of sum(y ** 2): launches {got}; "
              f"max |y - sum| / max |sum| {rels[0]:.3e}, max |dx - 2 n sum| "
              f"/ max |2 n sum| {rels[1]:.3e} (tol {tol}); every rank "
              f"bitwise equal {same}")
        if got != {k: 2 if k == name else 0 for k in counters} \
                or max(rels) >= tol or not same:
            failed.append(name)
    if failed:
        raise AssertionError(f"the ring-variant path failed: {failed}")
    return launches, paths


def q8_on_ddp_grads(ring, ddp_train_entry, x_like, mesh):
    """Phase 21: B10 on the gradient buffer of ddp_train_entry's first
    step (each rank's gradients and loss on its micro-batch, laid out as
    the ring-variant path lays out its buffer), printed beside B3."""
    _, (replicas, _, (tokens, targets)) = ddp_train_entry()
    n = len(replicas)
    buf = torch.zeros(x_like.shape, device=x_like.device).view(n, -1)
    for r, model in enumerate(replicas):
        loss = model.loss(tokens.chunk(n)[r], targets.chunk(n)[r])
        loss.backward()
        flat = [p.grad.reshape(-1) for p in model.parameters()]
        flat.append(loss.detach().reshape(1))
        buf[r, :sum(f.numel() for f in flat)] = torch.cat(flat)
    x = buf.view(x_like.shape)
    exact = x.double().sum(0)
    with torch.no_grad():
        q8 = ring.ring_allreduce_q8(x, "data", mesh)
        b3 = ring.ring_allreduce(x, "data", mesh)
    torch.cuda.synchronize()
    for label, y in (("ring_allreduce_q8", q8), ("ring_allreduce (B3)", b3)):
        err = (y[0].double() - exact).abs()
        print(f"{label} on the first DDP step's gradient buffer: max |y - "
              f"sum| / max |sum| {float(err.max() / exact.abs().max()):.3e},"
              f" |y - sum| / |sum| {float(err.norm() / exact.norm()):.3e}")


def variant_times(ring, paths, card):
    """Phase 22: B9, B10 and B11 at the path's shape against their bound
    (bytes: each rank's input read once and output written once, 2 P S),
    plain versions, B3 at the same shape and the yardstick (for B9 and B11
    B3's: x.sum(0) then expand(P).contiguous(); none for B10: no PyTorch
    call computes an int8-wire sum); B9, B10, B11, B3 and B4a at 64 MiB
    per rank (B10 in its out-of-register form); B9 by HBM_PROBES.
    Returns {variant: (ms, plain ms, library ms or None, bound ms, bound
    by)}."""
    _, x, mesh = paths["hbm"][1]
    ranks = x.shape[0]
    per_rank = x[0].numel() * x.element_size()
    bound, bound_by = _bound(2 * ranks * per_rank,
                             (ranks - 1) * x[0].numel(), torch.float32)
    print(f"ring variant times at the path's shape ({ranks} ranks x "
          f"{tuple(x.shape[1:])} f32, {per_rank} bytes per rank) on {card}; "
          f"bound {bound:.6f} ms ({bound_by}: {2 * ranks * per_rank} "
          f"bytes):")
    rows = {}
    with torch.no_grad():
        timed_kernel("ring_allreduce (B3) kernel at the same shape",
                     lambda: ring.ring_allreduce(x, "data", mesh),
                     "ring_kernel")
        lib = timed("yardstick x.sum(0) then expand(P).contiguous(), two "
                    "calls",
                    lambda: x.sum(0).expand(ranks, -1, -1).contiguous())
        for name, label in (("hbm", "hbm_kernel"), ("q8", "q8_kernel"),
                            ("bidir", "bidir_kernel")):
            fn = getattr(ring, f"ring_allreduce_{name}")
            plain = getattr(ring, f"ring_allreduce_{name}_plain")
            ms = timed_kernel(f"ring_allreduce_{name} kernel",
                              lambda fn=fn: fn(x, "data", mesh), label)
            timed(f"ring_allreduce_{name} whole call (flags, buffers, "
                  f"kernel)", lambda fn=fn: fn(x, "data", mesh))
            plain_ms = timed(f"ring_allreduce_{name} plain",
                             lambda plain=plain: plain(x, "data", mesh),
                             iters=3)
            rows[name] = (ms, plain_ms, None if name == "q8" else lib, bound,
                          bound_by)
        big = torch.randn((ranks, BIG_ROWS, x.shape[2]), device="cuda")
        per_big = big[0].numel() * big.element_size()
        big_bytes = 2 * ranks * per_big
        big_bound, by = _bound(big_bytes, 0, torch.float32)
        print(f"B9, B10, B11 and B3 at 64 MiB per rank ({ranks} x "
              f"{tuple(big.shape[1:])} f32), bound {big_bound:.6f} ms ({by}: "
              f"{big_bytes} bytes):")
        for name, label in (("hbm", "hbm_kernel"), ("q8", "q8_kernel"),
                            ("bidir", "bidir_kernel")):
            fn = getattr(ring, f"ring_allreduce_{name}")
            timed_kernel(f"ring_allreduce_{name} kernel, 64 MiB per rank",
                         lambda fn=fn: fn(big, "data", mesh), label)
            timed(f"ring_allreduce_{name} whole call (output, flags, "
                  f"kernel), 64 MiB per rank",
                  lambda fn=fn: fn(big, "data", mesh))
            print(f"  ring_allreduce_{name} bound at 64 MiB per rank "
                  f"{big_bound:.6f} ms ({by}: {big_bytes} bytes)")
        for fn, plain, lib_label, lib_fn, nbytes in (
                (ring.ring_allreduce, ring.ring_allreduce_plain,
                 "x.sum(0) then expand(P).contiguous(), two calls",
                 lambda: big.sum(0).expand(ranks, -1, -1).contiguous(),
                 big_bytes),
                (ring.ring_reduce_scatter, ring.ring_reduce_scatter_plain,
                 "x.sum(0)", lambda: big.sum(0), ranks * per_big + per_big)):
            name = fn.__name__
            timed_kernel(f"{name} kernel, 64 MiB per rank",
                         lambda fn=fn: fn(big, "data", mesh), "ring_kernel")
            timed(f"{name} whole call (output, flags, kernel), 64 MiB per "
                  f"rank", lambda fn=fn: fn(big, "data", mesh))
            timed(f"{name} plain, 64 MiB per rank",
                  lambda plain=plain: plain(big, "data", mesh), iters=3)
            timed(f"{name} yardstick {lib_label}, 64 MiB per rank", lib_fn)
            bound, by = _bound(nbytes, 0, torch.float32)
            print(f"  {name} bound at 64 MiB per rank {bound:.6f} ms ({by}: "
                  f"{nbytes} bytes)")
        # What the card's memory gives B3's mix of bytes (P S read, P S
        # written) in one PyTorch call: the ceiling under the bound.
        timed("a copy of the same bytes, x.clone(), 64 MiB per rank",
              lambda: big.clone())
        hbm_probes(ring, x, big, mesh)
        sum_probes(ring, big, mesh)
        gather_probe(ring, big, mesh)
    return rows


def hbm_probes(ring, x, big, mesh):
    """Phase 22: B9 at the path's shape and at 64 MiB per rank with each
    (tile bytes, stages) of HBM_PROBES (ring.HBM_TILE_BYTES and
    ring.HBM_STAGES, restored after), bitwise B3 at each; fails if any
    differs."""
    chosen = ring.HBM_TILE_BYTES, ring.HBM_STAGES
    print(f"B9 by (tile bytes, stages) (the wrapper's choice {chosen}):")
    wrong = []
    try:
        for tile, stages in HBM_PROBES:
            ring.HBM_TILE_BYTES, ring.HBM_STAGES = tile, stages
            for label, t in (("path shape", x), ("64 MiB per rank", big)):
                same = torch.equal(ring.ring_allreduce_hbm(t, "data", mesh),
                                   ring.ring_allreduce(t, "data", mesh))
                blocks = next(iter(ring._var_max_blocks[
                    (0, tile, stages)].values()))
                timed_kernel(f"ring_allreduce_hbm kernel, {label}, tile "
                             f"{tile} bytes, {stages} stages, "
                             f"{(stages + 2) * tile} bytes of shared memory "
                             f"and {blocks} resident blocks; bitwise B3 "
                             f"{same}",
                             lambda t=t: ring.ring_allreduce_hbm(t, "data",
                                                                 mesh),
                             "hbm_kernel")
                if not same:
                    wrong.append((label, tile, stages))
    finally:
        ring.HBM_TILE_BYTES, ring.HBM_STAGES = chosen
    if wrong:
        raise AssertionError(f"B9 differs from B3 at {wrong}")


def sum_probes(ring, big, mesh):
    """Phase 22: B3 and B4a at the DDP shape (4 x 1,738,000 f32) and at 64
    MiB per rank with each of SUM_PROBE_UNITS units per thread, the slice
    count of their launch (ring.SUM_UNITS_PER_THREAD, restored after)."""
    ranks = big.shape[0]
    ddp = torch.randn((ranks, ranks, 434500), device="cuda")
    chosen = ring.SUM_UNITS_PER_THREAD
    print(f"B3 and B4a by units per thread (the wrapper's choice "
          f"{chosen}); slices per rank at most "
          f"{next(iter(ring._max_blocks.values())) // ranks}:")
    try:
        for units in SUM_PROBE_UNITS:
            ring.SUM_UNITS_PER_THREAD = units
            for label, x in (("DDP shape", ddp), ("64 MiB per rank", big)):
                for fn in (ring.ring_allreduce, ring.ring_reduce_scatter):
                    timed_kernel(f"{fn.__name__} kernel, {label}, {units} "
                                 f"units per thread",
                                 lambda fn=fn, x=x: fn(x, "data", mesh),
                                 "ring_kernel")
    finally:
        ring.SUM_UNITS_PER_THREAD = chosen


def gather_probe(ring, big, mesh):
    """Phase 22: B4b at 64 MiB per rank (each rank's (BIG_ROWS, cols) f32
    gathered over the ring of 4) against its bound (each input byte read
    once, each output byte written once: S + n S per rank) and one PyTorch
    call that writes the same bytes (expand(P).contiguous())."""
    ranks = big.shape[0]
    per_rank = big[0].numel() * big.element_size()
    nbytes = ranks * per_rank + ranks * ranks * per_rank
    bound, by = _bound(nbytes, 0, torch.float32)
    ms = timed_kernel("ring_allgather kernel, 64 MiB per rank",
                      lambda: ring.ring_allgather(big, "data", mesh),
                      "ring_kernel")
    timed("ring_allgather whole call (output, flags, kernel), 64 MiB per "
          "rank", lambda: ring.ring_allgather(big, "data", mesh))
    lib = timed("ring_allgather yardstick expand(P).contiguous(), 64 MiB "
                "per rank", lambda: big.reshape(1, ranks, -1).expand(
                    ranks, -1, -1).contiguous())
    shown = "not measured" if ms is None else f"{ms / bound:.3f}"
    print(f"  ring_allgather bound at 64 MiB per rank {bound:.6f} ms ({by}: "
          f"{nbytes} bytes); kernel / bound {shown}, yardstick {lib} ms")


def dtype_input(dtype, shape, gen):
    """A world tensor of `dtype` whose sums round (floats, at the scale of
    gradients and of activations) or wrap (integers over the whole range
    of the type)."""
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen, device="cuda") * 16) \
            .to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = (info.min, info.max) if info.bits < 64 else (-2 ** 62, 2 ** 62)
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(dtype)


def variant_dtypes(ring, paths, card, gen):
    """Phases 21 and 22 at every code of ring.SUM_DTYPES: B9 and B11 at the
    ring-variant path's shape (4 x 6912 x 256 elements, so a smaller type
    moves fewer bytes) against their plain versions on the same inputs,
    bitwise, RING_RUNS calls each; one line per dtype with each kernel's
    device ms beside the dtype's bound from this run's inputs (as
    variant_times's: each rank's input read once and output written once,
    and (P - 1) S adds; a type with no rate in PEAK_FLOPS takes the f32
    units' rate for its adds, which lie two orders under the bytes).
    Returns {dtype name: (B9 ms, B11 ms, bound ms)}."""
    _, x32, mesh = paths["hbm"][1]
    shape = tuple(x32.shape)
    print(f"B9 and B11 at every sum dtype, {shape} elements on {card}:")
    rows, wrong = {}, []
    with torch.no_grad():
        for dtype, code in sorted(ring.SUM_DTYPES.items(),
                                  key=lambda kv: kv[1]):
            x = dtype_input(dtype, shape, gen)
            name = str(dtype).replace("torch.", "")
            nbytes = 2 * x.numel() * x.element_size()
            bound, bound_by = _bound(
                nbytes, (x.shape[0] - 1) * x[0].numel(),
                dtype if dtype in PEAK_FLOPS else torch.float32)
            ms = []
            for variant, label in (("hbm", "hbm_kernel"),
                                   ("bidir", "bidir_kernel")):
                fn = getattr(ring, f"ring_allreduce_{variant}")
                plain = getattr(ring, f"ring_allreduce_{variant}_plain")
                before = fn.launches
                outs = [fn(x, "data", mesh) for _ in range(RING_RUNS)]
                torch.cuda.synchronize()
                want = plain(x, "data", mesh)
                same = fn.launches == before + RING_RUNS and all(
                    o.dtype == dtype and same_bits(o, want) for o in outs)
                if not same:
                    wrong.append((variant, name))
                ms.append(timed_kernel(
                    f"ring_allreduce_{variant} {name} (code {code}, "
                    f"{x[0].numel() * x.element_size()} bytes per rank): "
                    f"bitwise its plain version {same}",
                    lambda fn=fn: fn(x, "data", mesh), label))
            rows[name] = (*ms, bound)
            ratios = ", ".join("not measured" if m is None
                               else f"{m / bound:.3f}x" for m in ms)
            print(f"  {name}: B9 {ms[0]} ms, B11 {ms[1]} ms; bound "
                  f"{bound:.6f} ms ({bound_by}: {nbytes} bytes); B9, B11 "
                  f"over the bound {ratios} [{card}]")
    if wrong:
        raise AssertionError(f"B9/B11 differ from their plain versions at "
                             f"{wrong}")
    return rows


def implied_grads(old, new, lr):
    """{name: (old - new) / lr} of rank 0's rows of unsharded FSDP
    parameters: the gradient an SGD step took."""
    return {n: (old[n][0] - new[n][0]) / lr for n in old}


def fsdp_path(attn, ring, entry_mod, unshard_params, make_mesh, cfg):
    """Phase 23: FSDP_STEPS steps of fsdp_train_entry() with the launch
    counts read around them; the first step against one model's SGD over
    the whole batch on the card and against the same step of the port on
    the CPU. Returns (launches, the entry's (step, args))."""
    step, (sharded, batch) = entry_mod.fsdp_train_entry()
    ranks, lr = entry_mod.FSDP_MESH["data"], entry_mod.FSDP_LR
    counters = (ring.ring_allgather, ring.ring_reduce_scatter,
                ring.ring_allreduce, attn.flash_attention_fwd,
                attn.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    state, losses = sharded, []
    for i in range(FSDP_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
        if i == 0:
            first = state
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    leaves = len(sharded)
    per_step = (leaves, leaves, 1, ranks * cfg.n_layers,
                ranks * cfg.n_layers)
    want = tuple(FSDP_STEPS * x for x in per_step)
    same = all(torch.equal(x, x[:1].expand_as(x)) for x in losses)
    losses = [float(x[0]) for x in losses]
    print(f"FSDP path: {FSDP_STEPS} steps of {ranks} ranks on the card, "
          f"{leaves} leaves sharded 1/{ranks}, SGD lr {lr}; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)} (every rank's the same: "
          f"{same}); launches (B4b, B4a, B3, B1, B2) {launches}, per step "
          f"{per_step}")
    if leaves != 15 or launches != want:
        raise AssertionError(f"the FSDP path launched {launches} over "
                             f"{leaves} leaves, expected {want} over 15")
    if not same or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"FSDP loss is not finite, equal on every "
                             f"rank and falling: {losses}")

    from gloo_tpu_torch.models import Transformer

    template = Transformer(cfg, device="meta").state_dict()
    mesh = make_mesh(entry_mod.FSDP_MESH,
                     devices=[batch[0].device] * ranks)
    old = unshard_params(sharded, template, "data", mesh=mesh)
    implied = implied_grads(old, unshard_params(first, template, "data",
                                                mesh=mesh), lr)
    _, (model, _, tokens, targets) = entry_mod.train_entry()
    single = model.loss(tokens, targets)
    single.backward()
    checks = {"one model on the card": (float(single.detach()), {
        n: p.grad for n, p in model.named_parameters()})}
    cstep, (csharded, cbatch) = entry_mod.fsdp_train_entry("cpu")
    if any(not torch.equal(csharded[n], sharded[n].cpu()) for n in sharded):
        raise AssertionError("the CPU run does not start from the card's "
                             "weights")
    cnew, closs = cstep(csharded, cbatch)
    cmesh = make_mesh(entry_mod.FSDP_MESH, devices=["cpu"] * ranks)
    checks["the port on the CPU"] = (float(closs[0]), implied_grads(
        unshard_params(csharded, template, "data", mesh=cmesh),
        unshard_params(cnew, template, "data", mesh=cmesh), lr))
    for label, (ref_loss, ref_grads) in checks.items():
        loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
        grad_rel = {n: float((implied[n].cpu() - g.cpu()).norm()
                             / g.cpu().norm()) for n, g in ref_grads.items()}
        worst = max(grad_rel, key=grad_rel.get)
        print(f"first FSDP step vs {label}: loss {losses[0]:.6f} vs "
              f"{ref_loss:.6f} (rel {loss_rel:.3e}, tol "
              f"{TRAIN_TOL['loss']}); implied grads (old - new) / lr "
              f"|g - g_ref| / |g_ref| max {grad_rel[worst]:.3e} at {worst}, "
              f"median {sorted(grad_rel.values())[len(grad_rel) // 2]:.3e} "
              f"(tol {TRAIN_TOL['grad']})")
        if loss_rel > TRAIN_TOL["loss"] \
                or grad_rel[worst] > TRAIN_TOL["grad"]:
            raise AssertionError(f"the first FSDP step disagrees with "
                                 f"{label}")
    return launches, (step, (sharded, batch))


def sequential(stage_fn, stages, x, n_stages):
    """x (1, ...) through stages 0 .. n_stages - 1 in turn, each with its
    own row of the world parameters."""
    for s in range(n_stages):
        x = stage_fn({k: v[s:s + 1] for k, v in stages.items()}, x)
    return x


def pp_path(attn, pp, entry_mod):
    """Phase 24: pp_entry()'s GPipe forward and 1F1B step with the flash
    launch counts read around each, against the sequential composition of
    the stages on the card. Returns ((B1, B2) per path, the paths)."""
    paths = entry_mod.pp_entry()
    s, m = entry_mod.PP_STAGES, entry_mod.PP_MICROBATCHES
    ticks_1f1b = pp._build_1f1b_tables(s, m)[0].shape[0]
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd)
    results, launches = {}, {}
    for name in ("gpipe", "1f1b"):
        fn, args = paths[name]
        for c in counters:
            c.launches = 0
        results[name] = fn(*args)
        torch.cuda.synchronize()
        launches[name] = tuple(c.launches for c in counters)
    stage_fn, loss_fn, stages, xs, ys, _ = paths["1f1b"][1]
    with torch.no_grad():
        ref = torch.cat([sequential(stage_fn, stages, xs[:1, i], s)
                         for i in range(m)])
    out = results["gpipe"]
    out_rel = rel_norm(out[-1], ref)
    leaves = {k: v.clone().requires_grad_() for k, v in stages.items()}
    with torch.enable_grad():
        total = sum(loss_fn(sequential(stage_fn, leaves, xs[:1, i], s),
                            ys[:1, i]).sum() for i in range(m))
        total.backward()
    grads, loss_sum = results["1f1b"]
    total = float(total.detach())
    loss_rel = abs(float(loss_sum[-1]) - total) / abs(total)
    grad_rel = {k: rel_norm(grads[k], leaves[k].grad) for k in leaves}
    want = {"gpipe": (s + m - 1, 0), "1f1b": (2 * ticks_1f1b, ticks_1f1b)}
    print(f"pipeline path: {s} stages of the flagship's block (width "
          f"{xs.shape[-1]}) on the card, {m} microbatches of "
          f"{tuple(xs.shape[2:])} bf16; launches (B1, B2) GPipe "
          f"{launches['gpipe']} over {s + m - 1} ticks, 1F1B "
          f"{launches['1f1b']} over {ticks_1f1b} ticks; against the "
          f"sequential composition |a - b| / |b|: GPipe output "
          f"{out_rel:.3e} (tol {PP_TOL['out']}), 1F1B loss_sum "
          f"{float(loss_sum[-1]):.6f} vs {total:.6f} (rel "
          f"{loss_rel:.3e}, tol {PP_TOL['loss']}), grads "
          + ", ".join(f"{k} {v:.3e}" for k, v in grad_rel.items())
          + f" (tol {PP_TOL['grad']})")
    if launches != want:
        raise AssertionError(f"the pipeline path launched {launches}, "
                             f"expected {want}")
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out, loss_sum, *grads.values()))
    if not finite or out[:-1].any() or loss_sum[:-1].any() \
            or out_rel > PP_TOL["out"] or loss_rel > PP_TOL["loss"] \
            or max(grad_rel.values()) > PP_TOL["grad"]:
        raise AssertionError("the pipeline path disagrees with the "
                             "sequential composition of its stages")
    return launches, paths


def scope_times(tracing, label, fn, scopes):
    """Device ms per call under each scope in `scopes`, read from one
    device_trace of TRACE_CALLS calls of fn: {scope: (ms, device events)},
    each per call. Every scope must show device work."""
    import glob
    import tempfile

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with tracing.device_trace(logdir):
            for _ in range(TRACE_CALLS):
                fn()
            torch.cuda.synchronize()
        (trace,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        found = {name: tracing.scope_device_ms(trace, name)
                 for name in scopes}
    out = {}
    for name, (ms, events) in found.items():
        out[name] = (ms / TRACE_CALLS, events / TRACE_CALLS)
        print(f"  {label}: under {name} {ms / TRACE_CALLS:.6f} ms of "
              f"device time in {events / TRACE_CALLS:g} device events per "
              f"call")
        if not events:
            raise AssertionError(f"the trace of {label} shows no device "
                                 f"work under {name}")
    return out


def parallel_times(tracing, fsdp, pp_paths, card):
    """Phase 25: ms per FSDP step, 1F1B step and GPipe forward (CUDA
    events), their device time and busy share, and the device time under
    the FSDP and pipeline scopes."""
    print(f"FSDP and pipeline times on {card}:")
    step, (sharded, batch) = fsdp
    rows = {}
    for label, fn, scopes in (
            ("FSDP step", lambda: step(sharded, batch),
             ("gloo_tpu.fsdp.unshard",)),
            ("1F1B step", lambda: pp_paths["1f1b"][0](*pp_paths["1f1b"][1]),
             ("gloo_tpu.pp.fwd_shift", "gloo_tpu.pp.bwd_shift")),
            ("GPipe forward",
             lambda: pp_paths["gpipe"][0](*pp_paths["gpipe"][1]),
             ("gloo_tpu.pp.stage_shift",))):
        rows[label] = path_time(label, fn) + (
            scope_times(tracing, label, fn, scopes),)
    return rows


# ---- phase 31: the flagship at one head of 256 in f16 ----
# The d 256 f16 path against the same model on the CPU (the twins), at
# f16's ulp (2**-11 relative) where the bf16 paths are held at bf16's
# (2**-8): each bf16 tolerance of phases 4, 6, 13 and 17 times 2**-3.
# Logits (LOGITS_TOL / 8): f16 roundings that fall differently through two
# layers (the CPU twins against JAX: 7.9e-4 at a small size,
# tests/test_torch_domains.py). The first training step: the loss
# (TRAIN_TOL / 8) and the per-tensor relative norm of every gradient,
# held to 2e-2: the largest norm is that of a small gradient summed over
# the batch's 1024 rows (an RMSNorm scale; 5.2e-3 on the card, where
# phase 6's bf16 shows 7.7e-3 at the position table), set by cancellation
# in the reduction more than by the type's ulp, so TRAIN_TOL's 5e-2 is
# not scaled by 1/8 but halved twice over. The ring-flash path against the
# same ring on the CPU (SP_TOL / 8, as |a - b| / |b| of the output and
# each gradient) and the fused MLP against the dense MLP on the card
# (MLP_TOL / 8).
D256_LOGITS_TOL = (2.5e-3, 2.5e-3)
D256_TRAIN_TOL = {"loss": 1.25e-4, "grad": 2e-2}
D256_SP_TOL = 2.5e-3
D256_MLP_TOL = 2.5e-3
# The long-context shape of phase 31's ring-flash: the sp_entry's world of
# SP_MESH ranks over a global sequence of SP_SEQ, batch 2, one head of 256.
D256_SP_BATCH = 2


def d256_serving(attn, entry_mod, device="cuda"):
    """Phase 31's serving path: d256_f16_entry()'s forward and greedy
    generate, with B1/B2's launches read around them; logits against the
    same model on the CPU. Returns (fn, model, tokens, prompts)."""
    from gloo_tpu_torch.models import Transformer

    cfg = entry_mod.D256_F16_CONFIG
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd.launches = 0
    fn, (model, tokens) = entry_mod.d256_f16_entry(device)
    logits = fn(model, tokens)
    prompts = tokens[:4, :16]
    served = model.generate(prompts, max_new=8)
    torch.cuda.synchronize()
    launches = (attn.flash_attention_fwd.launches,
                attn.flash_attention_bwd.launches)
    cpu_model = Transformer(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    ref = entry_mod.forward(cpu_model, tokens.cpu())
    err, ok = max_err(logits.cpu(), ref, *D256_LOGITS_TOL)
    print(f"d256 f16 serving path ({cfg.n_heads} head of "
          f"{cfg.head_dim}, {str(cfg.dtype)[6:]}): forward logits "
          f"{tuple(logits.shape)}, generate {tuple(served.shape)}; "
          f"launches flash_fwd, flash_bwd {launches}; logits vs the CPU "
          f"model max_abs_err {err:.3e} (rtol, atol {D256_LOGITS_TOL}), "
          f"|logits| max {float(ref.abs().max()):.3f}")
    if launches != (cfg.n_layers, 0):
        raise AssertionError(f"the d256 f16 serving path launched (B1, B2) "
                             f"{launches}, expected ({cfg.n_layers}, 0)")
    if logits.shape != (8, cfg.max_seq_len, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()) or not ok:
        raise AssertionError("the d256 f16 logits are malformed or disagree "
                             "with the CPU model")
    if not torch.equal(served[:, :16], prompts) \
            or int(served.min()) < 0 or int(served.max()) >= cfg.vocab_size:
        raise AssertionError("d256 f16 generate returned malformed tokens")
    return fn, model, tokens, prompts


def d256_training(attn, entry_mod, device="cuda"):
    """Phase 31's training path: TRAIN_STEPS steps of
    d256_f16_train_entry(), B1/B2's launches read around them, a falling
    loss, the first step against the CPU model. Returns the step's
    (step, (model, optimizer, tokens, targets))."""
    from gloo_tpu_torch.models import Transformer

    cfg = entry_mod.D256_F16_CONFIG
    step, args = entry_mod.d256_f16_train_entry(device)
    model, opt, tokens, targets = args
    cpu_model = Transformer(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_loss = cpu_model.loss(tokens.cpu(), targets.cpu())
    cpu_loss.backward()
    cpu_loss = float(cpu_loss.detach())
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd.launches = 0
    losses = [step(*args)]
    first = {n: p.grad.clone() for n, p in model.named_parameters()}
    losses += [step(*args) for _ in range(TRAIN_STEPS - 1)]
    torch.cuda.synchronize()
    launches = (attn.flash_attention_fwd.launches,
                attn.flash_attention_bwd.launches)
    losses = [float(x) for x in losses]
    loss_rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    grad_rel = {n: rel_norm(first[n].cpu(), p.grad)
                for n, p in cpu_model.named_parameters()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"d256 f16 training path: {TRAIN_STEPS} steps, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; launches flash_fwd, "
          f"flash_bwd {launches}; first step vs the CPU model: loss rel "
          f"{loss_rel:.3e} (tol {D256_TRAIN_TOL['loss']}), grads |g - "
          f"g_cpu| / |g_cpu| max {grad_rel[worst]:.3e} at {worst} (tol "
          f"{D256_TRAIN_TOL['grad']})")
    want = TRAIN_STEPS * cfg.n_layers
    if launches != (want, want):
        raise AssertionError(f"d256 f16 training launched (B1, B2) "
                             f"{launches}, expected ({want}, {want})")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        raise AssertionError(f"d256 f16 training loss is not finite and "
                             f"falling: {losses}")
    if loss_rel > D256_TRAIN_TOL["loss"] \
            or grad_rel[worst] > D256_TRAIN_TOL["grad"]:
        raise AssertionError("the first d256 f16 training step disagrees "
                             "with the CPU model")
    return step, args


def d256_ring_flash(attn, sp, make_mesh, entry_mod, device="cuda"):
    """Phase 31's ring-flash: sp_step(ring_flash_attention) at one head of
    256 in f16 over SP_MESH ranks of the global SP_SEQ, B6/B7's launches
    (B6, B7, prep, finish) read around it, against the same ring on the
    CPU. Returns (fn, args)."""
    from gloo_tpu_torch.entry import SP_MESH, SP_SEQ

    n = SP_MESH["seq"]
    dev = torch.device(device)
    shape = (n, D256_SP_BATCH, 1, SP_SEQ // n, 256)
    rng = np.random.RandomState(0)
    host = [torch.as_tensor(rng.randn(*shape).astype(np.float32)).half()
            for _ in range(3)]
    counters = (attn.flash_attention_step, attn.flash_attention_bwd_step,
                attn.prepare_bwd_step, attn.flash_bwd_step_finish)
    results = []
    for i, where in enumerate((dev, torch.device("cpu"))):
        mesh = make_mesh(SP_MESH, devices=[where] * n)
        args = (sp.ring_flash_attention, *(x.to(where) for x in host), mesh)
        for c in counters:
            c.launches = 0
        out, grads = entry_mod.sp_step(*args)
        if i == 0:
            torch.cuda.synchronize()
            launches = tuple(c.launches for c in counters)
            on_card = args
        results.append([x.cpu() for x in (out, *grads)])
    rels = {name: rel_norm(a, b) for name, a, b in
            zip(("out", "dq", "dk", "dv"), *results)}
    print(f"d256 f16 ring-flash path: {n} ranks x (b {D256_SP_BATCH}, h 1, "
          f"t {SP_SEQ // n}, d 256) f16 causal, forward + backward of "
          f"sum(sin(out)); launches flash_step, flash_bwd_step, prepare, "
          f"finish {launches}; against the same ring on the CPU |a - b| / "
          f"|b|: {', '.join(f'{k} {v:.3e}' for k, v in rels.items())} (tol "
          f"{D256_SP_TOL})")
    if launches != (n, n, 1, 1):
        raise AssertionError(f"the d256 f16 ring-flash launched {launches}, "
                             f"expected ({n}, {n}, 1, 1)")
    if max(rels.values()) > D256_SP_TOL or not all(
            bool(torch.isfinite(x.float()).all()) for x in results[0]):
        raise AssertionError("the d256 f16 ring-flash disagrees with the "
                             "CPU")
    return entry_mod.sp_step, on_card


def d256_fused_mlp(ov, tp, ring, make_mesh, gen, cfg):
    """Phase 31's fused MLP in f16: phase 13's Megatron-SP pair at the
    flagship's widths over a ring of 4 ranks of 256 rows (1024 rows in
    all), forward and backward, the launches (B5b, B5a, B4b) read around
    it, against the dense MLP on the card. Returns (fn, leaves, mesh)."""
    n, d, f = 4, cfg.d_model, cfg.d_ff
    rows = 8 * cfg.max_seq_len // n
    dev = torch.device("cuda")
    mesh = make_mesh({"x": n}, devices=[dev] * n)
    big = [torch.randn(shape, generator=gen, device=dev) / scale
           for shape, scale in (((n * rows, d), 1.0), ((d, f), math.sqrt(d)),
                                ((f, d), math.sqrt(f)),
                                ((n * rows, d), 1.0))]
    big_x, big_up, big_down, dy = (x.half() for x in big)
    leaves = [big_x.view(n, rows, d).clone().requires_grad_(),
              big_up.view(d, n, f // n).permute(1, 0, 2).contiguous()
              .requires_grad_(),
              big_down.view(n, f // n, d).clone().requires_grad_()]
    counters = (ov.allgather_matmul, ov.matmul_reduce_scatter,
                ring.ring_allgather)
    for c in counters:
        c.launches = 0
    y = mlp_pair(tp, *leaves, "x", mesh)
    y.backward(dy.view(n, rows, d))
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    refs = [t.detach().clone().requires_grad_()
            for t in (big_x, big_up, big_down)]
    ref = dense_dot(F.gelu(dense_dot(refs[0], refs[1]), approximate="tanh"),
                    refs[2])
    ref.backward(dy)
    x, w_up, w_down = leaves
    rels = {"y": rel_norm(y.detach().reshape(n * rows, d), ref.detach()),
            "dx": rel_norm(x.grad.reshape(n * rows, d), refs[0].grad),
            "dw_up": rel_norm(w_up.grad.permute(1, 0, 2).reshape(d, f),
                              refs[1].grad),
            "dw_down": rel_norm(w_down.grad.reshape(f, d), refs[2].grad)}
    print(f"d256 f16 fused MLP: {n} ranks x {rows} rows, d_model {d}, d_ff "
          f"{f}, f16, forward + backward; launches allgather_matmul, "
          f"matmul_reduce_scatter, ring_allgather {launches}; against the "
          f"dense MLP on the card |a - b| / |b|: "
          f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())} (tol "
          f"{D256_MLP_TOL})")
    if launches != (1, 2, 1):
        raise AssertionError(f"the f16 fused MLP launched {launches}, "
                             f"expected (1, 2, 1)")
    if max(rels.values()) > D256_MLP_TOL \
            or not bool(torch.isfinite(y.detach().float()).all()):
        raise AssertionError("the f16 fused MLP disagrees with the dense "
                             "MLP")

    def once():
        for t in leaves:
            t.grad = None
        mlp_pair(tp, *leaves, "x", mesh).backward(dy.view(n, rows, d))

    return once, leaves, mesh


def d256_f16_phase(attn, ov, tp, ring, sp, spmd, make_mesh, entry_mod, gen,
                   card, rows, bwd_rows):
    """Phase 31: the flagship at one head of 256 in f16 (D256_F16_CONFIG):
    serving, training, its ring-flash and its fused MLP, each checked with
    its launch counts read around it, then timed (ms per call by CUDA
    events, device ms, busy share); B6 and B7 per launch at the ring-flash
    shape; B5b and B5a in f16 at the fused MLP's shapes (overlap_times);
    B1/B2's phase 7 rows at d256_f16_path and bh65540 gathered. Prints
    one JSON line {"d256_f16_path": ...}."""
    fn, model, tokens, prompts = d256_serving(attn, entry_mod)
    step, targs = d256_training(attn, entry_mod)
    sp_fn, sp_args = d256_ring_flash(attn, sp, make_mesh, entry_mod)
    mlp_fn, mlp_leaves, mlp_mesh = d256_fused_mlp(
        ov, tp, ring, make_mesh, gen, entry_mod.D256_F16_CONFIG)
    print(f"d256 f16 path times on {card}:")
    paths = {}
    for label, call in (
            ("serving forward (batch 8, seq 128)",
             lambda: fn(model, tokens)),
            ("generate (4 prompts of 16 tokens, 8 new, greedy)",
             lambda: model.generate(prompts, max_new=8)),
            ("training step (batch 8, seq 128, Adam)",
             lambda: step(*targs)),
            ("ring-flash forward + backward", lambda: sp_fn(*sp_args)),
            ("fused MLP forward + backward", mlp_fn)):
        ms, dev = path_time(f"d256 f16 {label}", call)
        paths[label] = {"ms": ms, "device_ms": dev,
                        "busy": None if dev is None else dev / ms}
    _, q, k, v, mesh = sp_args
    steps = step_kernel_times(attn, sp, spmd, q, k, v, mesh, card,
                              "the d256 f16 ring-flash's")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels = {f"{name} {case}": dict(zip(keys, table[case]))
               for name, table in (("flash_fwd", rows),
                                   ("flash_bwd", bwd_rows))
               for case in ("d256_f16_path", "bh65540", "entry",
                            "f16_entry")}
    kernels.update({f"{name} d256_f16_pathS": dict(zip(keys, steps[name]))
                    for name in ("flash_step", "flash_bwd_step")})
    # B5b and B5a in f16 at the fused MLP's shapes: the kernels beside
    # their plain versions, library yardsticks and f16 bounds.
    print(f"collective matmul times in f16 at the fused MLP's shapes on "
          f"{card}:")
    x_h, up_h, down_h = (t.detach() for t in mlp_leaves)
    with torch.no_grad():
        hidden_h = F.gelu(torch.matmul(
            x_h.reshape(1, -1, x_h.shape[2]), up_h), approximate="tanh")
    f16_rows = overlap_times(ov, mlp_mesh, x_h, up_h, down_h, hidden_h)
    kernels.update({f"{name} f16_mlp": dict(zip(keys, row))
                    for name, row in f16_rows.items()})
    print(json.dumps({"d256_f16_path": {"paths": paths,
                                        "kernels": kernels}}))


# ---- phases 26-28: the host plane, two processes on the card ----
# Each phase re-invokes this script with --worker in HOST_RANKS processes,
# which rendezvous over a FileStore in a new temporary directory and share
# the card. A worker prints its lines and, last, one JSON object.
HOST_RANKS = 2
# Element sizes of phase 26's tensors: 1 KiB and 16 MiB of each dtype.
STAGE_BYTES = (1 << 10, 16 << 20)
STAGE_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
# Rounds of phases 26 and 27's comparisons: a stale copy (a non-blocking
# copy read before its stream was synchronized, a pinned buffer reused
# before its copy to the card completed) shows only some of the time.
HOST_ROUNDS = 3
HOST_STEPS = 5
WORKER_TIMEOUT = 600


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8))


def digest(tensors):
    """sha256 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def run_workers(phase, timeout=WORKER_TIMEOUT, size=HOST_RANKS, killed=(),
                env=None):
    """Runs phase `phase`'s worker in `size` processes of this script
    (with `env` added to their environment); prints their output and
    returns their JSON results, None for each rank of `killed`. Raises if
    a rank of `killed` ends other than by SIGKILL, if any other worker
    exits non-zero or prints no result, or if one outlives `timeout`; no
    worker is left running."""
    import signal
    import sys
    import tempfile

    store = tempfile.mkdtemp(prefix=f"chip_smoke-{phase}-")
    os.makedirs(os.path.join(store, "rdv"))
    procs, logs = [], []
    for rank in range(size):
        out = open(os.path.join(store, f"out{rank}.txt"), "w+")
        err = open(os.path.join(store, f"err{rank}.txt"), "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", phase,
             str(rank), str(size), os.path.join(store, "rdv")],
            stdout=out, stderr=err, env=dict(os.environ, **(env or {}))))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        out.seek(0)
        err.seek(0)
        lines, errors = out.read().splitlines(), err.read()
        if rank in killed:
            for line in lines:
                print(f"  [worker {rank}] {line}")
            if p.returncode != -signal.SIGKILL:
                raise AssertionError(f"phase {phase}: worker {rank} exited "
                                     f"{p.returncode}, not by its planned "
                                     f"SIGKILL:\n{errors[-6000:]}")
            print(f"  [worker {rank}] ended by its planned SIGKILL")
            results.append(None)
            continue
        for line in lines[:-1]:
            print(f"  [worker {rank}] {line}")
        if p.returncode != 0 or not lines:
            raise AssertionError(f"phase {phase}: worker {rank} exited "
                                 f"{p.returncode}:\n{errors[-6000:]}")
        results.append(json.loads(lines[-1]))
    return results


def host_context(rank, size, store):
    from gloo_tpu_torch import Context, Device, FileStore

    ctx = Context(rank, size, timeout=120.0)
    ctx.connect_full_mesh(FileStore(store), Device())
    return ctx


def stage_input(dtype, nbytes, gen):
    n = nbytes // torch.tensor([], dtype=dtype).element_size()
    if dtype.is_floating_point:
        return torch.randn(n, generator=gen).to(dtype)
    return torch.randint(-1000, 1000, (n,), generator=gen, dtype=dtype)


def worker_staging(rank, size, store, device="cuda"):
    """Phase 26 on one rank: allreduce (sum, max), broadcast, allgather and
    reduce_scatter of f32, bf16 and int32 tensors of 1 KiB and 16 MiB on
    the card, each bitwise against the same call on a CPU copy, for
    HOST_ROUNDS rounds."""
    ctx = host_context(rank, size, store)
    gen = torch.Generator().manual_seed(1000 + rank)
    calls = (("allreduce sum", lambda t: ctx.allreduce(t, tag=1)),
             ("allreduce max", lambda t: ctx.allreduce(t, op="max", tag=2)),
             ("broadcast", lambda t: ctx.broadcast(t, root=1, tag=3)),
             ("allgather", lambda t: ctx.allgather(t, tag=4)),
             ("reduce_scatter", lambda t: ctx.reduce_scatter(t, tag=5)))
    wrong, cases = [], 0
    for round_ in range(HOST_ROUNDS):
        for dtype in STAGE_DTYPES:
            for nbytes in STAGE_BYTES:
                x = stage_input(dtype, nbytes, gen)
                on_card = x.to(device)
                for label, call in calls:
                    got = call(on_card.clone())
                    want = call(x.clone())
                    cases += 1
                    if got.device.type != torch.device(device).type \
                            or not same_bits(got.cpu(), want):
                        wrong.append(f"round {round_} {dtype} {nbytes} B "
                                     f"{label}")
    ctx.barrier()
    ctx.close()
    return {"cases": cases, "wrong": wrong}


def full_batch_grads(entry_mod):
    """Loss and gradients of train_entry()'s model over the whole entry
    batch on the card: the reference of phases 27 and 28's first steps."""
    _, (model, _, tokens, targets) = entry_mod.train_entry()
    loss = model.loss(tokens, targets)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()}


def grad_rel(grads, ref):
    """max over parameters of |g - g_ref| / |g_ref|, and where."""
    rel = {n: float((grads[n].float() - g.float()).norm() / g.float().norm())
           for n, g in ref.items()}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def worker_host_sync(rank, size, store, device="cuda"):
    """Phase 27 on one rank: HostGradSync's sequential and bucketed arms,
    and the sequential arm over the q8 wire, on one replica's CUDA
    gradients of the flagship, each bitwise against the same arm on CPU
    copies; then HOST_STEPS steps of host_ddp_entry."""
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.parallel import HostGradSync

    step, (model, optimizer, batch) = entry_mod.host_ddp_entry(
        rank, size, store, device)
    sync = step.sync
    ctx = sync.context
    model.loss(*batch).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    wrong = []
    for arm, arm_sync in (("sequential", HostGradSync(ctx)),
                          ("bucketed", sync),
                          ("sequential q8", HostGradSync(ctx, wire="q8"))):
        for round_ in range(HOST_ROUNDS):
            results = []
            for leaves in (grads, {n: g.cpu() for n, g in grads.items()}):
                if arm.endswith("q8"):
                    # A reused q8 plan gives other bits than a fresh one
                    # (ROADMAP.md C.7): both calls start with none.
                    ctx.plan_cache_clear()
                    ctx.barrier()
                results.append(arm_sync.average(leaves))
            got, want = results
            bad = [n for n in grads if got[n].device != grads[n].device
                   or not same_bits(got[n].cpu(), want[n])]
            if bad:
                wrong.append(f"{arm} round {round_}: {bad[:3]}")
    losses = [float(step(model, optimizer, batch))]
    first = {n: p.grad.clone() for n, p in model.named_parameters()}
    losses += [float(step(model, optimizer, batch))
               for _ in range(HOST_STEPS - 1)]
    torch.cuda.synchronize()
    out = {"wrong": wrong, "losses": losses,
           "params": digest(model.parameters()),
           "first_grads": digest(first.values()),
           "bytes": sum(g.numel() * g.element_size()
                        for g in grads.values())}
    if rank == 0:
        out["ref_loss"], ref = full_batch_grads(entry_mod)
        out["grad_rel"], out["grad_worst"] = grad_rel(first, ref)
    ctx.barrier()
    ctx.close()
    return out


def host_hop_times(ctx, numel, device, iters=10):
    """The host hop of one two-level step apart, on an f32 buffer of
    `numel` on the card: D2H into pinned memory and H2D back (CUDA events,
    ms and GB/s), the host allreduce of the pinned buffer (host clock),
    and the whole staged ctx.allreduce (host clock). Collective: every
    rank calls it together."""
    x = torch.randn(numel, device=device)
    host = torch.empty(numel, pin_memory=True)

    def copy_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    d2h = copy_ms(lambda: host.copy_(x, non_blocking=True))
    h2d = copy_ms(lambda: x.copy_(host, non_blocking=True))

    def host_ms(fn):
        fn()
        ctx.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    native = host_ms(lambda: ctx.allreduce(host, tag=0x71))
    staged = host_ms(lambda: ctx.allreduce(x, tag=0x72))
    nbytes = numel * 4
    return {"bytes": nbytes, "d2h_ms": d2h, "h2d_ms": h2d,
            "d2h_GBps": nbytes / d2h / 1e6, "h2d_GBps": nbytes / h2d / 1e6,
            "allreduce_host_ms": native, "staged_allreduce_ms": staged}


def worker_hier(rank, size, store, device="cuda"):
    """Phase 28 on one rank: HOST_STEPS steps of hier_ddp_entry with the
    launch counts read around them, then its times."""
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import ring

    step, (replicas, optimizers, batch) = entry_mod.hier_ddp_entry(
        rank, size, store, device)
    ctx = step.group.ctx
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd,
                ring.ring_allreduce)
    for c in counters:
        c.launches = 0
    losses = [step(replicas, optimizers, batch)]
    first = {n: p.grad.clone() for n, p in replicas[0].named_parameters()}
    losses += [step(replicas, optimizers, batch)
               for _ in range(HOST_STEPS - 1)]
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    losses = [float(x) for x in losses]
    params = [digest(m.parameters()) for m in replicas]
    numel = sum(p.numel() for p in replicas[0].parameters())
    out = {"launches": launches, "losses": losses, "params": params,
           "first_grads": digest(first.values()), "numel": numel}
    if rank == 0:
        dstep, (dreps, dopts, dbatch) = entry_mod.ddp_train_entry(device)
        out["ref_loss"] = float(dstep(dreps, dopts, dbatch))
        out["grad_rel"], out["grad_worst"] = grad_rel(first, {
            n: p.grad for n, p in dreps[0].named_parameters()})
        out["ref_launches"] = [c.launches for c in counters]

    def once():
        step(replicas, optimizers, batch)

    ctx.barrier()
    out["step_ms"] = event_ms(once, iters=10)
    ctx.barrier()
    out["device_ms"], rows = device_profile(once, iters=5, sessions=1)
    out["device_rows"] = rows[:8]
    ctx.barrier()
    out["hop"] = host_hop_times(ctx, numel, device)
    ctx.barrier()
    ctx.close()
    return out


# Phase 29: ELASTIC_RANKS processes on the card; launch rank
# ELASTIC_KILL[0] SIGKILLs itself at step ELASTIC_KILL[1], one trained
# step after the newest checkpoint (every ELASTIC_CKPT_EVERY = 2 steps),
# so that the restore has to roll the survivors back. The acceptance
# run trains steps 0 to ELASTIC_STEPS - 1, run_elastic RUN_ELASTIC_STEPS
# steps. The lease knobs make a lease expire after 1.2 s without renewal.
ELASTIC_RANKS = 3
ELASTIC_KILL = (2, 4)
ELASTIC_STEPS = 9
RUN_ELASTIC_STEPS = 6
ELASTIC_SETTLE = 3.0
LEASE_ENV = {"TPUCOLL_LEASE_MS": "200", "TPUCOLL_LEASE_GRACE": "1200"}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _share_cores(size):
    """Processes that share a host split its cores: torch's intra-op pool
    per process otherwise oversubscribes them, and the host plane's
    threads starve (a step many times its time alone)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))


def _kill_if_planned(rank, step):
    if (rank, step) == ELASTIC_KILL:
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


def worker_elastic(rank, size, store, device="cuda"):
    """Phase 29 on one process: elastic_train_entry's acceptance run. Rank
    0 checkpoints every ELASTIC_CKPT_EVERY steps and writes each saved
    state's sha256 into the launch's TcpStore; the planned victim dies;
    the survivors catch the IoError, rebuild, restore (checking that the
    live state differed from the checkpoint before, that the loaded state
    and afterwards every local replica with its Adam have rank 0's
    sha256, and that the tensors came back on the card) and train on to
    the last step with the launch counts read over the resumed steps."""
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.checkpoint import state_digest
    from gloo_tpu_torch.core import IoError
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import ring

    _share_cores(size)
    trainer = entry_mod.elastic_train_entry(
        rank, size, os.path.join(os.path.dirname(store), "ckpt"), device)
    kv = trainer.store()
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd,
                ring.ring_allreduce)
    out = {"losses": {}, "save_ms": [], "saved": []}
    step, resumed_at = 0, None
    while step < ELASTIC_STEPS:
        _kill_if_planned(rank, step)
        t0 = time.perf_counter()
        try:
            loss = float(trainer.step(step))
        except IoError as exc:
            if resumed_at is not None:
                raise
            print(f"step {step} failed ({str(exc)[:60]}); rebuilding",
                  flush=True)
            t0 = time.perf_counter()
            if not trainer.rebuild(generation=1, min_size=2,
                                   settle=ELASTIC_SETTLE):
                raise AssertionError("too few survivors") from exc
            out["rebuild_ms"] = (time.perf_counter() - t0) * 1e3
            newest = max(trainer.checkpointer.steps())
            before = state_digest(trainer.state(newest))
            t0 = time.perf_counter()
            at, state = trainer.restore()
            torch.cuda.synchronize()
            out["load_ms"] = (time.perf_counter() - t0) * 1e3
            if at is None:
                raise AssertionError("no committed checkpoint") from exc
            want = kv.get(f"elastic/sha256/{at}").decode()
            out["sha256"] = (state_digest(state), want)
            out["rolled_back"] = at == newest and before != want
            out["live_sha256"] = [state_digest(trainer.state(at, i))
                                  for i in range(len(trainer.replicas))]
            out["on_card"] = all(t.is_cuda for t in
                                 state["model"].values())
            out["restored"] = at
            out["size"] = trainer.ctx.size
            print(f"resumed from step {at} in a world of "
                  f"{trainer.ctx.size}", flush=True)
            step = resumed_at = at + 1
            for c in counters:
                c.launches = 0
            continue
        if step == resumed_at:
            out["resumed_step_ms"] = (time.perf_counter() - t0) * 1e3
        out["losses"][step] = loss
        t0 = time.perf_counter()
        if trainer.save(step):
            out["save_ms"].append((time.perf_counter() - t0) * 1e3)
            out["saved"].append(step)
            kv.set(f"elastic/sha256/{step}",
                   state_digest(trainer.state(step)).encode())
        step += 1
    torch.cuda.synchronize()
    out["launches"] = [c.launches for c in counters]
    out["resumed_steps"] = ELASTIC_STEPS - resumed_at
    flat = torch.cat([p.detach().float().reshape(-1)
                      for p in trainer.replicas[0].parameters()])
    gathered = trainer.ctx.allgather(flat)
    out["params_equal"] = all(torch.equal(row, flat) for row in gathered)
    out["replicas_equal"] = len({digest(m.parameters())
                                 for m in trainer.replicas}) == 1
    out["state_bytes"] = sum(
        t.numel() * t.element_size() for t in
        [*trainer.state(0)["model"].values(),
         *(v for st in trainer.optimizers[0].state.values()
           for v in st.values() if torch.is_tensor(v))])
    trainer.ctx.barrier()
    trainer.ctx.close()
    return out


def worker_run_elastic(rank, size, store, device="cuda"):
    """Phase 29's second part on one process: elastic.run_elastic over one
    flagship replica on the card (elastic_step_fn: gradients averaged with
    the epoch's bucketer), the port's StepCheckpointer as its
    checkpointer, the planned victim dying at its step."""
    from gloo_tpu_torch import Device, FileStore, elastic
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.checkpoint import StepCheckpointer

    _share_cores(size)
    ckpt = StepCheckpointer(os.path.join(os.path.dirname(store), "ckpt"),
                            keep=entry_mod.ELASTIC_KEEP)
    step_fn, template = entry_mod.elastic_step_fn(rank, ckpt, device)

    def killing(ectx, step, state):
        _kill_if_planned(rank, step)
        return step_fn(ectx, step, state)

    t0 = time.perf_counter()
    summary = elastic.run_elastic(
        killing, store=FileStore(store), device=Device(), rank=rank,
        world_size=size, steps=RUN_ELASTIC_STEPS, min_size=2,
        checkpointer=ckpt, template=template, timeout=120.0)
    torch.cuda.synchronize()
    return {"rebuilds": summary["rebuilds"], "steps": summary["steps"],
            "sizes": [e["size"] for e in summary["epochs"]],
            "size": summary["elastic"]["size"],
            "rebuild_ms": summary["rebuild_ms"],
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "params": digest(step_fn.model.parameters())}


# ---- phase 30: the rest of the Context surface, three processes ----
# SURFACE_RANKS processes (a group size that is not a power of two) run
# every call of the rest of the host plane's Context surface on CUDA
# tensors of STAGE_DTYPES x STAGE_BYTES, each bitwise against the same
# call on a CPU copy, for HOST_ROUNDS rounds; then the host-clock ms per
# call at SURFACE_TIME_BYTES of f32, a median of SURFACE_TIME_ITERS calls.
SURFACE_RANKS = 3
PLAN_REPLAYS = 5
SURFACE_TIME_BYTES = 16 << 20
SURFACE_TIME_ITERS = 10


def split_counts(n, size, shift):
    """n elements split over `size` ranks unevenly, one rank taking 0,
    rotated by `shift`."""
    parts = [0] + [n * k // (size - 1) - n * (k - 1) // (size - 1)
                   for k in range(1, size)]
    return parts[shift % size:] + parts[:shift % size]


def surface_calls(ctx, engine, n, dtype):
    """(label, call) of every call the phase checks, for tensors of n
    elements: call(t) takes the rank's input (on the card or a CPU copy)
    and returns a tensor, a list of tensors, or None off root."""
    from gloo_tpu_torch import core

    size, rank = ctx.size, ctx.rank
    counts = split_counts(n, size, 0)
    in_counts = split_counts(n, size, rank)
    out_counts = [split_counts(n, size, r)[rank] for r in range(size)]
    rows = n // size * size
    calls = []
    for root in range(size):
        calls += [
            (f"reduce sum root {root}",
             lambda t, root=root: ctx.reduce(t, root=root, tag=1)),
            (f"reduce max root {root}",
             lambda t, root=root: ctx.reduce(t, root=root, op="max", tag=2)),
            (f"gather root {root}",
             lambda t, root=root: ctx.gather(t, root=root, tag=3)),
            (f"gatherv root {root}", lambda t, root=root: ctx.gatherv(
                t[:counts[rank]], counts, root=root, tag=4)),
            (f"scatter root {root}", lambda t, root=root: ctx.scatter(
                t[:rows].view(size, -1) if rank == root else None,
                root=root, output=None if rank == root else torch.empty(
                    rows // size, dtype=t.dtype, device=t.device), tag=5))]
    calls += [
        ("allgatherv", lambda t: ctx.allgatherv(t[:counts[rank]], counts,
                                                tag=6)),
        ("alltoall", lambda t: ctx.alltoall(t[:rows].view(size, -1), tag=7)),
        ("alltoallv", lambda t: ctx.alltoallv(t, in_counts, out_counts,
                                              tag=8)),
        ("allreduce_multi", lambda t: ctx.allreduce_multi(
            [t, t * 2, t.flip(0)], tag=9)),
        ("reduce_scatter_inplace", lambda t: ctx.reduce_scatter_inplace(
            t[:rows], tag=10).clone()),
        ("allgather output=", lambda t: ctx.allgather(
            t, output=torch.empty(size * n, dtype=t.dtype, device=t.device),
            tag=11)),
        ("reduce_scatter output=", lambda t: ctx.reduce_scatter(
            t[:rows], output=torch.empty(rows // size, dtype=t.dtype,
                                         device=t.device), tag=12)),
        ("reduce_scatter async", lambda t: engine.reduce_scatter_async(
            t[:rows]).wait()),
        ("allgather async", lambda t: engine.allgather_async(t).wait()),
        ("send/recv ring", lambda t: ring_pass(ctx, t))]
    if dtype == torch.float32:
        calls += [
            ("callable sum", lambda t: ctx.allreduce(
                t, op=lambda acc, inp: acc.add_(inp), tag=13)),
            ("q8 encode", lambda t: q8_fresh(ctx, core.q8_encode, t)),
            ("q8 decode", lambda t: q8_fresh(
                ctx, lambda w: core.q8_decode(w, n), core.q8_encode(t)))]
    return calls


def ring_pass(ctx, t):
    """`t` once around the ring: rank 0 sends to rank 1 first, each other
    rank receives from its left, then sends on; returns what arrived."""
    got = torch.empty_like(t)
    right, left = (ctx.rank + 1) % ctx.size, (ctx.rank - 1) % ctx.size
    if ctx.rank == 0:
        ctx.send(t, right, slot=20)
        ctx.recv(got, left, slot=20)
    else:
        ctx.recv(got, left, slot=20)
        ctx.send(t, right, slot=20)
    return got


def q8_fresh(ctx, fn, t):
    """A q8 call after the plan cache is cleared on every rank (ROADMAP.md
    C.7: the q8 wire gives other bits on a reused native plan)."""
    ctx.plan_cache_clear()
    ctx.barrier()
    return fn(t)


def as_list(result):
    return result if isinstance(result, list) else [result]


def median_call_ms(ctx, *fns, iters=SURFACE_TIME_ITERS):
    """Median host-clock ms of `iters` calls of each of `fns`, each call
    entered after a barrier and ended by a synchronize of the card; the
    functions take turns, in an order reversed every round."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for i in range(iters):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for k in order:
            ctx.barrier()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return [float(np.median(t)) for t in times]


def worker_surface(rank, size, store, device="cuda"):
    """Phase 30 on one rank: every call of surface_calls and each plan's
    PLAN_REPLAYS replays on CUDA tensors, bitwise against the same call on
    a CPU copy, for HOST_ROUNDS rounds; then their times."""
    ctx = host_context(rank, size, store)
    engine = ctx.async_engine(lanes=2)
    gen = torch.Generator().manual_seed(3000 + rank)
    wrong, cases = [], 0

    def check(label, got, want):
        nonlocal cases
        cases += 1
        got, want = as_list(got), as_list(want)
        if len(got) != len(want) or any(
                (g is None) != (w is None) or (g is not None and (
                    g.device.type != torch.device(device).type
                    or not same_bits(g.cpu(), w)))
                for g, w in zip(got, want)):
            wrong.append(label)

    for round_ in range(HOST_ROUNDS):
        for dtype in STAGE_DTYPES:
            for nbytes in STAGE_BYTES:
                x = stage_input(dtype, nbytes, gen)
                n = x.numel()
                tag = f"round {round_} {dtype} {nbytes} B"
                for label, call in surface_calls(ctx, engine, n, dtype):
                    check(f"{tag} {label}", call(x.to(device, copy=True)),
                          call(x.clone()))
                rows = n // size * size
                on_card = x.to(device, copy=True)
                plans = {
                    "allreduce_plan": (ctx.allreduce_plan(on_card, tag=14),
                                       lambda t: ctx.allreduce(t, tag=15)),
                    "reduce_scatter_plan": (
                        ctx.reduce_scatter_plan(on_card[:rows], tag=16),
                        lambda t: ctx.reduce_scatter(t[:rows], tag=17)),
                    "allgather_plan": (ctx.allgather_plan(on_card, tag=18),
                                       lambda t: ctx.allgather(t, tag=19))}
                for replay in range(PLAN_REPLAYS):
                    fresh = stage_input(dtype, nbytes, gen)
                    for label, (plan, per_call) in plans.items():
                        on_card.copy_(fresh)
                        check(f"{tag} {label} replay {replay}", plan(),
                              per_call(fresh.clone()))
    ctx.barrier()

    # Times at SURFACE_TIME_BYTES of f32 on the card.
    x = stage_input(torch.float32, SURFACE_TIME_BYTES, gen).to(device)
    n = x.numel()
    times = {label: median_call_ms(ctx, lambda call=call: call(x.clone()))[0]
             for label, call in surface_calls(ctx, engine, n, torch.float32)
             if "root" not in label or label.endswith("root 0")}
    rows = n // size * size
    plan_times = {}
    for label, plan, per_call in (
            ("allreduce", ctx.allreduce_plan(x, tag=14),
             lambda: ctx.allreduce(x, tag=15)),
            ("reduce_scatter", ctx.reduce_scatter_plan(x[:rows], tag=16),
             lambda: ctx.reduce_scatter(x[:rows], tag=17)),
            ("allgather", ctx.allgather_plan(x, tag=18),
             lambda: ctx.allgather(x, tag=19))):
        plan_times[label] = median_call_ms(ctx, plan, per_call)
    ctx.barrier()
    engine.shutdown()
    ctx.close()
    return {"cases": cases, "wrong": wrong, "times": times,
            "plan_times": plan_times, "bytes": x.numel() * 4}


def surface_phase(card):
    """Phase 30: the rest of the Context surface in SURFACE_RANKS
    processes on the card."""
    t0 = time.perf_counter()
    res = run_workers("30", size=SURFACE_RANKS)
    wall = time.perf_counter() - t0
    cases = sum(r["cases"] for r in res)
    wrong = [w for r in res for w in r["wrong"]]
    print(f"rest of the Context surface on CUDA tensors ({SURFACE_RANKS} "
          f"processes on the card, {HOST_ROUNDS} rounds, {wall:.1f} s): "
          f"{cases} calls of reduce sum/max, gather, gatherv, scatter at "
          f"every root, allgatherv, alltoall, alltoallv (uneven counts "
          f"with a 0), allreduce_multi, reduce_scatter_inplace, output=, "
          f"the async reduce-scatter and allgather, send/recv around the "
          f"ring, a callable sum and q8 encode/decode on f32, and "
          f"{PLAN_REPLAYS} replays of each plan, at f32/bf16/int32 x "
          f"{STAGE_BYTES} bytes, against the same calls on CPU copies: "
          f"{'all bitwise equal and on cuda' if not wrong else 'DIFFER ' + str(wrong[:20])}")
    if wrong:
        raise AssertionError(f"phase 30: staged calls differ from the CPU "
                             f"calls: {wrong[:20]}")
    nbytes = res[0]["bytes"]
    print(f"host-clock ms per call at {nbytes} bytes of f32 on the card, "
          f"median of {SURFACE_TIME_ITERS}, processes 0/1/2 [{card}]:")
    for label in res[0]["times"]:
        print(f"  {label}: " + " / ".join(
            f"{r['times'][label]:.3f}" for r in res))
    print(f"plan replay vs per-call ms at {nbytes} bytes of f32, median of "
          f"{SURFACE_TIME_ITERS} in turns, processes 0/1/2 [{card}]:")
    for label in res[0]["plan_times"]:
        print(f"  {label}: plan " + " / ".join(
            f"{r['plan_times'][label][0]:.3f}" for r in res) + ", per call "
            + " / ".join(f"{r['plan_times'][label][1]:.3f}" for r in res))
    return res


# Phase 32: phase 28's two-level step in HOST_RANKS processes over an
# encrypted transport keyed per rank, with the native tracer, the phase
# profiler, the span recorder and the fleet plane on, a telemetry endpoint
# on rank 0, a scripted fault, and the elected schedule and tuning table.
TRACED_ROOT = "chip-smoke-launcher-root"
TRACED_DELAY_MS = 50
TRACED_DELAYS = 4
TRACED_SWEEP = (1 << 10, 1 << 20)
TRACED_TIMING_ROUNDS = 3
TRACED_PLANES = ("profile", "spans", "trace", "fleet")
TRACED_ENV = {"TPUCOLL_FLEETOBS_INTERVAL_MS": "100",
              "TPUCOLL_FLEETOBS_WINDOW": "5", "TPUCOLL_SPANS_RING": "65536"}
# A sample line of a Prometheus text exposition: name{labels} value.
PROMETHEUS_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? '
                               r'([0-9eE.+-]+|NaN|[+-]Inf)$')


def prometheus_samples(text):
    """The sample lines of a Prometheus text exposition; raises on a line
    that is neither a # HELP / # TYPE comment nor a sample."""
    samples = []
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        if not PROMETHEUS_SAMPLE.match(line):
            raise AssertionError(f"/metrics: unparseable line {line!r}")
        samples.append(line)
    return samples


def last_algo(ctx, op="allreduce"):
    """The algorithm of the context's newest `op` in its flight recorder."""
    return [e["algo"] for e in ctx.flightrec()["events"]
            if e["op"] == op][-1]


def worker_traced(rank, size, store, device="cuda"):
    """Phase 32 on one rank: see traced_phase."""
    import urllib.error
    import urllib.request

    from gloo_tpu_torch import (Context, Device, FileStore, crypto_isa_tier,
                                derive_keyring, fault, schedule, tuning,
                                uring_available)
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.utils import fleet as fleet_util
    from gloo_tpu_torch.utils import telemetry

    ctx = Context(rank, size, timeout=120.0)
    dev_obj = Device(keyring=derive_keyring(TRACED_ROOT, rank, size),
                     encrypt=True)
    ctx.connect_full_mesh(FileStore(store), dev_obj)
    step, (replicas, optimizers, batch) = entry_mod.hier_ddp_entry(
        rank, size, store, device, context=ctx)
    group = step.group
    out = {"uring": uring_available(), "isa_tier": crypto_isa_tier(),
           "engine": dev_obj.engine_stats(), "algo": group._hier_algo}

    def planes(on=TRACED_PLANES):
        """Turn on the planes named in `on`, and the others off."""
        ctx.profile_enable("profile" in on)
        ctx.spans_enable("spans" in on)
        if "trace" in on:
            ctx.trace_start()
        else:
            ctx.trace_stop()
        if "fleet" in on:
            ctx.fleetobs_start()
        else:
            ctx.fleetobs_stop()

    planes()
    server = telemetry.serve_telemetry(ctx, port=0) if rank == 0 else None

    # HOST_STEPS steps with every plane on, the launches read around them.
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd,
                ring.ring_allreduce)
    for c in counters:
        c.launches = 0
    losses = [float(step(replicas, optimizers, batch))
              for _ in range(HOST_STEPS)]
    torch.cuda.synchronize()
    out["launches"] = [c.launches for c in counters]
    out["losses"] = losses
    out["params"] = digest(p for m in replicas for p in m.parameters())
    out["numel"] = sum(p.numel() for p in replicas[0].parameters())
    out["trace"] = ctx.trace_json()
    spans = ctx.spans()
    out["spans"] = spans

    # The fleet plane: rank 0 waits for both ranks' reports; every rank
    # allreduces a flag each round, so that both stay up until it has.
    doc, deadline = None, time.monotonic() + 30.0
    while True:
        flag = torch.zeros(1)
        if rank == 0 and doc is None:
            got = ctx.fleet()
            if fleet_util.coverage(got)["complete"]:
                doc = got
        flag[0] = float(doc is not None)
        ctx.allreduce(flag)
        if flag[0] > 0 or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    if rank == 0:
        doc = doc or ctx.fleet()
        out["coverage"] = fleet_util.coverage(doc)

        def get(route):
            try:
                with urllib.request.urlopen(server.url + route,
                                            timeout=10) as resp:
                    return resp.status, resp.read().decode()
            except urllib.error.HTTPError as err:
                return err.code, err.read().decode()

        code, body = get("/healthz")
        out["healthz"] = [code, json.loads(body)]
        code, text = get("/metrics")
        out["metrics"] = [code, len(prometheus_samples(text))]
    ctx.barrier()
    ctx.fleetobs_stop()

    # A delay of TRACED_DELAY_MS on rank 1's data sends during one step.
    before = max((o["cseq"] for o in ctx.profile()["ops"]), default=-1)
    fault.install({"seed": 32, "faults": [
        {"when": {"rank": 1, "opcode": "data", "min_bytes": 1024},
         "action": "delay", "ms": TRACED_DELAY_MS,
         "count": TRACED_DELAYS}]})
    try:
        ctx.barrier()
        step(replicas, optimizers, batch)
        torch.cuda.synchronize()
        ctx.barrier()
        out["fired"] = fault.report(rank=rank)
    finally:
        fault.clear()
    out["fault_before"] = before
    out["profile"] = ctx.profile()

    # The tuner and the sweep from 1 KiB to 1 MiB.
    t0 = time.perf_counter()
    tuned = tuning.tune(ctx, min_bytes=TRACED_SWEEP[0],
                        max_bytes=TRACED_SWEEP[1])
    out["tune_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    elected = schedule.sweep(ctx, min_bytes=TRACED_SWEEP[0],
                             max_bytes=TRACED_SWEEP[1])
    out["sweep_s"] = time.perf_counter() - t0
    out["tuned"] = json.dumps(tuned, sort_keys=True)
    out["elected"] = json.dumps(elected, sort_keys=True)

    # The host hop of the step's gradient buffer (every gradient as f32,
    # flat, on the card) under the elected table against the native
    # dispatch and against the same call on a CPU copy; then under the
    # elected table with a schedule of the sweep also elected for the
    # buffer's size (past the swept sizes), so that one really runs.
    buf = torch.cat([p.grad.detach().float().reshape(-1)
                     for p in replicas[0].parameters()])

    def hop(x):
        ctx.plan_cache_clear()
        ctx.barrier()
        ctx.allreduce(x, tag=group.tag, algorithm=group._hier_algo)
        return x.cpu(), last_algo(ctx)

    schedule.clear(ctx)
    native, native_algo = hop(buf.clone())
    schedule.install(ctx, elected)
    staged, staged_algo = hop(buf.clone())
    on_cpu, _ = hop(buf.cpu().clone())
    forced = schedule_for_size(schedule, elected, size, buf.numel() * 4)
    schedule.install(ctx, forced)
    f_staged, forced_algo = hop(buf.clone())
    f_cpu, _ = hop(buf.cpu().clone())
    schedule.install(ctx, elected)
    out["bits"] = {"elected_vs_native": same_bits(staged, native),
                   "elected_vs_cpu": same_bits(staged, on_cpu),
                   "forced_vs_native": same_bits(f_staged, native),
                   "forced_vs_cpu": same_bits(f_staged, f_cpu)}
    out["hop_algos"] = [native_algo, staged_algo, forced_algo]
    out["forced_schedule"] = forced["elections"][-1]["schedule"]

    # ms per step with the planes off and on, in turns; the busy share and
    # the encrypted host hop with them on.
    def once():
        step(replicas, optimizers, batch)

    modes = {"off": (), **{name: (name,) for name in TRACED_PLANES},
             "on": TRACED_PLANES}
    times = {mode: [] for mode in modes}
    for _ in range(TRACED_TIMING_ROUNDS):
        for mode, on in modes.items():
            planes(on)
            ctx.barrier()
            times[mode].append(event_ms(once, iters=5))
    out["times"] = times
    ctx.barrier()
    out["device_ms"], rows = device_profile(once, iters=5, sessions=1)
    out["device_rows"] = rows[:6]
    # The encrypted hop against a plaintext context of the same processes
    # (Device() over its own store, the same tuning table and schedules
    # installed), in turns.
    plain_store = os.path.join(store, "plain")
    os.makedirs(plain_store, exist_ok=True)
    plain_ctx = Context(rank, size, timeout=120.0)
    plain_ctx.connect_full_mesh(FileStore(plain_store), Device())
    tuning.install_table(plain_ctx, tuned)
    schedule.install(plain_ctx, elected)
    out["hop"], out["plain_hop"] = [], []
    for _ in range(TRACED_TIMING_ROUNDS):
        ctx.barrier()
        out["hop"].append(host_hop_times(ctx, out["numel"], device))
        plain_ctx.barrier()
        out["plain_hop"].append(host_hop_times(plain_ctx, out["numel"],
                                               device))
    plain_ctx.close()
    planes(())
    ctx.barrier()
    if server is not None:
        server.close()
    ctx.close()
    return out


def schedule_for_size(schedule, table, world, nbytes):
    """`table` with one more election: for allreduce at `nbytes`'s bucket,
    the schedule it elected at its largest bucket, or a pipelined ring of
    depth 2 where the native algorithms won every swept size."""
    table = json.loads(json.dumps(table))
    if table["elections"]:
        name = max(table["elections"], key=lambda e: e["bucket"])["schedule"]
    else:
        one = schedule.generate("ring", world, {"depth": 2})
        name = one["schedules"][0]["name"]
        table["schedules"] += one["schedules"]
    table["elections"].append({
        "collective": "allreduce", "world_size": world, "dtype": "",
        "bucket": nbytes.bit_length() - 1, "schedule": name})
    return table


def traced_phase(card, hier):
    """Phase 32: phase 28's two-level step (hier_ddp_entry over a Context
    the worker connects: Device(keyring=derive_keyring(...), encrypt=True))
    in HOST_RANKS processes of HIER_LOCAL local ranks on the card, with the
    tracer, the phase profiler, the span recorder and the fleet plane on
    and rank 0 serving telemetry. Checks: the launches per step of phase
    28; the losses against phase 28's (`hier`, its results) within
    TRAIN_TOL; parameters bitwise equal across the processes; /healthz 200
    and /metrics parsed; fleet coverage 2 of 2; the ranks' traces merged
    by utils.tracing.merge_traces; a critical path for every step's host
    allreduce (utils.critpath); a delay of TRACED_DELAY_MS on rank 1's
    data sends in one step blamed on rank 1 (utils.profile); tune() and
    sweep() at 1 KiB-1 MiB electing the same table on both ranks; the
    step's gradient buffer, hopped under the elected table (and with a
    schedule of it forced at the buffer's size), bitwise equal to the
    native dispatch and to the CPU-tensor call. Prints ms per step with
    the planes off, each alone and all on (in turns), the busy share, the
    encrypted hop beside a plaintext one of the same processes and phase
    28's, and the tuner's and the sweep's seconds."""
    from gloo_tpu_torch.entry import ENTRY_CONFIG, HIER_LOCAL
    from gloo_tpu_torch.utils import critpath, profile
    from gloo_tpu_torch.utils.tracing import merge_traces

    t0 = time.perf_counter()
    res = run_workers("32", env=TRACED_ENV)
    wall = time.perf_counter() - t0
    failed = []
    per_layer = HIER_LOCAL * ENTRY_CONFIG.n_layers
    want = [HOST_STEPS * per_layer, HOST_STEPS * per_layer, HOST_STEPS]
    launches = [r["launches"] for r in res]
    print(f"traced encrypted two-level DDP ({HOST_RANKS} processes x "
          f"{HIER_LOCAL} local ranks, {wall:.1f} s of workers; uring "
          f"available {res[0]['uring']}, AEAD tier {res[0]['isa_tier']}, "
          f"engine counters {res[0]['engine']}, host algorithm "
          f"{res[0]['algo']}): launches (B1, B2, B3) {launches} in "
          f"{HOST_STEPS} steps (want {want})")
    if any(l != want for l in launches):
        failed.append("launches")
    rels = [abs(a - b) / abs(b) for r, h in zip(res, hier)
            for a, b in zip(r["losses"], h["losses"])]
    for rank, r in enumerate(res):
        print(f"  process {rank} losses "
              f"{', '.join(f'{x:.6f}' for x in r['losses'])} (phase 28: "
              f"{', '.join(f'{x:.6f}' for x in hier[rank]['losses'])})")
    print(f"  losses vs phase 28's: max rel {max(rels):.3e} (tol "
          f"{TRAIN_TOL['loss']}); parameters after {HOST_STEPS} steps "
          f"{'bitwise equal' if len({r['params'] for r in res}) == 1 else 'DIFFER'}"
          f" across processes")
    if max(rels) > TRAIN_TOL["loss"]:
        failed.append("losses")
    if len({r["params"] for r in res}) != 1:
        failed.append("params")

    code, verdict = res[0]["healthz"]
    m_code, m_samples = res[0]["metrics"]
    cov = res[0]["coverage"]
    print(f"  telemetry on rank 0: /healthz {code} (ok {verdict['ok']}), "
          f"/metrics {m_code} with {m_samples} samples; fleet coverage "
          f"{cov['reported']} of {cov['expected']} (complete "
          f"{cov['complete']})")
    if code != 200 or not verdict["ok"] or m_code != 200 or m_samples == 0:
        failed.append("telemetry")
    if not (cov["complete"] and cov["reported"] == HOST_RANKS):
        failed.append("fleet coverage")

    merged_trace = json.loads(merge_traces(r["trace"] for r in res))
    pids = {e["pid"] for e in merged_trace if e.get("ph") == "X"}
    steps_traced = [sum(1 for e in json.loads(r["trace"])
                        if e["name"] == "allreduce"
                        and e["args"]["bytes"] == r["numel"] * 4)
                    for r in res]
    print(f"  traces merged: {len(merged_trace)} events from ranks "
          f"{sorted(pids)}; host allreduces of {res[0]['numel'] * 4} bytes "
          f"per rank {steps_traced}")
    if pids != set(range(HOST_RANKS)) or steps_traced != [HOST_STEPS] * 2:
        failed.append("trace")

    analysis = critpath.analyze(critpath.merge(r["spans"] for r in res))
    # The spans were read after the checked steps, whose only allreduce
    # is each step's host hop.
    hops = [o for o in analysis["ops"] if o["op"] == "allreduce"]
    dropped = [r["spans"]["dropped"] for r in res]
    print(f"  critical paths: {len(hops)} host allreduces of the steps, "
          f"path rows {[len(o['path']) for o in hops]}, ms "
          f"{[round(o['total_us'] / 1e3, 3) for o in hops]}; spans dropped "
          f"{dropped}")
    if len(hops) != HOST_STEPS or not all(o["path"] for o in hops):
        failed.append("critical path")

    merged = profile.merge(r["profile"] for r in res)
    merged["ops"] = {c: v for c, v in merged["ops"].items()
                     if c > res[0]["fault_before"]}
    board = profile.leaderboard(profile.attribute(merged))
    fired = [len(r["fired"]) for r in res]
    print(f"  fault: {TRACED_DELAY_MS} ms delays fired per rank {fired}; "
          f"leaderboard of that step "
          f"{[(b['rank'], round(b['blamed_us'] / 1e3, 3)) for b in board]}"
          f" (rank, blamed ms)")
    if not board or board[0]["rank"] != 1 or fired[1] == 0:
        failed.append("fault blame")

    same_t = len({r["tuned"] for r in res}) == 1
    same_s = len({r["elected"] for r in res}) == 1
    elected = json.loads(res[0]["elected"])
    tuned = json.loads(res[0]["tuned"])
    tune_s = ", ".join(f"{r['tune_s']:.3f}" for r in res)
    sweep_s = ", ".join(f"{r['sweep_s']:.3f}" for r in res)
    print(f"  tune() {tune_s} s, "
          f"{len(tuned['entries'])} entries, the same on both ranks "
          f"{same_t}; sweep() {sweep_s} s, the same on "
          f"both ranks {same_s}; elected (bucket: schedule) "
          f"{[(e['bucket'], e['schedule']) for e in elected['elections']]}")
    best = {}
    for e in tuned["entries"]:
        key = (e["collective"], e["bucket"])
        if key not in best or e["cost_us"] < best[key][1]:
            best[key] = (e["algorithm"], e["cost_us"])
    print(f"  tuned: the cheapest algorithm per (collective, bucket) "
          f"{sorted((k[0], k[1], v[0]) for k, v in best.items())}")
    if not (same_t and same_s):
        failed.append("elections")
    bits = [r["bits"] for r in res]
    print(f"  gradient buffer's host hop, algorithms (native, elected, "
          f"forced {res[0]['forced_schedule']}) {res[0]['hop_algos']}: "
          f"bitwise {bits}")
    if not all(all(b.values()) for b in bits) \
            or not res[0]["hop_algos"][2].startswith("sched:"):
        failed.append("bits under the schedule")

    print(f"traced encrypted two-level DDP times on {card}:")
    for rank, r in enumerate(res):
        on = r["times"]["on"]
        busy = ("not measured" if r["device_ms"] is None
                else f"{r['device_ms'] / min(on):.3f}")
        print(f"  process {rank}: ms per step (CUDA events), "
              f"{TRACED_TIMING_ROUNDS} rounds in turns; device "
              f"{r['device_ms']} ms with every plane on, busy share {busy} "
              f"[{card}]")
        for mode, ms in r["times"].items():
            label = {"off": "planes off", "on": "every plane on"}.get(
                mode, f"{mode} alone")
            print(f"    {label}: {', '.join(f'{x:.6f}' for x in ms)}")
        for dev_ms, calls, kname in r["device_rows"]:
            print(f"    {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")
        for label, hops in (("encrypted", r["hop"]),
                            ("plaintext, same processes", r["plain_hop"]),
                            ("phase 28's plaintext", [hier[rank]["hop"]])):
            host = ", ".join(f"{h['allreduce_host_ms']:.6f}" for h in hops)
            staged = ", ".join(f"{h['staged_allreduce_ms']:.6f}"
                               for h in hops)
            share = ", ".join(
                f"{(h['d2h_ms'] + h['h2d_ms']) / h['staged_allreduce_ms']:.3f}"
                for h in hops)
            print(f"    {label} host hop of {hops[0]['bytes']} bytes: host "
                  f"allreduce {host} ms, staged ctx.allreduce {staged} ms, "
                  f"the pinned copies' share of it {share} [{card}]")
    if failed:
        raise AssertionError(f"phase 32 failed: {failed}")
    return res


WORKERS = {"26": worker_staging, "27": worker_host_sync, "28": worker_hier,
           "29": worker_elastic, "29b": worker_run_elastic,
           "30": worker_surface, "32": worker_traced}


def host_phases(card):
    """Phases 26-28, each in HOST_RANKS worker processes on the card."""
    # Phase 26: Context collectives on CUDA tensors, bitwise.
    res = run_workers("26")
    cases = sum(r["cases"] for r in res)
    wrong = [w for r in res for w in r["wrong"]]
    print(f"host plane on CUDA tensors ({HOST_RANKS} processes on the card, "
          f"{HOST_ROUNDS} rounds): {cases} calls of allreduce sum/max, "
          f"broadcast, allgather, reduce_scatter at f32/bf16/int32 x "
          f"{STAGE_BYTES} bytes against the same calls on CPU copies: "
          f"{'all bitwise equal' if not wrong else 'DIFFER ' + str(wrong)}")
    if wrong:
        raise AssertionError(f"staged collectives differ from the CPU "
                             f"calls: {wrong}")

    # Phase 27: HostGradSync on the flagship's CUDA gradients.
    res = run_workers("27")
    wrong = [w for r in res for w in r["wrong"]]
    print(f"HostGradSync on the flagship's CUDA gradients "
          f"({res[0]['bytes']} bytes per rank): sequential, bucketed and "
          f"q8-wire arms vs the same arms on CPU copies, {HOST_ROUNDS} "
          f"rounds: {'bitwise equal' if not wrong else 'DIFFER ' + str(wrong)}")
    if wrong:
        raise AssertionError(f"HostGradSync on the card differs from the "
                             f"CPU call: {wrong}")
    check_host_steps("host_ddp_entry", res, "one model's full-batch step "
                     "on the card")

    # Phase 28: the two-level DDP.
    from gloo_tpu_torch.entry import ENTRY_CONFIG, HIER_LOCAL

    res = run_workers("28")
    launches = [r["launches"] for r in res]
    per_layer = HIER_LOCAL * ENTRY_CONFIG.n_layers
    per_step = [per_layer, per_layer, 1]
    print(f"hier_ddp_entry: {HOST_STEPS} steps, {HOST_RANKS} processes x "
          f"{HIER_LOCAL} local ranks on the card; launches (B1, B2, B3) per "
          f"process "
          f"{launches}, per step {[[x / HOST_STEPS for x in l] for l in launches]}")
    if any(l != [HOST_STEPS * x for x in per_step] for l in launches):
        raise AssertionError(f"hier_ddp_entry launched {launches}, expected "
                             f"{per_step} per step per process")
    if any(len(set(r["params"])) != 1 for r in res):
        raise AssertionError("the local replicas of a process differ")
    check_host_steps("hier_ddp_entry", [dict(r, params=r["params"][0])
                                        for r in res],
                     "ddp_train_entry()'s first step on the card")
    print(f"hier_ddp_entry times on {card}:")
    for rank, r in enumerate(res):
        hop = r["hop"]
        busy = ("not measured" if r["device_ms"] is None
                else f"{r['device_ms'] / r['step_ms']:.3f}")
        print(f"  process {rank}: step {r['step_ms']:.6f} ms (CUDA events), "
              f"device {r['device_ms']} ms, busy share {busy} [{card}]")
        for dev_ms, calls, kname in r["device_rows"]:
            print(f"    {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")
        print(f"    host hop of {hop['bytes']} bytes: D2H {hop['d2h_ms']:.6f}"
              f" ms ({hop['d2h_GBps']:.3f} GB/s pinned), host allreduce "
              f"{hop['allreduce_host_ms']:.6f} ms, H2D {hop['h2d_ms']:.6f} "
              f"ms ({hop['h2d_GBps']:.3f} GB/s pinned), the whole staged "
              f"ctx.allreduce {hop['staged_allreduce_ms']:.6f} ms [{card}]")
    return res


def elastic_phase(card):
    """Phase 29: the acceptance run and run_elastic, ELASTIC_RANKS
    processes on the card, one planned SIGKILL each."""
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.entry import ENTRY_CONFIG, HIER_LOCAL

    victim, at = ELASTIC_KILL
    t0 = time.perf_counter()
    res = run_workers("29", size=ELASTIC_RANKS, killed=(victim,), env={
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
    wall = time.perf_counter() - t0
    live = [r for r in res if r is not None]
    per_layer = HIER_LOCAL * ENTRY_CONFIG.n_layers
    failed = []
    for rank, r in enumerate(res):
        if r is None:
            continue
        got, want = r["sha256"]
        losses = {int(k): v for k, v in r["losses"].items()}
        shown = ", ".join(f"{k}: {v:.4f}" for k, v in sorted(losses.items()))
        per_step = [x / r["resumed_steps"] for x in r["launches"]]
        print(f"elastic acceptance process {rank}: rebuilt to size "
              f"{r['size']} in {r['rebuild_ms']:.3f} ms (host clock, "
              f"settle {ELASTIC_SETTLE} s), resumed from step "
              f"{r['restored']}; load_latest {r['load_ms']:.3f} ms "
              f"(tensors on the card {r['on_card']}), checkpoint sha256 "
              f"{got[:16]} vs rank 0's {want[:16]}: "
              f"{'equal' if got == want else 'DIFFER'}; every local "
              f"replica and Adam after the restore "
              f"{'equal' if set(r['live_sha256']) == {want} else 'DIFFER'}"
              f", rolled back past a trained step {r['rolled_back']}; "
              f"first resumed "
              f"step {r['resumed_step_ms']:.3f} ms; launches (B1, B2, B3) "
              f"per resumed step {per_step}; losses {shown} [{card}]")
        if r["save_ms"]:
            print(f"  save of the flagship's state ({r['state_bytes']} bytes"
                  f" of parameters and Adam moments) at steps {r['saved']}:"
                  f" {', '.join(f'{x:.3f}' for x in r['save_ms'])} ms "
                  f"[{card}]")
        if got != want or not r["on_card"] \
                or set(r["live_sha256"]) != {want} or not r["rolled_back"]:
            failed.append(f"process {rank}: checkpoint not restored whole")
        if r["size"] != ELASTIC_RANKS - 1:
            failed.append(f"process {rank}: size {r['size']}")
        if per_step != [per_layer, per_layer, 1]:
            failed.append(f"process {rank}: launches {per_step}")
        if not (r["params_equal"] and r["replicas_equal"]):
            failed.append(f"process {rank}: parameters differ")
        last = ELASTIC_STEPS - 1
        if not all(np.isfinite(list(losses.values()))) \
                or not losses[last] < losses[0]:
            failed.append(f"process {rank}: loss at step {last} not below "
                          f"step 0's")
    if len(live) != ELASTIC_RANKS - 1:
        failed.append(f"{len(live)} survivors")
    print(f"elastic acceptance: {ELASTIC_RANKS} processes x {HIER_LOCAL} "
          f"local ranks, process {victim} SIGKILLed at step {at}, "
          f"{ELASTIC_STEPS} steps, {wall:.1f} s in all: "
          f"{'passed' if not failed else 'FAILED ' + str(failed)}")
    if failed:
        raise AssertionError(f"phase 29 failed: {failed}")

    t0 = time.perf_counter()
    res = run_workers("29b", size=ELASTIC_RANKS, killed=(victim,),
                      env=LEASE_ENV)
    wall = time.perf_counter() - t0
    live = [r for r in res if r is not None]
    for rank, r in enumerate(res):
        if r is not None:
            print(f"run_elastic process {rank}: {r['steps']} steps, "
                  f"rebuilds {r['rebuilds']}, sizes {r['sizes']}, rebuild "
                  f"ms {r['rebuild_ms']} (the agent's), {r['wall_ms']:.1f} "
                  f"ms in all [{card}]")
    # The steps after the newest checkpoint before the kill run twice.
    every = entry_mod.ELASTIC_CKPT_EVERY
    replayed = at - 1 - (at - 1) // every * every
    ok = (len(live) == ELASTIC_RANKS - 1
          and all(r["rebuilds"] == 1 and r["size"] == ELASTIC_RANKS - 1
                  and r["steps"] == RUN_ELASTIC_STEPS + replayed
                  for r in live)
          and len({r["params"] for r in live}) == 1)
    print(f"run_elastic with the port's StepCheckpointer: process {victim} "
          f"SIGKILLed at step {at}, {RUN_ELASTIC_STEPS} steps ({replayed} "
          f"replayed from the checkpoint), {wall:.1f} s in all: one "
          f"rebuild, final size "
          f"{ELASTIC_RANKS - 1}, parameters bitwise equal: "
          f"{'passed' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("phase 29's run_elastic part failed")


def check_host_steps(label, res, ref_label):
    """The checks of a two-process training path: its first step's loss
    (the processes' mean) and rank 0's first-step gradients against the
    reference within TRAIN_TOL, the gradients and the parameters after
    HOST_STEPS steps bitwise equal across the processes, the loss finite
    and falling on each."""
    first = sum(r["losses"][0] for r in res) / len(res)
    ref = res[0]["ref_loss"]
    loss_rel = abs(first - ref) / abs(ref)
    for rank, r in enumerate(res):
        print(f"{label} process {rank}: losses "
              f"{', '.join(f'{x:.6f}' for x in r['losses'])}")
    print(f"first {label} step vs {ref_label}: loss {first:.6f} vs "
          f"{ref:.6f} (rel {loss_rel:.3e}, tol {TRAIN_TOL['loss']}); grads "
          f"|g - g_ref| / |g_ref| max {res[0]['grad_rel']:.3e} at "
          f"{res[0]['grad_worst']} (tol {TRAIN_TOL['grad']}); first-step "
          f"grads {'bitwise equal' if len({r['first_grads'] for r in res}) == 1 else 'DIFFER'}"
          f" across processes; parameters after {HOST_STEPS} steps "
          f"{'bitwise equal' if len({r['params'] for r in res}) == 1 else 'DIFFER'}")
    if loss_rel > TRAIN_TOL["loss"] or res[0]["grad_rel"] > TRAIN_TOL["grad"]:
        raise AssertionError(f"the first {label} step disagrees with "
                             f"{ref_label}")
    if len({r["first_grads"] for r in res}) != 1 \
            or len({r["params"] for r in res}) != 1:
        raise AssertionError(f"{label}: the processes' gradients or "
                             f"parameters differ")
    for r in res:
        if not all(np.isfinite(r["losses"])) \
                or not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"{label}: the loss is not finite and "
                                 f"falling: {r['losses']}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")

    from gloo_tpu_torch import _build
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.entry import (DDP_WORLD, ENTRY_CONFIG,
                                      ddp_train_entry, dp_tp_train_entry,
                                      entry, ep_entry, expert_mlp,
                                      ring_variants_entry, sp_entry,
                                      train_entry)
    from gloo_tpu_torch.entry import forward as entry_forward
    from gloo_tpu_torch.models import Transformer
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import overlap as ov
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.parallel import dp_tp, pp, sp, tp
    from gloo_tpu_torch.parallel.ddp import buffer_width
    from gloo_tpu_torch.parallel.fsdp import unshard_params
    from gloo_tpu_torch.tpu import CudaProcessGroup, make_mesh, spmd
    from gloo_tpu_torch.utils import tracing

    # Phase 1: the card.
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f16 products accumulate in f32, as on the CPU and in the kernels.
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

    # Phase 2: build every kernel and the host library, all at once
    # (set-up time, not part of any metric).
    import concurrent.futures

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(lambda: (_build.build_host_library(),
                                          time.perf_counter() - t0))
        libs = _build.build()
        print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
        host_lib, host_s = host_build.result()
    print(f"host library: {host_lib.name} in {host_s:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                # The mangled name shows the instance, e.g. ...I13__nv_
                # bfloat16Li64EE for <bf16, 64>.
                line = line.split("for", 1)[1]
            elif "registers" not in line and "spill" not in line:
                continue
            print(f"  ptxas {name}: {line.strip()}")

    # Phase 3: kernel against plain on the card.
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry_err = None
    for name, b, h, h_kv, t, d, dtype, causal in FLASH_CASES:
        q, k, v = make_qkv(b, h, h_kv, t, d, dtype, gen,
                           fused=dtype != torch.float32)
        with torch.inference_mode():
            out, lse = attn.flash_attention_fwd(q, k, v, causal)
            ref_out, ref_lse = attn.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[dtype]
        out_err, out_ok = max_err(out, ref_out, *tol["out"])
        lse_err, lse_ok = max_err(lse, ref_lse, *tol["lse"])
        finite = bool(torch.isfinite(out.float()).all())
        print(f"flash_fwd {name}: out max_abs_err {out_err:.3e} "
              f"(rtol, atol {tol['out']}), lse max_abs_err {lse_err:.3e} "
              f"(rtol, atol {tol['lse']})")
        if not (out_ok and lse_ok and finite):
            worst = [tuple(torch.nonzero(
                (a.float() - r.float()).abs() == e)[0].tolist())
                for a, r, e in ((out, ref_out, out_err),
                                (lse, ref_lse, lse_err))]
            raise AssertionError(
                f"flash_fwd {name} disagrees with its plain version "
                f"(finite {finite}; largest out / lse error at {worst})")
        if name == "entry":
            entry_err = out_err
    failed, entry_bwd_err = [], None
    with torch.enable_grad():
        for case in FLASH_CASES:
            err, ok = check_bwd(attn, *case, gen)
            if case[0] == "entry":
                entry_bwd_err = err
            if not ok:
                failed.append(case[0])
    if failed:
        raise AssertionError(f"flash_bwd disagrees with its plain version "
                             f"or the reference at {failed}")

    # Phase 4: the serving path, with the launch counts read around it.
    cfg = ENTRY_CONFIG
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd.launches = 0
    fn, (model, tokens) = entry()
    logits = fn(model, tokens)
    prompts = tokens[:4, :16]
    served = model.generate(prompts, max_new=8)
    torch.cuda.synchronize()
    launches = attn.flash_attention_fwd.launches
    print(f"serving path: forward logits {tuple(logits.shape)}, generate "
          f"{tuple(served.shape)}, flash_fwd launches {launches}, flash_bwd "
          f"launches {attn.flash_attention_bwd.launches}")
    if launches != cfg.n_layers or attn.flash_attention_bwd.launches:
        raise AssertionError(f"flash_fwd launched {launches} times on the "
                             f"serving path, expected {cfg.n_layers}, and "
                             f"flash_bwd {attn.flash_attention_bwd.launches}"
                             f" times, expected 0")
    if logits.shape != (8, cfg.max_seq_len, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("entry logits have the wrong shape or are "
                             "not finite")
    if not torch.equal(served[:, :16], prompts) \
            or int(served.min()) < 0 or int(served.max()) >= cfg.vocab_size:
        raise AssertionError("generate returned malformed tokens")
    cpu_model = Transformer(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    ref_logits = entry_forward(cpu_model, tokens.cpu())
    err, ok = max_err(logits.cpu(), ref_logits, *LOGITS_TOL)
    print(f"entry logits vs CPU plain attention: max_abs_err {err:.3e} "
          f"(rtol, atol {LOGITS_TOL}), |logits| max "
          f"{float(ref_logits.abs().max()):.3f}")
    if not ok:
        raise AssertionError("entry logits disagree with the CPU model")

    # Phase 5: greedy decode against the full forward, exactly, in f32.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = Transformer(cfg32).init(torch.Generator().manual_seed(0))
    gen32 = model32.generate(prompts, max_new=8)
    full = entry_forward(model32, prompts)
    rescored = entry_forward(model32, gen32[:, :-1])
    if not torch.equal(gen32[:, 16], full[:, -1].argmax(-1).to(gen32.dtype)):
        raise AssertionError("first generated token is not the argmax of "
                             "the full forward")
    if not torch.equal(rescored[:, 15:].argmax(-1).to(gen32.dtype),
                       gen32[:, 16:]):
        raise AssertionError("re-scoring the generated tokens does not "
                             "reproduce the greedy choices")
    print("greedy decode parity (f32): first token and re-scoring match")

    # Phase 6: the training path, with the launch counts read around it.
    step, (tmodel, opt, ttokens, ttargets) = train_entry()
    cpu_model = Transformer(cfg, device="cpu")
    cpu_model.load_state_dict(tmodel.state_dict())
    cpu_loss = cpu_model.loss(ttokens.cpu(), ttargets.cpu())
    cpu_loss.backward()
    cpu_loss = float(cpu_loss.detach())
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd.launches = 0
    losses = [step(tmodel, opt, ttokens, ttargets)]
    first_grads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    losses += [step(tmodel, opt, ttokens, ttargets)
               for _ in range(TRAIN_STEPS - 1)]
    torch.cuda.synchronize()
    train_launches = (attn.flash_attention_fwd.launches,
                      attn.flash_attention_bwd.launches)
    losses = [float(x) for x in losses]
    print(f"training path: {TRAIN_STEPS} steps, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; flash_fwd launches "
          f"{train_launches[0]}, flash_bwd launches {train_launches[1]}")
    want = TRAIN_STEPS * cfg.n_layers
    if train_launches != (want, want):
        raise AssertionError(f"training launched flash_fwd, flash_bwd "
                             f"{train_launches} times, expected {want} each")
    if not all(torch.isfinite(torch.tensor(losses))) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss is not finite and falling: "
                             f"{losses}")
    loss_rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    grad_rel = {}
    for n, p in cpu_model.named_parameters():
        ref = p.grad.float()
        grad_rel[n] = float((first_grads[n].cpu().float() - ref).norm()
                            / ref.norm())
    worst = max(grad_rel, key=grad_rel.get)
    print(f"first step vs CPU model: loss {losses[0]:.6f} vs "
          f"{cpu_loss:.6f} (rel {loss_rel:.3e}, tol "
          f"{TRAIN_TOL['loss']}); grads |g - g_cpu| / |g_cpu| max "
          f"{grad_rel[worst]:.3e} at {worst}, median "
          f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.3e} (tol "
          f"{TRAIN_TOL['grad']})")
    if loss_rel > TRAIN_TOL["loss"] or grad_rel[worst] > TRAIN_TOL["grad"]:
        raise AssertionError("the first training step disagrees with the "
                             "CPU model")

    # Phase 7: times. SDPA is a yardstick only; the port never calls it.
    print(f"times on {card}:")
    rows = {}
    for name, b, h, h_kv, t, d, dtype, causal in FLASH_CASES:
        fused = dtype != torch.float32
        q, k, v = make_qkv(b, h, h_kv, t, d, dtype, gen, fused)
        with torch.inference_mode():
            ms = timed(f"{name} kernel",
                       lambda: attn.flash_attention_fwd(q, k, v, causal))
            plain = timed(f"{name} plain",
                          lambda: attn.flash_attention_plain(q, k, v, causal))
            lib = timed(f"{name} sdpa", lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=h != h_kv))
        bound, bound_by = flash_bound(b, h, h_kv, t, d, dtype, causal)
        print(f"  {name} bound {bound:.6f} ms ({bound_by})")
        rows[name] = (ms, plain, lib, bound, bound_by)
    bwd_rows = {}
    for name, b, h, h_kv, t, d, dtype, causal in FLASH_CASES:
        fused = dtype != torch.float32
        leaves = [x.requires_grad_(True)
                  for x in make_qkv(b, h, h_kv, t, d, dtype, gen, fused)]
        q, k, v = (x.detach() for x in leaves)
        do = make_do(b, h, t, d, dtype, gen, fused)
        with torch.enable_grad():
            out, lse = attn.flash_attention_fwd(q, k, v, causal)
            op_out = attn.flash_attention(*leaves, causal=causal)
            sdpa_out = F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=h != h_kv)
            ms = timed_kernel(
                f"{name} bwd kernels (the three launches of one call)",
                lambda: attn.flash_attention_bwd(q, k, v, out, lse, do,
                                                 causal), "flash_bwd",
                attn.FLASH_BWD_KERNELS[dtype])
            timed(f"{name} bwd op (autograd: the three launches, and at "
                  f"a padded head_dim the pads and the slices' copies)",
                  lambda: torch.autograd.grad(op_out, leaves, do,
                                              retain_graph=True))
            plain = timed(
                f"{name} bwd plain",
                lambda: attn.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                       causal), iters=3)
            lib = timed(f"{name} bwd sdpa",
                        lambda: torch.autograd.grad(sdpa_out, leaves, do,
                                                    retain_graph=True))
        bound, bound_by = flash_bwd_bound(b, h, h_kv, t, d, dtype, causal)
        print(f"  {name} bwd bound {bound:.6f} ms ({bound_by})")
        bwd_rows[name] = (ms, plain, lib, bound, bound_by)
    fwd_ms = event_ms(lambda: fn(model, tokens), iters=20)
    fwd_dev, fwd_rows = device_profile(lambda: fn(model, tokens))
    busy = "not measured" if fwd_dev is None else f"{fwd_dev / fwd_ms:.3f}"
    print(f"entry forward (batch 8, seq 128): {fwd_ms:.6f} ms per call, "
          f"device time {fwd_dev} ms, device busy share {busy}")
    for dev_ms, calls, kname in fwd_rows[:8]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")
    gen_ms = event_ms(lambda: model.generate(prompts, max_new=8), iters=5)
    print(f"generate (4 prompts of 16 tokens, 8 new, greedy): {gen_ms:.6f} "
          f"ms per call, {gen_ms / 24:.6f} ms per cached step")

    def train_once():
        step(tmodel, opt, ttokens, ttargets)

    train_ms = event_ms(train_once, iters=20)
    train_dev, train_rows = device_profile(train_once, iters=10)
    busy = ("not measured" if train_dev is None
            else f"{train_dev / train_ms:.3f}")
    print(f"training step (batch 8, seq 128, Adam): {train_ms:.6f} ms per "
          f"step, device time {train_dev} ms, device busy share {busy}")
    for dev_ms, calls, kname in train_rows[:8]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")

    # Phase 8: the ring kernels against their plain versions, bitwise.
    dev = torch.device("cuda")
    failed = []
    for name, n, n_rows, n_cols, dtype in RING_CASES:
        mesh = make_mesh({"x": n}, devices=[dev] * n)
        x = torch.randn((n, n_rows, n_cols), generator=gen,
                        device="cuda").to(dtype)
        for fn, plain in ((ring.ring_allreduce, ring.ring_allreduce_plain),
                          (ring.ring_reduce_scatter,
                           ring.ring_reduce_scatter_plain)):
            failed += [f"{fn.__name__} {name}: {f}" for f in ring_check(
                name, fn, plain, x, "x", mesh, runs=RING_RUNS)[2]]
        xs = x[:, :n_rows // n]
        failed += [f"ring_allgather {name}: {f}" for f in ring_check(
            name, ring.ring_allgather, ring.ring_allgather_plain, xs, "x",
            mesh, want=xs.reshape(1, n_rows, n_cols).expand(n, -1, -1))[2]]
    # The DDP step's gradient buffer: every parameter's gradient and the
    # loss, padded (gloo_tpu_torch.parallel.ddp), 4 ranks on the card.
    n_params = sum(p.numel() for p in model.parameters())
    width = buffer_width(n_params, DDP_WORLD)
    print(f"DDP buffer: {n_params} gradients + 1 loss, padded to {width} "
          f"f32 per rank")
    ddp_mesh = make_mesh({"data": DDP_WORLD}, devices=[dev] * DDP_WORLD)
    grads = torch.randn((DDP_WORLD, DDP_WORLD, width // DDP_WORLD),
                        generator=gen, device="cuda")
    ring_err = {}
    for fn, plain, x, want, runs in (
            (ring.ring_allreduce, ring.ring_allreduce_plain, grads, None,
             RING_RUNS),
            (ring.ring_reduce_scatter, ring.ring_reduce_scatter_plain, grads,
             None, RING_RUNS),
            (ring.ring_allgather, ring.ring_allgather_plain, grads[:, :1],
             grads[:, 0].reshape(1, DDP_WORLD, -1).expand(DDP_WORLD, -1,
                                                           -1), 1)):
        _, diff, bad = ring_check("ddp", fn, plain, x, "data", ddp_mesh,
                                  want, runs)
        ring_err[fn.__name__] = diff
        failed += [f"{fn.__name__} ddp: {f}" for f in bad]
    torus_mesh = make_mesh({"y": 2, "x": 2}, devices=[dev] * 4)
    z = torch.randn((4, 8, 128), generator=gen, device="cuda")
    for axis in ("y", "x"):
        for fn, plain in ((ring.ring_allreduce, ring.ring_allreduce_plain),
                          (ring.ring_reduce_scatter,
                           ring.ring_reduce_scatter_plain)):
            failed += [f"{fn.__name__} 2x2 {axis}: {f}" for f in ring_check(
                "2x2", fn, plain, z, axis, torus_mesh, runs=RING_RUNS)[2]]
    before = (ring.ring_reduce_scatter.launches, ring.ring_allgather.launches)
    out = ring.ring_allreduce_torus(z, ("x", "y"), torus_mesh)
    torch.cuda.synchronize()
    torus_launches = (ring.ring_reduce_scatter.launches - before[0],
                      ring.ring_allgather.launches - before[1])
    ref = z
    for ax in ("x", "y"):
        ref = ring.ring_reduce_scatter_plain(ref, ax, torus_mesh)
    for ax in ("y", "x"):
        ref = ring.ring_allgather_plain(ref, ax, torus_mesh)
    diff = float((out - ref).abs().max())
    print(f"ring_allreduce_torus 2x2 mesh (y, x) along (x, y): 4 ranks of "
          f"(8, 128) f32: max |kernel - plain| {diff:.3e}, vs the f64 sum "
          f"{float((out.double() - z.double().sum(0)).abs().max()):.3e}; "
          f"launches (reduce-scatter, allgather) {torus_launches}")
    if not torch.equal(out, ref) or not torch.equal(out, out[[0] * 4]) \
            or torus_launches != (2, 2):
        failed.append("ring_allreduce_torus")
    if failed:
        raise AssertionError(f"ring kernels disagree: {failed}")

    # Phase 9: the group path, with the ring launch counts read around it.
    pg = CudaProcessGroup(ddp_mesh)
    p = pg.size
    xr = np.arange(p * 16, dtype=np.float32).reshape(p, 16) + 1.0
    xa = (np.arange(p)[:, None] * 100 + np.arange(p)[None, :]).astype(
        np.float32)[..., None] * np.ones((p, p, 8), np.float32)
    xs = xr[:, :1] * np.ones((p, p * 4), np.float32)
    for fn in (ring.ring_allreduce, ring.ring_reduce_scatter,
               ring.ring_allgather, ring.alltoall):
        fn.launches = 0
    got = {
        "allreduce": pg.unshard(pg.allreduce(pg.shard(xr))),
        "allreduce_max": pg.unshard(pg.allreduce(pg.shard(xr), op="max")),
        "reduce_scatter": pg.unshard(pg.reduce_scatter(pg.shard(xs))),
        "allgather": pg.unshard(pg.allgather(pg.shard(xr))),
        "broadcast": pg.unshard(pg.broadcast(pg.shard(xr), root=2)),
        "reduce": pg.unshard(pg.reduce(pg.shard(xr), root=1)),
        "alltoall": pg.unshard(pg.alltoall(pg.shard(xa))),
        "shift": pg.unshard(pg.shift(pg.shard(xr), offset=1)),
    }
    pg.barrier()
    group_launches = (ring.ring_allreduce.launches,
                      ring.ring_reduce_scatter.launches,
                      ring.ring_allgather.launches, ring.alltoall.launches)
    total = xr.sum(0)
    closed = {
        "allreduce": np.broadcast_to(total, (p, 16)),
        "allreduce_max": np.broadcast_to(xr.max(0), (p, 16)),
        "reduce_scatter": xs.sum(0).reshape(p, 4),
        "allgather": np.broadcast_to(xr, (p, p, 16)),
        "broadcast": np.broadcast_to(xr[2], (p, 16)),
        "reduce": np.where(np.arange(p)[:, None] == 1, total, 0.0),
        "alltoall": xa.transpose(1, 0, 2),
        "shift": np.roll(xr, 1, axis=0),
    }
    wrong = [k for k in closed
             if got[k].shape != closed[k].shape
             or not np.allclose(got[k], closed[k], rtol=1e-6, atol=0)]
    print(f"group path (CudaProcessGroup, {p} ranks on the card): "
          f"{', '.join(got)} and barrier against their closed forms: "
          f"{'all agree' if not wrong else 'FAILED ' + str(wrong)}; "
          f"launches ring_allreduce, ring_reduce_scatter, ring_allgather, "
          f"alltoall {group_launches}")
    if wrong or group_launches != (2, 1, 1, 1):
        raise AssertionError(f"the group path failed: {wrong}, launches "
                             f"{group_launches}, expected (2, 1, 1, 1)")

    # Phase 10: the data-parallel path, with the launch counts read around
    # it, against train_step over the whole batch on the same card.
    ddp_step, (replicas, optimizers, batch) = ddp_train_entry()
    _, (smodel, sopt, stokens, stargets) = train_entry()
    if not (torch.equal(batch[0], stokens) and torch.equal(batch[1],
                                                           stargets)):
        raise AssertionError("ddp_train_entry's batch is not train_entry's")
    single_loss = float(step(smodel, sopt, stokens, stargets))
    single_grads = {n: p.grad.clone() for n, p in smodel.named_parameters()}
    for counter in (attn.flash_attention_fwd, attn.flash_attention_bwd,
                    ring.ring_allreduce, ring.ring_reduce_scatter,
                    ring.ring_allgather):
        counter.launches = 0
    ddp_losses = [ddp_step(replicas, optimizers, batch)]
    ddp_grads = {n: p.grad.clone() for n, p in replicas[0].named_parameters()}
    ddp_losses += [ddp_step(replicas, optimizers, batch)
                   for _ in range(DDP_STEPS - 1)]
    torch.cuda.synchronize()
    ddp_launches = (attn.flash_attention_fwd.launches,
                    attn.flash_attention_bwd.launches,
                    ring.ring_allreduce.launches,
                    ring.ring_reduce_scatter.launches,
                    ring.ring_allgather.launches)
    ddp_losses = [float(x) for x in ddp_losses]
    print(f"DDP path: {DDP_STEPS} steps of {DDP_WORLD} ranks on the card, "
          f"losses {', '.join(f'{x:.6f}' for x in ddp_losses)}; launches "
          f"flash_fwd, flash_bwd, ring_allreduce, ring_reduce_scatter, "
          f"ring_allgather {ddp_launches}")
    per_step = DDP_WORLD * cfg.n_layers
    want = (DDP_STEPS * per_step, DDP_STEPS * per_step, DDP_STEPS, 0, 0)
    if ddp_launches != want:
        raise AssertionError(f"the DDP path launched {ddp_launches}, "
                             f"expected {want}")
    if not all(np.isfinite(ddp_losses)) or not ddp_losses[-1] < \
            ddp_losses[0]:
        raise AssertionError(f"DDP loss is not finite and falling: "
                             f"{ddp_losses}")
    unequal = [n for m in replicas[1:]
               for (n, a), b in zip(m.named_parameters(),
                                    replicas[0].parameters())
               if not torch.equal(a, b)]
    print(f"replicas after {DDP_STEPS} steps: "
          f"{'bitwise equal' if not unequal else 'DIFFER at ' + str(unequal)}")
    if unequal:
        raise AssertionError(f"the DDP replicas differ: {unequal}")
    loss_rel = abs(ddp_losses[0] - single_loss) / abs(single_loss)
    grad_rel = {n: float((ddp_grads[n] - g).norm() / g.norm())
                for n, g in single_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"first DDP step vs train_step over the whole batch on the card: "
          f"loss {ddp_losses[0]:.6f} vs {single_loss:.6f} (rel "
          f"{loss_rel:.3e}, tol {TRAIN_TOL['loss']}); grads |g - g_1| / "
          f"|g_1| max {grad_rel[worst]:.3e} at {worst}, median "
          f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.3e} (tol "
          f"{TRAIN_TOL['grad']})")
    if loss_rel > TRAIN_TOL["loss"] or grad_rel[worst] > TRAIN_TOL["grad"]:
        raise AssertionError("the first DDP step disagrees with train_step "
                             "over the whole batch")

    # Phase 11: ring kernel times at the DDP shape. Bounds: each input byte
    # read once and each output byte written once at the HBM rate (B3 2 P S,
    # B4a P S + S, B4b S + P S for S bytes per rank), against the adds at
    # the f32 peak. The yardsticks are PyTorch calls the port never makes.
    print(f"ring times at the DDP shape ({DDP_WORLD} ranks x {width} f32) "
          f"on {card}:")
    per_rank = width * 4
    chunk = grads[:, :1].contiguous()
    ring_rows = {}
    for fn, plain, x, lib_label, lib_fn, nbytes, adds in (
            (ring.ring_allreduce, ring.ring_allreduce_plain, grads,
             "x.sum(0) then expand(P).contiguous(), two calls",
             lambda: grads.sum(0).expand(DDP_WORLD, -1, -1).contiguous(),
             2 * DDP_WORLD * per_rank, (DDP_WORLD - 1) * width),
            (ring.ring_reduce_scatter, ring.ring_reduce_scatter_plain, grads,
             "x.sum(0)", lambda: grads.sum(0),
             DDP_WORLD * per_rank + per_rank, (DDP_WORLD - 1) * width),
            (ring.ring_allgather, ring.ring_allgather_plain, chunk,
             "expand(P).contiguous()",
             lambda: chunk.reshape(1, DDP_WORLD, -1).expand(
                 DDP_WORLD, -1, -1).contiguous(),
             per_rank + DDP_WORLD * per_rank, 0)):
        name = fn.__name__
        ms = timed_kernel(f"{name} kernel",
                          lambda: fn(x, "data", ddp_mesh), "ring_kernel")
        timed(f"{name} whole call (output, flags, kernel)",
              lambda: fn(x, "data", ddp_mesh))
        plain_ms = timed(f"{name} plain",
                         lambda: plain(x, "data", ddp_mesh), iters=5)
        lib_ms = timed(f"{name} yardstick {lib_label}", lib_fn)
        bound, bound_by = _bound(nbytes, adds, torch.float32)
        print(f"  {name} bound {bound:.6f} ms ({bound_by}: {nbytes} bytes)")
        ring_rows[name] = (ms, plain_ms, lib_ms, bound, bound_by)

    def ddp_once():
        ddp_step(replicas, optimizers, batch)

    ddp_ms = event_ms(ddp_once, iters=10)
    ddp_dev, ddp_rows = device_profile(ddp_once, iters=5)
    busy = "not measured" if ddp_dev is None else f"{ddp_dev / ddp_ms:.3f}"
    print(f"DDP step ({DDP_WORLD} ranks x batch 2, seq 128, Adam): "
          f"{ddp_ms:.6f} ms per step, device time {ddp_dev} ms, device busy "
          f"share {busy}")
    for dev_ms, calls, kname in ddp_rows[:8]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")

    # Phase 12: the collective matmuls against their plain versions.
    overlap_errs = overlap_cases(ov, make_mesh, gen)

    # Phase 13: the fused Megatron-SP MLP (path B).
    slice4 = (ov.allgather_matmul, ov.matmul_reduce_scatter,
              ring.ring_allgather, ring.ring_reduce_scatter,
              ring.ring_allreduce)
    mlp_launches, (mlp_mesh, mlp_args, mlp_hidden, mlp_leaves, mlp_dy) = \
        fused_mlp_path(ov, tp, slice4, make_mesh, gen, cfg)

    # Phase 14: the dp x tp path (path A), with the launch counts read
    # around it, against train_step over the whole batch on the same card.
    tp_step, (tp_model, tp_opt, tp_tokens, tp_targets) = dp_tp_train_entry()
    _, (smodel, sopt, stokens, stargets) = train_entry()
    if not (torch.equal(tp_tokens, stokens)
            and torch.equal(tp_targets, stargets)):
        raise AssertionError("dp_tp_train_entry's batch is not "
                             "train_entry's")
    single_loss = float(step(smodel, sopt, stokens, stargets))
    single_grads = {n: p.grad.clone() for n, p in smodel.named_parameters()}
    path_a = (attn.flash_attention_fwd, attn.flash_attention_bwd) + slice4
    for counter in path_a:
        counter.launches = 0
    tp_losses = [tp_step(tp_model, tp_opt, tp_tokens, tp_targets)]
    tp_grads = dp_tp.unshard_state(
        {n: p.grad for n, p in tp_model.named_parameters()}, cfg,
        tp_model.mesh)
    tp_losses += [tp_step(tp_model, tp_opt, tp_tokens, tp_targets)
                  for _ in range(DP_TP_STEPS - 1)]
    torch.cuda.synchronize()
    tp_launches = tuple(c.launches for c in path_a)
    tp_losses = [float(x) for x in tp_losses]
    print(f"dp x tp path: {DP_TP_STEPS} steps on a {tp_model.mesh.shape} "
          f"mesh of ranks on the card, losses "
          f"{', '.join(f'{x:.6f}' for x in tp_losses)}; launches flash_fwd, "
          f"flash_bwd, allgather_matmul, matmul_reduce_scatter, "
          f"ring_allgather, ring_reduce_scatter, ring_allreduce "
          f"{tp_launches}")
    # Per step: one B1 and one B2 per layer over the world; B3 twice per
    # layer in the forward (attention and MLP row-parallel sums), twice in
    # the backward (their VJPs), and twice for the gradients (the whole
    # buffer along "data", the replicated part along "model").
    per_layer = cfg.n_layers
    want = (DP_TP_STEPS * per_layer, DP_TP_STEPS * per_layer, 0, 0, 0, 0,
            DP_TP_STEPS * (4 * cfg.n_layers + 2))
    if tp_launches != want:
        raise AssertionError(f"the dp x tp path launched {tp_launches}, "
                             f"expected {want}")
    if not all(np.isfinite(tp_losses)) or not tp_losses[-1] < tp_losses[0]:
        raise AssertionError(f"dp x tp loss is not finite and falling: "
                             f"{tp_losses}")
    model_index = tp_model.mesh.ring_index("model")
    unequal = []
    for name, p in tp_model.named_parameters():
        sharded = name.split(".")[-1] in dp_tp.SHARDED
        for r in range(1, tp_model.mesh.size):
            twin = model_index.index(model_index[r]) if sharded else 0
            if not torch.equal(p[r], p[twin]):
                unequal.append(f"{name}[{r}]")
    print(f"after {DP_TP_STEPS} dp x tp steps: replicated copies on all 4 "
          f"ranks and shards across data ranks "
          f"{'bitwise equal' if not unequal else 'DIFFER at ' + str(unequal)}")
    if unequal:
        raise AssertionError(f"the dp x tp copies differ: {unequal}")
    loss_rel = abs(tp_losses[0] - single_loss) / abs(single_loss)
    grad_rel = {n: rel_norm(tp_grads[n], g) for n, g in single_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"first dp x tp step vs train_step over the whole batch on the "
          f"card: loss {tp_losses[0]:.6f} vs {single_loss:.6f} (rel "
          f"{loss_rel:.3e}, tol {TRAIN_TOL['loss']}); reassembled grads "
          f"|g - g_1| / |g_1| max {grad_rel[worst]:.3e} at {worst}, median "
          f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.3e} (tol "
          f"{TRAIN_TOL['grad']})")
    if loss_rel > TRAIN_TOL["loss"] or grad_rel[worst] > TRAIN_TOL["grad"]:
        raise AssertionError("the first dp x tp step disagrees with "
                             "train_step over the whole batch")

    # Phase 15: times of B5a and B5b at the fused MLP's shapes.
    x_b, up_b, down_b = mlp_args
    print(f"collective matmul times at the fused MLP's shapes on {card}:")
    overlap_rows = overlap_times(ov, mlp_mesh, x_b, up_b, down_b, mlp_hidden)

    overlap_probes(ov, make_mesh, gen, x_b, up_b)

    x_l, up_l, down_l = mlp_leaves

    def mlp_once():
        for t in (x_l, up_l, down_l):
            t.grad = None
        mlp_pair(tp, x_l, up_l, down_l, "x", mlp_mesh).backward(
            mlp_dy.view(x_l.shape))

    mlp_ms = event_ms(mlp_once, iters=20)
    mlp_dev, mlp_rows = device_profile(mlp_once, iters=10)
    busy = "not measured" if mlp_dev is None else f"{mlp_dev / mlp_ms:.3f}"
    print(f"fused MLP forward + backward ({mlp_mesh.shape['x']} ranks x "
          f"{x_l.shape[1]} rows): {mlp_ms:.6f} ms per call, device time "
          f"{mlp_dev} ms, device busy share {busy}")
    for dev_ms, calls, kname in mlp_rows[:8]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")

    def tp_once():
        tp_step(tp_model, tp_opt, tp_tokens, tp_targets)

    tp_ms = event_ms(tp_once, iters=10)
    tp_dev, tp_rows = device_profile(tp_once, iters=5)
    busy = "not measured" if tp_dev is None else f"{tp_dev / tp_ms:.3f}"
    print(f"dp x tp step ({tp_model.mesh.shape}, batch 8, seq 128, Adam): "
          f"{tp_ms:.6f} ms per step, device time {tp_dev} ms, device busy "
          f"share {busy}")
    for dev_ms, calls, kname in tp_rows[:8]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")

    # Phase 16: the ring-attention step kernels and the all-to-all against
    # their plain versions.
    step_errs = step_cases(attn, sp, spmd, make_mesh, gen)
    hidden_tiles_untouched(attn, sp, spmd, make_mesh, gen)
    unrounded_guard(attn, sp, spmd, make_mesh, gen)
    a2a_err = alltoall_cases(ring, make_mesh, gen)

    # Phase 17: the long-context path (path S).
    sp_launches, sp_paths = sp_path(attn, ring, sp_entry)

    # Phase 18: the MoE path (path E).
    ep_launches, ep = ep_path(ring, ep_entry, expert_mlp)

    # Phase 19: times of B6, B7a, B7b and B8 at the paths' shapes, and of
    # the three paths.
    slice5_rows = slice5_times(attn, sp, spmd, ring, sp_paths, ep, card)
    print(f"B8 launches: {sp_launches['ulysses'][4]} on the Ulysses path "
          f"(the kernels line), {ep_launches} on the MoE path")

    # Phase 20: the ring variants against their plain versions, and the
    # sum collectives at more dtypes.
    variant_errs = variant_cases(ring, make_mesh, gen)
    sum_dtype_cases(ring, spmd, make_mesh, gen)

    # Phase 21: the ring-variant path, and B10 on a DDP step's gradients.
    variant_launches, variant_paths = variants_path(ring,
                                                    ring_variants_entry)
    _, vx, vmesh = variant_paths["q8"][1]
    q8_on_ddp_grads(ring, ddp_train_entry, vx, vmesh)

    # Phase 22: times of B9, B10 and B11 at the path's shape; and phases
    # 21 and 22 at every sum dtype for B9 and B11.
    variant_rows = variant_times(ring, variant_paths, card)
    variant_dtypes(ring, variant_paths, card, gen)

    # Phase 23: the FSDP path (B4b, B4a and B3 around each rank's B1/B2).
    _, fsdp = fsdp_path(attn, ring, entry_mod, unshard_params, make_mesh,
                        cfg)

    # Phase 24: the pipeline path (B1 and B2 in every tick).
    _, pp_paths = pp_path(attn, pp, entry_mod)

    # Phase 25: times of the FSDP and pipeline paths, and the device time
    # under their scopes.
    parallel_times(tracing, fsdp, pp_paths, card)

    # Phases 26-28: the host plane in two processes on the card.
    hier = host_phases(card)

    # Phase 29: elastic acceptance on the card.
    elastic_phase(card)

    # Phase 30: the rest of the host plane's Context surface in three
    # processes on the card.
    surface_phase(card)

    # Phase 31: the flagship at one head of 256 in f16.
    d256_f16_phase(attn, ov, tp, ring, sp, spmd, make_mesh, entry_mod, gen,
                   card, rows, bwd_rows)

    # Phase 32: phase 28's step, encrypted and traced, under a fault and
    # the elected schedule and tuning table.
    traced_phase(card, hier)

    # Launches on the main paths: B1 on the serving path, B2 on the
    # training path, B3 on the DDP path, B4a and B4b on the group path,
    # B5a and B5b on the fused MLP path, B6 and B7 on the ring-flash path
    # (B7a and B7b are one fused launch: both rows carry its launches and
    # time), B8 on the Ulysses path, B9, B10 and B11 on the ring-variant
    # path. B6 and B10 have no library call.
    ring_flash = sp_launches["ring_flash"]
    kernels = []
    for kname, source, replaces, n, err, (ms, plain, lib, bound,
                                          bound_by) in (
            ("flash_fwd", "flash_fwd.cu", "attention.py:92", launches,
             entry_err, rows["entry"]),
            ("flash_bwd", "flash_bwd.cu", "attention.py:313",
             train_launches[1], entry_bwd_err, bwd_rows["entry"]),
            ("ring_allreduce", "ring.cu", "pallas_ring.py:63",
             ddp_launches[2], ring_err["ring_allreduce"],
             ring_rows["ring_allreduce"]),
            ("ring_reduce_scatter", "ring.cu", "pallas_ring.py:876",
             group_launches[1], ring_err["ring_reduce_scatter"],
             ring_rows["ring_reduce_scatter"]),
            ("ring_allgather", "ring.cu", "pallas_ring.py:995",
             group_launches[2], ring_err["ring_allgather"],
             ring_rows["ring_allgather"]),
            ("matmul_reduce_scatter", "overlap.cu", "overlap.py:38",
             mlp_launches[1], overlap_errs["mlp_bf16"][0],
             overlap_rows["matmul_reduce_scatter"]),
            ("allgather_matmul", "overlap.cu", "overlap.py:205",
             mlp_launches[0], overlap_errs["mlp_bf16"][1],
             overlap_rows["allgather_matmul"]),
            ("flash_step", "flash_step.cu", "attention.py:477", ring_flash[0],
             step_errs["pathS"][0], slice5_rows["flash_step"]),
            ("flash_bwd_dq_step", "flash_bwd_step.cu", "attention.py:588",
             ring_flash[1], step_errs["pathS"][1],
             slice5_rows["flash_bwd_step"]),
            ("flash_bwd_dkv_step", "flash_bwd_step.cu", "attention.py:635",
             ring_flash[1], step_errs["pathS"][2],
             slice5_rows["flash_bwd_step"]),
            ("alltoall", "alltoall.cu", "pallas_ring.py:1109",
             sp_launches["ulysses"][4], a2a_err, slice5_rows["alltoall"]),
            ("ring_allreduce_hbm", "ring_variants.cu", "pallas_ring.py:246",
             variant_launches["hbm"], variant_errs["hbm"],
             variant_rows["hbm"]),
            ("ring_allreduce_q8", "ring_variants.cu", "pallas_ring.py:485",
             variant_launches["q8"], variant_errs["q8"], variant_rows["q8"]),
            ("ring_allreduce_bidir", "ring_variants.cu",
             "pallas_ring.py:691", variant_launches["bidir"],
             variant_errs["bidir"], variant_rows["bidir"])):
        no_library = kname in ("flash_step", "ring_allreduce_q8")
        if None in (ms, plain) or (lib is None and not no_library):
            raise AssertionError(
                f"the profiler showed no device time for {kname}'s kernel, "
                f"plain or library call at the main path's shape")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"gloo_tpu_torch/csrc/{source}",
            "replaces": f"gloo_tpu/ops/{replaces}",
            "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def worker_main(argv):
    """`chip_smoke.py --worker PHASE RANK SIZE STORE`: one process of a
    host-plane phase; prints the phase's result as its last line."""
    phase, rank, size, store = argv[0], int(argv[1]), int(argv[2]), argv[3]
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke worker: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(WORKERS[phase](rank, size, store)))


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--worker"]:
        worker_main(sys.argv[2:])
    else:
        main()
