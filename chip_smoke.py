#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (gloo_tpu_torch) on one GPU and checks it.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from gloo_tpu_torch/csrc (set-up time);
  3. hold each kernel against its plain PyTorch version on the card: the
     flash forward, and the flash backward (in f32 also against autograd
     through the materialized-scores reference), at FLASH_CASES, head dims
     3 to 200 (zero-padded to the kernels' 64, 128 and 256) and 264 to
     1024 (the wide kernels) among them;
  4. the serving path: the flagship forward of gloo_tpu_torch.entry at full
     width plus greedy serving, with the kernels' launch counts read around
     it, and its logits against the same model on the CPU (plain attention);
  5. exact greedy-decode parity on an f32 copy of the model;
  6. the training path: 5 steps of gloo_tpu_torch.entry.train_step at full
     width, with the launch counts read around them, a falling loss, and
     the first step's loss and gradients against the same model on the CPU;
  7. times of each kernel, its plain version and the library yardstick
     at FLASH_CASES but UNTIMED_CASES (the entry shape, larger ones, the
     other head dims and the Ulysses path's whole-sequence shape; the
     backward's three launches each, beside SDPA's backward, named by the
     backend SDPA's dispatcher chose), and of the forward and the training
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
     busy share, and the encrypted hop beside a plaintext one;
 33. the tools and examples (tool_phase): tools/torch_bench.py --op all
     over 8 ranks on the card at the reference tool's default flash,
     overlap and tp_step shapes (tp_step 2048 x 4096 x 4096 over 8
     ranks) and two element counts, exit 0 with every row and no skipped
     one, B1, B2, B3, B5a, B5b and B9 each launching; its table and one
     JSON line of its p50s; examples/torch_device_plane.py (B1, B2, B3)
     and torch_fused_tp.py (B5a, B5b) in this process; B3 and B9 bitwise
     and B5a and B5b within overlap_close against their plain versions
     at the tool's shapes; torch_observability.py, torch_chaos.py,
     torch_flightrec.py and torch_recovery.py on CUDA tensors, each with
     its success lines; and the three viewers on dumps of the port's
     contexts on the card, torch_flightrec_view.py also on the flight-
     recorder example's dumps (a desync: exit 2 under --check);
 34. the device plane across processes (peer_phase, worker "34"): 4
     worker processes on the card, one rank each, the first 2, then the
     first 3, then all 4 joined by init_multihost; at 2 the probe (two processes bounce a counter through
     IPC-mapped .sys flags, one spinning thread each: round trips per
     second, the card's context switch); B3, B4a and B4b (the cross-process
     instances over the peer workspace) bitwise against their twins on the
     world, f32 and bf16 at (P, 1024 up to a multiple of P, 128) and at 4
     also the DDP buffer (4, 6912, 256) f32, each 10 calls back to back on
     inputs that differ; their device ms at the DDP buffer; then 5 steps of
     multihost_ddp_entry over 4 processes ((B1, B2, B3) = (2, 2, 1) per
     step per process), losses within TRAIN_TOL of phase 10's world step,
     first-step gradients and state_digest equal across the processes, and
     the step's event and device ms;
 35. tensor and expert parallelism across processes (tp_peer_phase, worker
     "35"): 4 worker processes on the card, one rank each; B8 (the
     cross-process instance) across 2, 3 and 4 processes bitwise against
     its twin, leading-axis and strided (split 1, concat 2) blocks in bf16
     and f32; B5a and B5b across 2 and 4 processes at the fused MLP's
     shape and a ragged one in bf16 and f16, bitwise against the one-card
     kernel on the same world and within overlap_close of the twin; each
     case 10 calls back to back; multihost_fused_mlp_entry's forward and
     backward (launches B5b 1, B5a 2, B4b 1 per process) and
     multihost_ep_entry's step (B8 4) bitwise against their world runs in
     one process; 5 multihost_dp_tp_entry steps ((B1, B2, B3) = (2, 2, 10)
     per step per process) within TRAIN_TOL of phase 14's losses, the
     replicated parameters bitwise across the processes and the shards
     across data ranks; the cross-process kernels' device and event ms at
     the paths' shapes and the dp x tp step's ms and busy share;
 36. the ring variants, spmd's point-to-point collectives, and sequence
     and pipeline parallelism across processes (spp_peer_phase, worker
     "36"): 4 worker processes on the card, one rank each; B9, B10 and
     B11 (the cross-process instances) across 2, 3 and 4 processes at the
     ring-variant buffer and a ragged shape (B9 and B11 in f32 and bf16,
     B10 in f32 and at 4 past its register form), bitwise against the
     one-card kernel on the same world and equal to the twin, each case
     10 calls back to back; the transport (ppermute, shift +-1 with and
     without wrap, broadcast, scatter; csrc/permute.cu), max/min/product
     on the cross-process B4b, barrier on B3 and CudaProcessGroup's
     broadcast, send_recv and barrier, bitwise against the world's spmd,
     in f32, bf16 and int32, two rounds; shift by +-1 with wrap and +1
     without at the ring-flash path's shapes (a K block in bf16 and a
     dK/dV carrier in f32: the multi-slice launches that path makes),
     bitwise against the world's shift; then, each
     against its world run in this process (written to a file the
     workers read): multihost_ring_variants_entry's three steps (2
     launches each, bitwise), multihost_sp_entry's ring-flash and Ulysses
     forward + backward and ring attention's forward (launches (B6, B7,
     prep, finish, pull) = (4, 4, 1, 1, 20), (B8, B1, B2) = (8, 1, 1),
     pull 6; ring attention bitwise, the other two within SP_TOL), 3
     multihost_pp_entry 1F1B steps within TRAIN_TOL and a GPipe forward
     bitwise; the cross-process kernels' and the transport's device ms
     per launch and event ms per call, and each path's event ms;
 37. FSDP across processes (fsdp_peer_phase, worker "37"): 4 worker
     processes on the card, one rank each, run FSDP_PEER_STEPS steps of
     multihost_fsdp_entry ((B4b, B4a, B3, B1, B2) = (15, 15, 1, 2, 2) per
     step per process, B3, B4a and B4b the cross-process instances), the
     losses equal on every process and within TRAIN_TOL of phase 23's
     world steps, the gathered parameters' state_digest equal across the
     processes after each step, and rank 0's rows of them held against
     phase 23's world parameters after the same step (state_digest, and
     the step's implied gradient within FSDP_PEER_GRAD_TOL of the
     world's); the step's event and device ms and the device ms per
     cross-process launch;
 38. the flagship at head widths 36 and 512 (head_width_phase:
     entry.D36_CONFIG, 8 heads of 36 on the zero-padded d 64 instances,
     and entry.D512_CONFIG, one head of 512 on the wide kernels of
     csrc/flash_wide.cuh), bf16: each configuration's forward and greedy
     generate ((B1, B2) = (2, 0)), 5 training steps ((10, 10)) and
     ring-flash at its heads and head width over 4 ranks of 4096 tokens,
     batch 2 ((B6, B7, prep, finish) = (4, 4, 1, 1)), held against the
     same model or ring on the CPU; then B6 and B7 per launch at D512's
     ring (B7 beside aten's memory-efficient backward). The new head
     widths (3 to 1024: odd, not multiples of 8, past 256) are held
     against their twins in phases 3 and 16 (FLASH_CASES, STEP_CASES);
     phase 7 times the two configurations' forward shapes among them;
 39. worlds past 32 ranks (wide_world_phase): entry.dryrun_multichip at
     WIDE_RANKS (64) ranks on the card with the reference's asserts and
     the launch counts of every kernel it reaches (B3, B4a, B4b, B5a,
     B5b, B8, B9, B10, B11, B1); the nine one-card collectives at 64 ranks
     against their plain versions on WIDE_MESHES (bitwise; B5a/B5b within
     overlap_close); ring_variants_entry(ranks=64) forward and backward
     and B3 on that flagship buffer (64, 8192, 256) f32, bitwise their
     plain versions; each kernel's device ms per launch at 64 ranks
     beside its bytes bound; and the cross-process B3 over
     WIDE_PEER_PROCESSES processes of 32 local ranks (worker "39"),
     bitwise the world's plain rows.
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
# each step taking the d-wide acc view the step before returned. The rows
# from "d3_f32" on take head dims no instance has: odd widths of the
# carried acc (25, 263), and the wide kernels past 256 at 4 chained steps
# ("d512_pathS", phase 38's D512 ring) as at 2.
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
    ("d3_f32", 2, 1, 2, 2, 64, 3, torch.float32, True),
    ("d12_gqa", 4, 1, 4, 2, 128, 12, torch.bfloat16, True),
    ("d25_ragged_t100_f16", 2, 1, 2, 2, 100, 25, torch.float16, True),
    ("d36_gqa_t256", 4, 1, 8, 2, 256, 36, torch.bfloat16, True),
    ("d263_odd", 2, 1, 2, 2, 64, 263, torch.bfloat16, True),
    ("d264_gqa_f16", 2, 1, 4, 2, 128, 264, torch.float16, True),
    ("d300_f32_full", 2, 1, 2, 2, 100, 300, torch.float32, False),
    ("d512_pathS", 4, 2, 1, 1, 1024, 512, torch.bfloat16, True),
    ("d1024", 2, 1, 1, 1, 128, 1024, torch.bfloat16, True),
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
# (tests/test_flash_attention.py:131) at a longer sequence. The rows from
# "d3_f32_t72" on take head dims no instance has (odd, not multiples of 8,
# past 256: the wide kernels); "d36_path" and "d512_path" are phase 38's
# D36_CONFIG and D512_CONFIG forward shapes.
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
    ("d3_f32_t72", 2, 2, 2, 72, 3, torch.float32, True),
    ("d12_bf16", 2, 4, 4, 128, 12, torch.bfloat16, True),
    ("d25_gqa_f16_t100", 2, 4, 2, 100, 25, torch.float16, True),
    ("d36_path", 8, 8, 8, 128, 36, torch.bfloat16, True),
    ("d264_gqa_f16", 2, 4, 2, 256, 264, torch.float16, True),
    ("d300_f32_t100_full", 2, 2, 2, 100, 300, torch.float32, False),
    ("d512_path", 8, 1, 1, 128, 512, torch.bfloat16, True),
    ("d1024_bf16", 2, 2, 2, 256, 1024, torch.bfloat16, True),
]
# FLASH_CASES rows held against their twins in phase 3 and not timed in
# phase 7, where each row costs seconds of profiler sessions: the path
# shapes "d36_path" and "d512_path" stand for the padded and the wide
# kernels there, and the kernels line reads them.
UNTIMED_CASES = ("d3_f32_t72", "d12_bf16", "d25_gqa_f16_t100",
                 "d264_gqa_f16", "d300_f32_t100_full", "d1024_bf16")


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


def device_profile(fn, iters=20, want=(), sessions=6, kinds=0):
    """Per-call device time of fn from torch.profiler (CUPTI): (total ms or
    None where the trace shows no device time, [(ms, calls, name)] per
    kernel name, longest first). A session whose trace holds no device
    time, for one of the names in `want` no kernel whose name contains
    it, or fewer than `kinds` kernel names, is taken again, up to
    `sessions` times: now and then a session records nothing, or only
    part of the launches."""
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
        if rows and all(any(w in r[2] for r in rows) for w in want) \
                and len(rows) >= kinds:
            break
    total = sum(r[0] for r in rows)
    return (total if total > 0 else None), rows


def sdpa_backend(q, k, v, causal):
    """The backend SDPA runs q, k, v on (flash, efficient, cudnn or math),
    as its dispatcher chooses it (torch._fused_sdp_choice, which weighs
    requires_grad too), confirmed by one call with only that backend
    allowed: SDPA raises there if it cannot run on it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gqa = q.shape[1] != k.shape[1]
    backend = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                                 enable_gqa=gqa))
    with sdpa_kernel(backend):
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       enable_gqa=gqa)
    return backend.name.lower().removesuffix("_attention")


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


def timed(label, fn, iters=20, kinds=0):
    """Device ms per call from the profiler, or None where its trace shows
    no device time; the per-call time between CUDA events is printed
    beside it and never stands in for it. Where fn launches `kinds`
    kernels of different names once each, the time is the sum of each
    one's mean per launch, so a record the trace drops does not lower it,
    and None unless every one of them is seen."""
    total, rows = device_profile(fn, iters, kinds=kinds)
    dev = total if not kinds else (
        sum(r[0] / r[1] for r in rows) if len(rows) >= kinds else None)
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
    """B7's library yardstick: per ring step one call of aten's fused
    attention backward on the global out and lse and the cotangent g
    (step 0 causal over every row, step i > 0 full over the contiguous
    rows of the ranks whose block is visible; the other rows' blocks are
    hidden): up to d 256 _scaled_dot_product_flash_attention_backward,
    past it _scaled_dot_product_efficient_attention_backward (no head_dim
    ceiling; lse zero-padded to the forward's rows of 32, and out laid
    out as its forward lays it, (b, t, h, d) in memory: the kernel reads
    out at a row stride of h d whatever its strides say), each with its
    philox seed and offset from one forward of its kind on the same
    shapes. Returns (the op's name, fn over the n steps, [(rows, dq, dk,
    dv) of each step])."""
    bh, t, d = qf.shape
    aten = torch.ops.aten
    wide = d > 256
    op = (aten._scaled_dot_product_efficient_attention_backward if wide
          else aten._scaled_dot_product_flash_attention_backward)
    calls = []
    for i, (ks, vs, _) in enumerate(steps):
        r0 = i * rows_per_rank
        q4, k4, v4, o4, g4 = (x.reshape(1, bh, t, d)[:, r0:] for x in
                              (qf, ks, vs, out, g))
        l4 = lse.reshape(1, bh, t)[:, r0:].contiguous()
        if wide:
            fwd = aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True, 0.0, i == 0)
            l4 = F.pad(l4, (0, fwd[1].shape[-1] - t))
            o4 = o4.transpose(1, 2).contiguous().transpose(1, 2)
            args = (g4, q4, k4, v4, None, o4, l4, fwd[2], fwd[3], 0.0,
                    [True, True, True, False], i == 0)
        else:
            fwd = aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, i == 0)
            args = (g4, q4, k4, v4, o4, l4, fwd[2], fwd[3], t, t, 0.0,
                    i == 0, fwd[6], fwd[7])
        calls.append((r0, args))

    def run():
        return [op(*args)[:3] for _, args in calls]

    return (op.__name__, run,
            [(r0, *grads) for (r0, _), grads in zip(calls, run())])


def b7_times(attn, qf, steps, q_off, out, lse, pairs, n, kernel):
    """Phase 19's B7: the fused launch (the kernel named `kernel`) over the
    path's ring steps as the ring backward makes it (prepare_bwd_step once,
    then flash_attention_bwd_step_into into f32 carriers), with the path's
    own cotangent (cos(out) in q's dtype, as sp_step's loss hands it over)
    and with an f32 torch.randn one; the plain version; the library
    yardstick (b7_library), checked against the fresh step of the plain
    version. Returns the kernels line's (ms, plain ms, library ms or None, bound,
    bound by) of the path's cotangent."""
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
                              fused, kernel)
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
    lib_name, lib_fn, lib_out = b7_library(qf, steps, q_off, out, lse, g,
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
                    f"aten.{lib_name}", lib_fn)
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
    (averaged), bounds, plain versions and yardsticks; the wgmma instances,
    or past d 256 the wide kernels. Returns {"flash_step": row,
    "flash_bwd_step": row}, rows as the kernels line's (ms, plain ms,
    library ms or None, bound ms, bound by)."""
    qf, steps, q_off, group = ring_steps(sp, spmd, q, k, v, "seq", mesh,
                                         True)
    bh, t, d = qf.shape
    n = len(steps)
    form = "wide" if d > attn.KERNEL_HEAD_DIMS[-1] else "wgmma"
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
                          f"flash_step_{form}_kernel")
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
                                      pairs, n, f"bwd_step_{form}_kernel")
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
                    lambda: x.sum(0).expand(ranks, -1, -1).contiguous(),
                    kinds=2)
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
    the CPU. Returns (launches, the losses, rank 0's rows of the gathered
    parameters on the CPU before the steps and after each of the first
    FSDP_PEER_STEPS, the entry's (step, args))."""
    step, (sharded, batch) = entry_mod.fsdp_train_entry()
    ranks, lr = entry_mod.FSDP_MESH["data"], entry_mod.FSDP_LR
    counters = (ring.ring_allgather, ring.ring_reduce_scatter,
                ring.ring_allreduce, attn.flash_attention_fwd,
                attn.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    state, losses, states = sharded, [], [sharded]
    for i in range(FSDP_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
        if i < FSDP_PEER_STEPS:
            states.append(state)
    first = states[1]
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
    world = [{n: v[0].cpu() for n, v in unshard_params(
        s, template, "data", mesh=mesh).items()} for s in states]
    return launches, losses, world, (step, (sharded, batch))


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
# The long-context shape of phases 31's and 38's ring-flash: the
# sp_entry's world of SP_MESH ranks over a global sequence of SP_SEQ, batch
# 2, at the configuration's heads and head width.
SP_CONFIG_BATCH = 2


def config_serving(attn, cfg, entry_fn, tol, label, device="cuda"):
    """A configuration's serving path (phases 31, 38): entry_fn()'s forward
    and greedy generate, with B1/B2's launches read around them; logits
    against the same model on the CPU within `tol`. Returns (fn, model,
    tokens, prompts)."""
    from gloo_tpu_torch.entry import forward
    from gloo_tpu_torch.models import Transformer

    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd.launches = 0
    fn, (model, tokens) = entry_fn(device)
    logits = fn(model, tokens)
    prompts = tokens[:4, :16]
    served = model.generate(prompts, max_new=8)
    torch.cuda.synchronize()
    launches = (attn.flash_attention_fwd.launches,
                attn.flash_attention_bwd.launches)
    cpu_model = Transformer(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    ref = forward(cpu_model, tokens.cpu())
    err, ok = max_err(logits.cpu(), ref, *tol)
    print(f"{label} serving path ({cfg.n_heads} head(s) of "
          f"{cfg.head_dim}, {str(cfg.dtype)[6:]}): forward logits "
          f"{tuple(logits.shape)}, generate {tuple(served.shape)}; "
          f"launches flash_fwd, flash_bwd {launches}; logits vs the CPU "
          f"model max_abs_err {err:.3e} (rtol, atol {tol}), "
          f"|logits| max {float(ref.abs().max()):.3f}")
    if launches != (cfg.n_layers, 0):
        raise AssertionError(f"the {label} serving path launched (B1, B2) "
                             f"{launches}, expected ({cfg.n_layers}, 0)")
    if logits.shape != (8, cfg.max_seq_len, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()) or not ok:
        raise AssertionError(f"the {label} logits are malformed or "
                             f"disagree with the CPU model")
    if not torch.equal(served[:, :16], prompts) \
            or int(served.min()) < 0 or int(served.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label} generate returned malformed tokens")
    return fn, model, tokens, prompts


def config_training(attn, cfg, train_entry_fn, tol, label, device="cuda"):
    """A configuration's training path (phases 31, 38): TRAIN_STEPS steps
    of train_entry_fn(), B1/B2's launches read around them, a falling loss,
    the first step against the CPU model within `tol`. Returns the step's
    (step, (model, optimizer, tokens, targets))."""
    from gloo_tpu_torch.models import Transformer

    step, args = train_entry_fn(device)
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
    print(f"{label} training path: {TRAIN_STEPS} steps, losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; launches flash_fwd, "
          f"flash_bwd {launches}; first step vs the CPU model: loss rel "
          f"{loss_rel:.3e} (tol {tol['loss']}), grads |g - "
          f"g_cpu| / |g_cpu| max {grad_rel[worst]:.3e} at {worst} (tol "
          f"{tol['grad']})")
    want = TRAIN_STEPS * cfg.n_layers
    if launches != (want, want):
        raise AssertionError(f"{label} training launched (B1, B2) "
                             f"{launches}, expected ({want}, {want})")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        raise AssertionError(f"{label} training loss is not finite and "
                             f"falling: {losses}")
    if loss_rel > tol["loss"] or grad_rel[worst] > tol["grad"]:
        raise AssertionError(f"the first {label} training step disagrees "
                             f"with the CPU model")
    return step, args


def config_ring_flash(attn, sp, make_mesh, entry_mod, heads, d, dtype, tol,
                      label, device="cuda"):
    """A configuration's ring-flash (phases 31, 38):
    sp_step(ring_flash_attention) at `heads` heads of d over SP_MESH ranks
    of the global SP_SEQ, batch SP_CONFIG_BATCH, B6/B7's launches (B6, B7,
    prep, finish) read around it, against the same ring on the CPU within
    `tol` (|a - b| / |b| of the output and each gradient). Returns (fn,
    args, the card's launches)."""
    from gloo_tpu_torch.entry import SP_MESH, SP_SEQ

    n = SP_MESH["seq"]
    dev = torch.device(device)
    shape = (n, SP_CONFIG_BATCH, heads, SP_SEQ // n, d)
    rng = np.random.RandomState(0)
    host = [torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dtype)
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
    print(f"{label} ring-flash path: {n} ranks x (b {SP_CONFIG_BATCH}, h "
          f"{heads}, t {SP_SEQ // n}, d {d}) {str(dtype)[6:]} causal, "
          f"forward + backward of sum(sin(out)); launches flash_step, "
          f"flash_bwd_step, prepare, finish {launches}; against the same "
          f"ring on the CPU |a - b| / |b|: "
          f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())} (tol "
          f"{tol})")
    if launches != (n, n, 1, 1):
        raise AssertionError(f"the {label} ring-flash launched {launches}, "
                             f"expected ({n}, {n}, 1, 1)")
    if max(rels.values()) > tol or not all(
            bool(torch.isfinite(x.float()).all()) for x in results[0]):
        raise AssertionError(f"the {label} ring-flash disagrees with the "
                             f"CPU")
    return entry_mod.sp_step, on_card, launches


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
    cfg = entry_mod.D256_F16_CONFIG
    fn, model, tokens, prompts = config_serving(
        attn, cfg, entry_mod.d256_f16_entry, D256_LOGITS_TOL, "d256 f16")
    step, targs = config_training(attn, cfg, entry_mod.d256_f16_train_entry,
                                  D256_TRAIN_TOL, "d256 f16")
    sp_fn, sp_args, _ = config_ring_flash(attn, sp, make_mesh, entry_mod, 1,
                                          256, torch.float16, D256_SP_TOL,
                                          "d256 f16")
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


# ---- phase 38: the flagship at head widths 36 and 512 ----
# entry.D36_CONFIG (8 heads of 36: the padded d 64 instances of B1, B2, B6
# and B7) and entry.D512_CONFIG (one head of 512: the wide kernels), both
# bf16, each on its serving path, 5 training steps and ring-flash at its
# heads and head width over SP_MESH ranks of SP_SEQ, held as phases 4, 6
# and 17 hold the bf16 flagship (LOGITS_TOL, TRAIN_TOL, SP_TOL) against the
# same model or ring on the CPU; then B6 and B7 per launch at D512's ring.
HEAD_WIDTH_CONFIGS = ("D36_CONFIG", "D512_CONFIG")


def head_width_phase(attn, sp, spmd, make_mesh, entry_mod, card):
    """Phase 38: serving, training and ring-flash of D36_CONFIG and
    D512_CONFIG, each with its launch counts read around it and held
    against the CPU; B6 and B7 timed at D512's ring. Returns {"launches":
    D512's (B1 serving, B2 training, B6, B7 ring-flash), "steps":
    step_kernel_times' rows}."""
    t_phase = time.perf_counter()
    launches = {}
    for name in HEAD_WIDTH_CONFIGS:
        cfg = getattr(entry_mod, name)
        hd = cfg.head_dim
        label = f"d{hd} bf16"
        dim = attn.kernel_head_dim(hd)
        print(f"{label} ({name}): the kernels run at head_dim {dim}"
              + (" (the wide kernels)" if dim > attn.KERNEL_HEAD_DIMS[-1]
                 else " (zero-padded instance)"))
        config_serving(attn, cfg, getattr(entry_mod, f"d{hd}_entry"),
                       LOGITS_TOL, label)
        b1 = attn.flash_attention_fwd.launches
        config_training(attn, cfg, getattr(entry_mod, f"d{hd}_train_entry"),
                        TRAIN_TOL, label)
        b2 = attn.flash_attention_bwd.launches
        _, sp_args, ring = config_ring_flash(attn, sp, make_mesh, entry_mod,
                                             cfg.n_heads, hd, cfg.dtype,
                                             SP_TOL, label)
        launches[name] = (b1, b2, *ring[:2])
    _, q, k, v, mesh = sp_args
    steps = step_kernel_times(attn, sp, spmd, q, k, v, mesh, card,
                              "the d512 bf16 ring-flash's")
    print(f"phase 38: {time.perf_counter() - t_phase:.1f} s; launches (B1 "
          f"serving, B2 training, B6, B7 ring-flash) {launches}")
    return {"launches": launches["D512_CONFIG"], "steps": steps}


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
    late = []
    try:
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                late.append(rank)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if late:
        tails = []
        for rank, (out, err) in enumerate(logs):
            out.seek(0)
            err.seek(0)
            tails.append(f"worker {rank}: {out.read()[-1500:]}"
                         f"{err.read()[-3000:]}")
        raise AssertionError(f"phase {phase}: workers {late} outlived "
                             f"{timeout} s:\n" + "\n".join(tails))
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


# ---- phase 33: the device-plane bench tool, the examples, the viewers ----
# tools/torch_bench.py at the reference tool's default flash, overlap and
# tp_step shapes (tp_step 2048 x 4096 x 4096 over 8 ranks: the slice's
# full-width path), two element counts of the collectives.
BENCH_ELEMENTS = (1048576, 16777216)
BENCH_ARGV = ["--op", "all", "--ranks", "8", "--elements",
              ",".join(map(str, BENCH_ELEMENTS)), "--min-time", "0.2"]
# Rows the run must print: 7 collectives x 2 element counts, flash and
# flash_bwd at t 1024 and 16384, 3 overlap shapes x 3, 2 tp_step arms.
BENCH_ROWS = 7 * 2 + 2 * 2 + 3 * 3 + 2
# The examples run as processes on the card, each with its success lines.
CARD_EXAMPLES = {
    "torch_observability.py": ("observability example OK",
                               "[watchdog] rank0 was blocked",
                               "labeled rank rows"),
    "torch_chaos.py": ("chaos example: OK", "fault firing sequence:",
                       "rebuilt OK", "merged chaos trace"),
    "torch_flightrec.py": ("flightrec example: OK",
                           "reason=stall blamed_peer=1",
                           "desync verdict: collective desync"),
    "torch_recovery.py": ("recovery example: OK",
                          "finished 100 steps in world of 2"),
}
EXAMPLE_TIMEOUT = 240
VIEWER_RANKS = 2


def load_file(rel):
    """A tool or example of this checkout, imported from its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def viewer_dumps(directory):
    """Flight-recorder, span and profile dumps of VIEWER_RANKS thread
    ranks allreducing CUDA tensors (four ring allreduces of 1 MiB with
    the profiler and the span recorder on), for the viewers."""
    import threading

    from gloo_tpu_torch import Context, Device, HashStore
    from gloo_tpu_torch.utils import critpath, flightrec

    store, errors = HashStore(), []

    def rank_main(rank):
        try:
            ctx = Context(rank, VIEWER_RANKS, timeout=60.0)
            ctx.connect_full_mesh(store, Device())
            ctx.profile_enable(True)
            ctx.spans_enable(True)
            x = torch.ones(1 << 18, device="cuda")
            for _ in range(4):
                ctx.allreduce(x, algorithm="ring")
                x.fill_(1.0)
            ctx.barrier()
            flightrec.dump(ctx, directory)
            critpath.dump(ctx, directory)
            with open(os.path.join(directory, f"profile-rank{rank}.json"),
                      "w") as f:
                json.dump(ctx.profile(), f)
            ctx.close()
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append((rank, exc))

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(VIEWER_RANKS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        if t.is_alive():
            raise AssertionError("phase 33: a viewer-dump rank hung")
    if errors:
        raise AssertionError(f"phase 33: viewer dumps failed: {errors}")


def run_viewer(viewer, argv, want_code):
    """tools/torch_<viewer>_view.py ARGV in this process, as `python
    tools/torch_<viewer>_view.py ARGV` runs it (its directory first on
    sys.path); its output, which must be non-empty, with exit status
    want_code."""
    import contextlib
    import io
    import runpy
    import sys

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", f"torch_{viewer}_view.py")
    out, argv_before, path_before = io.StringIO(), sys.argv, list(sys.path)
    sys.argv = [path, *argv]
    sys.path.insert(0, os.path.dirname(path))
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
        code = 0
    except SystemExit as exc:
        code = exc.code
    finally:
        sys.argv, sys.path[:] = argv_before, path_before
    text = out.getvalue()
    first = text.strip().splitlines()[:1]
    print(f"  torch_{viewer}_view {' '.join(argv[1:])}: exit {code}; "
          f"{first[0] if first else 'no output'}")
    if code != want_code or not text.strip():
        raise AssertionError(f"phase 33: torch_{viewer}_view exited {code} "
                             f"(want {want_code}):\n{text[-3000:]}")
    return text


def start_card_examples(directory):
    """Starts CARD_EXAMPLES as processes on the card, all at once (each
    splits the cores between its workers); the flight-recorder example's
    dumps go to `directory`/flightrec-demo. Returns what
    finish_card_examples takes."""
    import sys

    root = os.path.dirname(os.path.abspath(__file__))
    fr_dir = os.path.join(directory, "flightrec-demo")
    procs = {}
    for name in CARD_EXAMPLES:
        extra = ["--out", fr_dir] if name == "torch_flightrec.py" else \
            ["--out", directory] if name == "torch_observability.py" else []
        out = open(os.path.join(directory, f"{name}.out"), "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, os.path.join(root, "examples", name),
             "--device", "cuda", *extra], stdout=out,
            stderr=subprocess.STDOUT), out)
    return procs, fr_dir, time.monotonic() + EXAMPLE_TIMEOUT


def finish_card_examples(started):
    """Waits for start_card_examples' processes (none outlives its
    deadline); raises unless each exits 0 and prints its success lines.
    Returns the flight-recorder example's dump directory."""
    procs, fr_dir, deadline = started
    try:
        for p, _ in procs.values():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for name, (p, out) in procs.items():
        out.seek(0)
        text = out.read()
        out.close()
        missing = [m for m in CARD_EXAMPLES[name] if m not in text]
        lines = [ln for ln in text.splitlines()
                 if not ln.startswith("[tpucoll")]
        print(f"  {name} --device cuda: exit {p.returncode}; "
              f"{lines[-1] if lines else 'no output'}")
        if p.returncode != 0 or missing:
            failed.append(name)
            print(f"    missing {missing}:\n{text[-4000:]}")
    if failed:
        raise AssertionError(f"phase 33: examples failed on the card: "
                             f"{failed}")
    return fr_dir


def tool_phase(attn, ov, ring, make_mesh, gen, card):
    """Phase 33: tools/torch_bench.py BENCH_ARGV on the card, alone (exit
    0, BENCH_ROWS rows, no skipped row), with the launch counts of B1, B2,
    B3, B5a, B5b and B9 read around it (each must launch); then, while
    the host-plane examples run as processes on CUDA tensors, the
    device-plane and fused-TP examples in this process with their counts
    (B1, B2 and B3; B5a and B5b), B3 and B9 bitwise against their plain
    versions at the tool's pallas_ring shape and B5a and B5b within
    overlap_close at its first overlap shape, and the three viewers on
    dumps of the port's contexts on the card; last torch_flightrec_view
    on the flight-recorder example's dumps (a desync: exit 2 under
    --check). Prints the tool's table, one JSON line of its p50s and the
    parts' seconds; returns the tool's launch counts."""
    import contextlib
    import io
    import tempfile

    t_phase = time.perf_counter()
    parts = {}
    counters = {"B1": attn.flash_attention_fwd,
                "B2": attn.flash_attention_bwd, "B3": ring.ring_allreduce,
                "B5a": ov.matmul_reduce_scatter,
                "B5b": ov.allgather_matmul, "B9": ring.ring_allreduce_hbm}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    bench = load_file(os.path.join("tools", "torch_bench.py"))
    rows, table = [], io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(table):
            code, tool_launches = counted(
                lambda: bench.main(BENCH_ARGV, rows=rows))
    finally:
        print(table.getvalue(), end="")
    parts["torch_bench"] = time.perf_counter() - t0
    print(f"torch_bench {' '.join(BENCH_ARGV)}: exit {code}, {len(rows)} "
          f"rows; launches {tool_launches} [{card}]")
    failed = []
    if code != 0 or "skipped" in table.getvalue() or len(rows) != BENCH_ROWS:
        failed.append("torch_bench")
    if not all(tool_launches.values()):
        failed.append("torch_bench launches")
    print(json.dumps({"torch_bench_p50_us": {
        f"{r['op']}@{r['elements']}": r["p50_us"] for r in rows}}))

    scratch = tempfile.mkdtemp(prefix="chip_smoke-33-")
    t_examples = time.perf_counter()
    started = start_card_examples(scratch)
    try:
        t0 = time.perf_counter()
        plane = load_file(os.path.join("examples", "torch_device_plane.py"))
        _, plane_launches = counted(lambda: plane.main(["--device", "cuda"]))
        fused = load_file(os.path.join("examples", "torch_fused_tp.py"))
        _, tp_launches = counted(lambda: fused.main(["--device", "cuda"]))
        parts["device examples"] = time.perf_counter() - t0
        print(f"examples in this process: torch_device_plane launches "
              f"{plane_launches}, torch_fused_tp launches {tp_launches}")
        if not (plane_launches["B1"] and plane_launches["B2"]
                and plane_launches["B3"]):
            failed.append("torch_device_plane launches")
        if not (tp_launches["B5a"] and tp_launches["B5b"]):
            failed.append("torch_fused_tp launches")

        # The kernels against their plain versions at the tool's shapes.
        t0 = time.perf_counter()
        n = 8
        mesh = make_mesh({"data": n}, devices=[torch.device("cuda")] * n)
        rows_per = BENCH_ELEMENTS[0] // n // 128
        x = torch.randn((n, rows_per, 128), generator=gen, device="cuda")
        for fn, plain in ((ring.ring_allreduce, ring.ring_allreduce_plain),
                          (ring.ring_allreduce_hbm,
                           ring.ring_allreduce_hbm_plain)):
            if ring_check("torch_bench pallas_ring shape", fn, plain, x,
                          "data", mesh, runs=3)[2]:
                failed.append(fn.__name__)
        m, k = (int(v) for v in bench.parse_args([]).overlap_shapes
                .split(",")[0].split("x"))
        xo = torch.randn((n, m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        wo = (torch.randn((n, k, k), generator=gen, device="cuda")
              / math.sqrt(k)).to(torch.bfloat16)
        with torch.no_grad():
            a_err, a_ok = overlap_close(
                ov.matmul_reduce_scatter(xo, wo, "data", mesh),
                ov.matmul_reduce_scatter_plain(xo, wo, "data", mesh))
            xs = xo[:, :m // n].contiguous()
            b_err, b_ok = overlap_close(
                ov.allgather_matmul_fwd(xs, wo, "data", mesh)[0],
                ov.allgather_matmul_plain(xs, wo, "data", mesh)[0])
        print(f"overlap at torch_bench's {m}x{k} over {n} ranks, bf16: max "
              f"|kernel - plain| B5a {a_err:.3e} ({a_ok}), B5b "
              f"{b_err:.3e} ({b_ok})")
        if not (a_ok and b_ok):
            failed.append("overlap at the tool's shape")
        parts["kernel checks"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dumps = os.path.join(scratch, "dumps")
        viewer_dumps(dumps)
        run_viewer("flightrec", [dumps, "--check"], 0)
        run_viewer("critpath", [dumps], 0)
        run_viewer("critpath", [dumps, "--json"], 0)
        run_viewer("profile", [dumps, "--ops", "3"], 0)
        parts["viewers"] = time.perf_counter() - t0
    finally:
        fr_dir = finish_card_examples(started)
    parts["host examples, from their start"] = \
        time.perf_counter() - t_examples
    out = run_viewer("flightrec", [fr_dir, "--check"], 2)
    if "verdict: DESYNC" not in out:
        failed.append("torch_flightrec_view verdict")
    print(f"phase 33: {time.perf_counter() - t_phase:.1f} s; parts (s) "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    if failed:
        raise AssertionError(f"phase 33 failed: {failed}")
    return tool_launches


# Phase 34: the device plane across processes, in PEER_SIZES[-1] worker
# processes on the card, one rank each. The first 2, then the first 3,
# form a mesh of their own (init_multihost on a port of their own while
# the rest wait at a barrier of the whole group), then all 4: at 2 the
# probe (PROBE_ROUNDS round trips), at each size B3, B4a and B4b against
# their twins at PEER_CASES (each PEER_BACK_TO_BACK calls back to back,
# input k the case's world + k), at 4 also at the DDP buffer and timed;
# then DDP_STEPS steps of multihost_ddp_entry over the 4 processes.
PEER_SIZES = (2, 3, 4)
# (dtype, rows per rank, cols): rows 1024, up to a multiple of P.
PEER_CASES = ((torch.float32, 1024, 128), (torch.bfloat16, 1024, 128))
# The DDP buffer as ring_variants_entry lays it out: (4, 6912, 256) f32.
PEER_DDP_CASE = (torch.float32, 6912, 256)
PEER_BACK_TO_BACK = 10
PROBE_ROUNDS = (10, 100, 400)
PEER_TIME_ITERS = 10
PEER_TIMEOUT = 240
PEER_NAMES = ("ring_allreduce", "ring_reduce_scatter", "ring_allgather")


def peer_tensor(dtype, shape, k, device, seed=35):
    """Input k of a case: the same world on every process, drawn on the
    card from a seeded generator, plus k."""
    gen = torch.Generator(device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) + k).to(dtype)


def peer_world(dtype, p, rows, cols, k, device):
    """Input k of a case: the same (p, rows, cols) on every process, drawn
    on the card from a seeded generator, plus k."""
    return peer_tensor(dtype, (p, rows, cols), k, device, seed=34)


def same_calls(fn, rank, iters, want=()):
    """Rank 0 profiles fn (device_profile: one call, then one session of
    `iters`); the other ranks make the same iters + 1 calls, as every
    process of a cross-process collective must."""
    if rank == 0:
        return device_profile(fn, iters=iters, want=want, sessions=1)
    for _ in range(iters + 1):
        fn()
    torch.cuda.synchronize()
    return None, []


def kernel_ms(rows, name):
    """Device ms per launch of the kernels whose names contain `name`."""
    mine = [r for r in rows if name in r[2]]
    return sum(r[0] / r[1] for r in mine) if mine else None


def peer_bound(name, p, per_rank):
    """Bytes of B3 (2 P S), B4a (P S + S) and B4b (S + P S, each rank's
    input S / P) for S bytes per rank of output, as phase 11 counts
    them."""
    return {"ring_allreduce": 2 * p * per_rank,
            "ring_reduce_scatter": p * per_rank + per_rank,
            "ring_allgather": per_rank + p * per_rank}[name]


def peer_cases(ring, mesh, size, device, note=print):
    """B3, B4a and B4b on the process mesh against their twins on the
    world on the card: {"wrong": [...], "err": {name: max |kernel -
    plain|}, "launches": {name: count}, "cases": calls}."""
    cases = list(PEER_CASES) + ([PEER_DDP_CASE] if size == 4 else [])
    fns = {name: getattr(ring, name) for name in PEER_NAMES}
    for fn in fns.values():
        fn.launches = 0
    wrong, err = [], dict.fromkeys(PEER_NAMES, 0.0)
    mine = torch.tensor(mesh.local_ranks)
    for dtype, rows, cols in cases:
        rows = -(-rows // size) * size
        worlds = [peer_world(dtype, size, rows, cols, k, device)
                  for k in range(PEER_BACK_TO_BACK)]
        for name, fn in fns.items():
            plain = getattr(ring, name + "_plain")
            xs = [w[:, :rows // size] if name == "ring_allgather" else w
                  for w in worlds]
            outs = [fn(x[mine], "data", mesh) for x in xs]
            torch.cuda.synchronize()
            note(f"{name} {str(dtype)[6:]} ({size}, {rows}, {cols})")
            for k, (x, out) in enumerate(zip(xs, outs)):
                ref = plain(x, "data", mesh)[mine]
                err[name] = max(err[name], float(
                    (out.float() - ref.float()).abs().max()))
                if not same_bits(out, ref):
                    wrong.append(f"{name} {str(dtype)[6:]} ({size}, {rows}, "
                                 f"{cols}) call {k}")
    return {"wrong": wrong, "err": err,
            "launches": {n: f.launches for n, f in fns.items()},
            "cases": len(cases) * len(PEER_NAMES) * PEER_BACK_TO_BACK}


def peer_times(ring, mesh, ctx, rank, device):
    """Device ms per launch of the cross-process B3, B4a and B4b at the DDP
    buffer (rank 0's profile), each one's event ms on every rank, and on
    rank 0 the twin's and the yardstick's device ms on the world."""
    dtype, rows, cols = PEER_DDP_CASE
    p = mesh.size
    world = peer_world(dtype, p, rows, cols, 0, device)
    mine = torch.tensor(mesh.local_ranks)
    out = {}
    for name in PEER_NAMES:
        fn = getattr(ring, name)
        x = world[:, :rows // p] if name == "ring_allgather" else world
        local = x[mine].contiguous()
        ctx.barrier()
        _, rows_ = same_calls(lambda: fn(local, "data", mesh), rank,
                              PEER_TIME_ITERS, want=("ring_peer_kernel",))
        ctx.barrier()
        ev = event_ms(lambda: fn(local, "data", mesh), iters=PEER_TIME_ITERS)
        row = {"event_ms": ev}
        if rank == 0:
            plain = getattr(ring, name + "_plain")
            row["ms"] = kernel_ms(rows_, "ring_peer_kernel")
            row["plain_ms"] = timed(f"{name} plain on the world",
                                    lambda: plain(x, "data", mesh), iters=5)
            lib = {"ring_allreduce": lambda: x.sum(0).expand(p, -1, -1)
                   .contiguous(),
                   "ring_reduce_scatter": lambda: x.sum(0),
                   "ring_allgather": lambda: x.reshape(1, p * x.shape[1], -1)
                   .expand(p, -1, -1).contiguous()}[name]
            row["library_ms"] = timed(f"{name} yardstick", lib)
            row["per_rank"] = world[0].numel() * world.element_size()
        out[name] = row
    return out


def worker_peer(rank, size, store, device="cuda"):
    """Phase 34 on one of `size` processes: for each of PEER_SIZES below
    `size`, the first processes' own init_multihost (at
    CHIP_SMOKE_PEER_PORT_<P>) with the probe at 2 and the kernels against
    their twins, the others waiting at a barrier of the whole group; then
    the whole group's (CHIP_SMOKE_PEER_PORT_<size>): the kernels, their
    times at the DDP buffer; then DDP_STEPS steps of multihost_ddp_entry
    (a last init_multihost at CHIP_SMOKE_DDP_PORT) with the launch counts
    read around them, and the step's times."""
    import sys

    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.checkpoint import state_digest
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.tpu import init_multihost
    from gloo_tpu_torch.tpu.peer import pingpong

    _share_cores(size)
    t0 = time.perf_counter()

    def note(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", file=sys.stderr,
              flush=True)

    def plane(p):
        return init_multihost(
            rank, p, f"127.0.0.1:{os.environ[f'CHIP_SMOKE_PEER_PORT_{p}']}",
            timeout=60.0, device_hostname="127.0.0.1",
            devices=None if device == "cuda" else [device])

    ctx, mesh = plane(size)
    note("init_multihost")
    out = {"sizes": {}}
    for p in PEER_SIZES:
        if p == size:
            sub_ctx, sub_mesh = ctx, mesh
        elif rank < p:
            sub_ctx, sub_mesh = plane(p)
        else:
            ctx.barrier()
            continue
        part = {"process_of": sub_mesh.process_of}
        if p == 2:
            out["probe"] = [pingpong(sub_ctx, sub_mesh.store, r,
                                     sub_mesh.device) for r in PROBE_ROUNDS]
            note("probe")
        part.update(peer_cases(ring, sub_mesh, p, sub_mesh.device, note))
        out["sizes"][str(p)] = part
        if p != size:
            sub_ctx.close()
            ctx.barrier()
    out["times"] = peer_times(ring, mesh, ctx, rank, mesh.device)
    note("times")
    ctx.close()

    # Phase 34c: the flagship's DDP step at one process per rank.
    step, (replicas, optimizers, batch) = entry_mod.multihost_ddp_entry(
        rank, size, f"127.0.0.1:{os.environ['CHIP_SMOKE_DDP_PORT']}",
        device, device_hostname="127.0.0.1")
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd,
                ring.ring_allreduce, ring.ring_reduce_scatter,
                ring.ring_allgather)
    for c in counters:
        c.launches = 0
    note("multihost_ddp_entry")
    losses = [step(replicas, optimizers, batch)]
    first = digest(p.grad for p in replicas[0].parameters())
    losses += [step(replicas, optimizers, batch)
               for _ in range(DDP_STEPS - 1)]
    torch.cuda.synchronize()
    ddp = {"launches": [c.launches for c in counters],
           "losses": [float(x) for x in losses], "first_grads": first,
           "state": state_digest({"model": replicas[0].state_dict(),
                                  "adam": optimizers[0].state_dict()})}

    def once():
        step(replicas, optimizers, batch)

    step.context.barrier()
    ddp["step_ms"] = event_ms(once, iters=10)
    step.context.barrier()
    ddp["device_ms"], rows = same_calls(once, rank, 5,
                                        want=("ring_peer_kernel",))
    ddp["b3_ms"] = kernel_ms(rows, "ring_peer_kernel")
    ddp["device_rows"] = rows[:8]
    note("DDP steps and times")
    step.context.close()
    out["ddp"] = ddp
    out["wall_s"] = time.perf_counter() - t0
    return out


def peer_phase(card, ddp_losses):
    """Phase 34: worker_peer in PEER_SIZES[-1] processes; the checks; the
    rows of the cross-process kernels for the kernels line."""
    from gloo_tpu_torch.entry import ENTRY_CONFIG

    t_phase = time.perf_counter()
    size = PEER_SIZES[-1]
    env = {f"CHIP_SMOKE_PEER_PORT_{p}": str(_free_port())
           for p in PEER_SIZES}
    env["CHIP_SMOKE_DDP_PORT"] = str(_free_port())
    res = run_workers("34", timeout=PEER_TIMEOUT, size=size, env=env)
    failed = []
    for pr in res[0]["probe"]:
        print(f"probe: {pr['rounds']} round trips between 2 processes on the "
              f"card over IPC-mapped .sys flags in {pr['ms']:.6f} ms (host "
              f"{pr['host_s']:.6f} s): {pr['round_trips_per_s']:.3f} round "
              f"trips/s [{card}]")
    err = dict.fromkeys(PEER_NAMES, 0.0)
    for p in PEER_SIZES:
        parts = [r["sizes"][str(p)] for r in res[:p]]
        wrong = [w for part in parts for w in part["wrong"]]
        for n in PEER_NAMES:
            err[n] = max([err[n]] + [part["err"][n] for part in parts])
        launches = [part["launches"] for part in parts]
        print(f"B3, B4a, B4b across {p} processes (process_of "
              f"{parts[0]['process_of']}, {parts[0]['cases']} calls per "
              f"process, {PEER_BACK_TO_BACK} back to back per case) against "
              f"their twins on the card: "
              f"{'all bitwise equal' if not wrong else 'DIFFER ' + str(wrong[:6])}"
              f"; max |kernel - plain| "
              f"{ {n: max(part['err'][n] for part in parts) for n in PEER_NAMES} }"
              f"; launches per process {launches}")
        if wrong or any(l != dict.fromkeys(
                PEER_NAMES, parts[0]["cases"] // len(PEER_NAMES))
                for l in launches):
            failed.append(f"the kernels across {p} processes")
    times = res[0]["times"]
    for name in PEER_NAMES:
        t = times[name]
        print(f"  {name} across {size} processes at the DDP buffer: device "
              f"{t['ms']} ms per launch (rank 0's profile), per call "
              f"(events) {[r['times'][name]['event_ms'] for r in res]} ms, "
              f"plain {t['plain_ms']} ms, yardstick {t['library_ms']} ms "
              f"[{card}; one card, time-sliced]")
    ddps = [r["ddp"] for r in res]
    launches = [d["launches"] for d in ddps]
    layers = ENTRY_CONFIG.n_layers
    want = [DDP_STEPS * layers, DDP_STEPS * layers, DDP_STEPS, 0, 0]
    diffs = [max(abs(a - b) for a, b in zip(d["losses"], ddp_losses))
             for d in ddps]
    rel = max(abs(a - b) / abs(b) for d in ddps
              for a, b in zip(d["losses"], ddp_losses))
    for rank, d in enumerate(ddps):
        print(f"multihost_ddp_entry process {rank}: losses "
              f"{', '.join(f'{x:.6f}' for x in d['losses'])}; launches "
              f"(flash_fwd, flash_bwd, ring_allreduce, ring_reduce_scatter, "
              f"ring_allgather) {d['launches']}; step {d['step_ms']:.6f} ms "
              f"(events) [{card}]")
    print(f"multihost DDP vs phase 10's world step: max |loss - loss_world| "
          f"{max(diffs):.3e} (rel {rel:.3e}, tol {TRAIN_TOL['loss']}); "
          f"first-step grads "
          f"{'bitwise equal' if len({d['first_grads'] for d in ddps}) == 1 else 'DIFFER'}"
          f" across processes; state_digest after {DDP_STEPS} steps "
          f"{'equal' if len({d['state'] for d in ddps}) == 1 else 'DIFFER'}")
    lead = ddps[0]
    busy = "not measured" if lead["device_ms"] is None \
        else f"{lead['device_ms'] / lead['step_ms']:.3f}"
    print(f"multihost DDP step (process 0): {lead['step_ms']:.6f} ms "
          f"(events), device {lead['device_ms']} ms, busy share {busy}, "
          f"the cross-process B3 {lead['b3_ms']} ms of it [{card}; one "
          f"card, time-sliced]")
    for dev_ms, calls, kname in lead["device_rows"]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")
    if any(l != want for l in launches):
        failed.append(f"DDP launches {launches}, expected {want}")
    if rel > TRAIN_TOL["loss"] or len({d["state"] for d in ddps}) != 1 \
            or len({d["first_grads"] for d in ddps}) != 1 \
            or not all(np.isfinite(d["losses"]).all() for d in ddps):
        failed.append("the multihost DDP step")
    print(f"phase 34: {time.perf_counter() - t_phase:.1f} s (workers "
          f"{max(r['wall_s'] for r in res):.1f} s)")
    if failed:
        raise AssertionError(f"phase 34 failed: {failed}")
    rows = {}
    for name in PEER_NAMES:
        t = times[name]
        bound, bound_by = _bound(peer_bound(name, size, t["per_rank"]), 0,
                                 torch.float32)
        n = lead["launches"][2] if name == "ring_allreduce" \
            else res[0]["sizes"][str(size)]["launches"][name]
        rows[name] = (n, err[name], (t["ms"], t["plain_ms"], t["library_ms"],
                                     bound, bound_by))
    return rows


# ---- phase 35: tensor and expert parallelism across processes ----
# 4 worker processes on the card, one rank each, as phase 34. (a) B8
# across 2, 3 and 4 processes (the first P joined by init_multihost at
# CHIP_SMOKE_TP_PORT_<P>, the rest waiting at a barrier of the whole
# group) against its twin, bitwise, at A2A_PEER_CASES; (b) B5a and B5b
# across 2 and 4 processes at OV_PEER_CASES, bitwise against the one-card
# kernel on the same world (launched in each process) and within
# overlap_close of the twin; each case PEER_BACK_TO_BACK calls back to
# back on inputs that differ; (c) multihost_fused_mlp_entry's forward and
# backward, (d) DP_TP_STEPS multihost_dp_tp_entry steps, (e)
# multihost_ep_entry's step, each over the 4 processes against its world
# run in one process; (f) the cross-process kernels' times at the paths'
# shapes and the dp x tp step's.
TP_PEER_SIZES = (2, 3, 4)
OV_PEER_SIZES = (2, 4)
# (label, each rank's value, split, concat): the MoE exchange's leading
# axis, and Ulysses' strided blocks (split 1, concat 2); 12 divides by 2,
# 3 and 4.
A2A_PEER_CASES = (("rows", (12, 64 * 64), 0, 0),
                  ("strided", (2, 12, 64, 64), 1, 2))
A2A_PEER_DTYPES = (torch.bfloat16, torch.float32)
# (label, rows per chunk, k, cols): the fused MLP's shapes, and ragged
# rows, depth and columns.
OV_PEER_CASES = (("mlp", 256, 256, 256), ("ragged", 100, 72, 40))
OV_PEER_DTYPES = (torch.bfloat16, torch.float16)
TP_PEER_TIMEOUT = 300
TP_PEER_PORTS = ("2", "3", "4", "mlp", "dp_tp", "ep")
OV_PEER_NAMES = ("matmul_reduce_scatter", "allgather_matmul")


def a2a_peer_cases(ring, mesh, size):
    """B8 on the process mesh against its twin on the world:
    {"wrong": [...], "err": max |kernel - twin|, "launches", "cases"}."""
    mine = torch.tensor(mesh.local_ranks)
    ring.alltoall.launches = 0
    wrong, err, calls = [], 0.0, 0
    for label, shape, split, concat in A2A_PEER_CASES:
        for dtype in A2A_PEER_DTYPES:
            worlds = [peer_tensor(dtype, (size, *shape), k, mesh.device)
                      for k in range(PEER_BACK_TO_BACK)]
            outs = [ring.alltoall(w[mine], "data", mesh, split, concat)
                    for w in worlds]
            torch.cuda.synchronize()
            for k, (w, out) in enumerate(zip(worlds, outs)):
                ref = ring.alltoall_plain(w, "data", mesh, split,
                                          concat)[mine]
                err = max(err, float((out.float() - ref.float()).abs()
                                     .max()))
                if not same_bits(out, ref):
                    wrong.append(f"B8 {label} {str(dtype)[6:]} P {size} "
                                 f"call {k}")
            calls += len(worlds)
    return {"wrong": wrong, "err": err, "launches": ring.alltoall.launches,
            "cases": calls}


def ov_peer_cases(ov, make_mesh, mesh, size):
    """B5a and B5b on the process mesh against the one-card kernel on the
    same world (a world of `size` ranks on this process's card, launched
    first) and against the twin: {"wrong": [...], "far": [...], "err":
    {name: max |kernel - twin|}, "launches", "cases"}."""
    mine = torch.tensor(mesh.local_ranks)
    world = make_mesh({"data": size}, devices=[mesh.device] * size)
    wrong, far = [], []
    err = dict.fromkeys(OV_PEER_NAMES, 0.0)
    launches = dict.fromkeys(OV_PEER_NAMES, 0)
    calls = 0
    for label, rows, k, cols in OV_PEER_CASES:
        for dtype in OV_PEER_DTYPES:
            xs = [peer_tensor(dtype, (size, size * rows, k), j, mesh.device)
                  for j in range(PEER_BACK_TO_BACK)]
            w = (peer_tensor(torch.float32, (size, k, cols), 0, mesh.device,
                             seed=36) / math.sqrt(k)).to(dtype)
            with torch.no_grad():
                refs = {"matmul_reduce_scatter": [
                    ov.matmul_reduce_scatter(x, w, "data", world)
                    for x in xs],
                    "allgather_matmul": [
                    ov.allgather_matmul_fwd(x[:, :rows].contiguous(), w,
                                            "data", world) for x in xs]}
                torch.cuda.synchronize()
                for name in OV_PEER_NAMES:
                    fn = getattr(ov, name)
                    before = fn.launches
                    if name == "matmul_reduce_scatter":
                        outs = [ov.matmul_reduce_scatter(
                            x[mine], w[mine], "data", mesh) for x in xs]
                    else:
                        outs = [ov.allgather_matmul_fwd(
                            x[mine, :rows].contiguous(), w[mine], "data",
                            mesh) for x in xs]
                    torch.cuda.synchronize()
                    launches[name] += fn.launches - before
                    for j, (x, out, ref) in enumerate(zip(xs, outs,
                                                          refs[name])):
                        tag = f"{name} {label} {str(dtype)[6:]} P {size} " \
                              f"call {j}"
                        if name == "matmul_reduce_scatter":
                            twin = ov.matmul_reduce_scatter_plain(
                                x, w, "data", world)[mine]
                            same = same_bits(out, ref[mine])
                        else:
                            twin = ov.allgather_matmul_plain(
                                x[:, :rows].contiguous(), w, "data",
                                world)[0][mine]
                            same = same_bits(out[0], ref[0][mine]) and \
                                same_bits(out[1], ref[1][mine])
                            out = out[0]
                        e, close = overlap_close(out, twin)
                        err[name] = max(err[name], e)
                        if not same:
                            wrong.append(tag)
                        if not close:
                            far.append(tag)
                    calls += len(xs)
    return {"wrong": wrong, "far": far, "err": err, "launches": launches,
            "cases": calls}


def tp_peer_time(rank, label, fn, name, ctx):
    """(device ms per launch of kernel `name` in rank 0's profile, event ms
    per call on this rank) of the collective call fn."""
    ctx.barrier()
    _, rows = same_calls(fn, rank, PEER_TIME_ITERS, want=(name,))
    ctx.barrier()
    ev = event_ms(fn, iters=PEER_TIME_ITERS)
    return {"ms": kernel_ms(rows, name) if rank == 0 else None,
            "event_ms": ev, "label": label}


def worker_tp_peer(rank, size, store, device="cuda"):
    """Phase 35 on one of `size` processes (see the comment above
    TP_PEER_SIZES): the kernels against their references at each size, the
    three multihost entries, and the times. Returns a JSON-able dict of
    checks, digests and times for tp_peer_phase."""
    import sys

    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.checkpoint import state_digest
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import overlap as ov
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.parallel.dp_tp import SHARDED
    from gloo_tpu_torch.tpu import init_multihost, make_mesh

    _share_cores(size)
    t0 = time.perf_counter()

    def note(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", file=sys.stderr,
              flush=True)

    def address(key):
        return f"127.0.0.1:{os.environ[f'CHIP_SMOKE_TP_PORT_{key}']}"

    def plane(p):
        return init_multihost(
            rank, p, address(str(p)), timeout=60.0,
            device_hostname="127.0.0.1",
            devices=None if device == "cuda" else [device])

    ctx, mesh = plane(size)
    note("init_multihost")
    out = {"sizes": {}}
    for p in sorted(set(TP_PEER_SIZES) | set(OV_PEER_SIZES)):
        if p == size:
            sub_ctx, sub_mesh = ctx, mesh
        elif rank < p:
            sub_ctx, sub_mesh = plane(p)
        else:
            ctx.barrier()
            continue
        part = {"process_of": sub_mesh.process_of}
        if p in TP_PEER_SIZES:
            part["a2a"] = a2a_peer_cases(ring, sub_mesh, p)
            note(f"B8 across {p}")
        if p in OV_PEER_SIZES:
            part["ov"] = ov_peer_cases(ov, make_mesh, sub_mesh, p)
            note(f"B5a, B5b across {p}")
        out["sizes"][str(p)] = part
        if p != size:
            sub_ctx.close()
            ctx.barrier()
    ctx.close()
    mine_digest = {}

    # (c) The fused MLP, forward and backward.
    counters = (ov.allgather_matmul, ov.matmul_reduce_scatter,
                ring.ring_allgather, ring.ring_reduce_scatter,
                ring.ring_allreduce)
    step, args = entry_mod.multihost_fused_mlp_entry(
        rank, size, address("mlp"), device, device_hostname="127.0.0.1")
    for c in counters:
        c.launches = 0
    y, grads = step(*args)
    torch.cuda.synchronize()
    mlp = {"launches": [c.launches for c in counters],
           "digests": [digest([t]) for t in (y, *grads)],
           "finite": bool(all(torch.isfinite(t.float()).all()
                              for t in (y, *grads)))}
    x, w_up, w_down, dy, mlp_mesh = args
    hidden = F.gelu(ov.allgather_matmul(x, w_up, "model", mlp_mesh),
                    approximate="tanh")
    times = {
        "allgather_matmul": tp_peer_time(
            rank, "B5b x (1, 256, 256) @ w_up shard (1, 256, 256)",
            lambda: ov.allgather_matmul_fwd(x, w_up, "model", mlp_mesh),
            "ag_matmul_peer_kernel", step.context),
        "matmul_reduce_scatter": tp_peer_time(
            rank, "B5a hidden (1, 1024, 256) @ w_down shard (1, 256, 256)",
            lambda: ov.matmul_reduce_scatter(hidden, w_down, "model",
                                             mlp_mesh),
            "matmul_rs_peer_kernel", step.context)}
    mlp["step_ms"] = event_ms(lambda: step(*args), iters=5)
    note("fused MLP")
    step.context.close()

    # (d) The dp x tp step.
    step, (model, opt, tokens, targets) = entry_mod.multihost_dp_tp_entry(
        rank, size, address("dp_tp"), device, device_hostname="127.0.0.1")
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd,
                ring.ring_allreduce)
    for c in counters:
        c.launches = 0
    losses = [float(step(model, opt, tokens, targets))
              for _ in range(DP_TP_STEPS)]
    torch.cuda.synchronize()
    named = dict(model.named_parameters())
    dp_tp = {"launches": [c.launches for c in counters], "losses": losses,
             "model_index": step.mesh.ring_index("model")[rank],
             "replicated": state_digest({n: p for n, p in named.items()
                                         if n.split(".")[-1] not in SHARDED}),
             "shards": state_digest({n: p for n, p in named.items()
                                     if n.split(".")[-1] in SHARDED})}

    def once():
        step(model, opt, tokens, targets)

    step.context.barrier()
    dp_tp["step_ms"] = event_ms(once, iters=5)
    step.context.barrier()
    dp_tp["device_ms"], rows = same_calls(once, rank, 5,
                                          want=("ring_peer_kernel",))
    dp_tp["b3_ms"] = kernel_ms(rows, "ring_peer_kernel")
    dp_tp["device_rows"] = rows[:8]
    note("dp x tp")
    step.context.close()

    # (e) The MoE path.
    step, args = entry_mod.multihost_ep_entry(
        rank, size, address("ep"), device, device_hostname="127.0.0.1")
    ring.alltoall.launches = 0
    out_ep, grads = step(*args)
    torch.cuda.synchronize()
    ep = {"launches": ring.alltoall.launches,
          "digests": [digest([t]) for t in (out_ep, *grads)]}
    tokens = args[0]
    n_exp = args[-1].shape["expert"]
    send = tokens.new_empty((1, n_exp, entry_mod.EP_CAPACITY,
                             tokens.shape[-1])).copy_(
        tokens[:, :n_exp * entry_mod.EP_CAPACITY].view(
            1, n_exp, entry_mod.EP_CAPACITY, -1))
    times["alltoall"] = tp_peer_time(
        rank, "B8 at the MoE dispatch (1, 4, 64, 256) bf16",
        lambda: ring.alltoall(send, "expert", args[-1]),
        "alltoall_peer_kernel", step.context)
    ep["step_ms"] = event_ms(lambda: step(*args), iters=5)
    note("MoE")
    step.context.close()
    out.update(mlp=mlp, dp_tp=dp_tp, ep=ep, times=times,
               wall_s=time.perf_counter() - t0)
    return out


def tp_peer_reference(ov, ring, entry_mod):
    """The world runs of phase 35's paths in this process on the card:
    per flat rank, the digests of the fused MLP's (y, dx, dw_up, dw_down)
    and of the MoE path's (out, d tokens, d w_up, d w_down); and the
    twins' and yardsticks' times and the bounds of the cross-process
    kernels at the paths' shapes (the world's work)."""
    fn, (x, w_up, w_down, dy, mesh) = entry_mod.fused_mlp_entry()
    y, grads = fn(x, w_up, w_down, dy, mesh)
    mlp = [[digest([t[[r]]]) for t in (y, *grads)]
           for r in range(mesh.size)]
    efn, eargs = entry_mod.ep_entry()
    out, egrads = efn(*eargs)
    ep = [[digest([t[[r]]]) for t in (out, *egrads)]
          for r in range(eargs[-1].size)]
    torch.cuda.synchronize()
    n, elt = mesh.size, x.element_size()
    hidden = F.gelu(ov.allgather_matmul(x, w_up, "model", mesh),
                    approximate="tanh")
    gathered = x.reshape(1, -1, x.shape[2]).expand(n, -1, -1)
    tokens = eargs[0]
    cap = entry_mod.EP_CAPACITY
    send = tokens[:, :n * cap].reshape(n, n, cap, -1).contiguous()
    rows = {}
    with torch.no_grad():
        for name, plain, lib_label, lib, nbytes, flops in (
                ("allgather_matmul",
                 lambda: ov.allgather_matmul_plain(x, w_up, "model", mesh),
                 "torch.matmul(expanded gathered x, w)",
                 lambda: torch.matmul(gathered, w_up),
                 elt * (x.numel() + w_up.numel() + n * x.numel()
                        + n * x.shape[0] * x.shape[1] * w_up.shape[2]),
                 2 * n * n * x.shape[1] * x.shape[2] * w_up.shape[2]),
                ("matmul_reduce_scatter",
                 lambda: ov.matmul_reduce_scatter_plain(hidden, w_down,
                                                        "model", mesh),
                 "torch.matmul(h, w).sum(0)",
                 lambda: torch.matmul(hidden, w_down).sum(0),
                 elt * (hidden.numel() + w_down.numel()
                        + hidden.numel() // n * w_down.shape[2]
                        // hidden.shape[2]),
                 2 * hidden.numel() * w_down.shape[2]),
                ("alltoall",
                 lambda: ring.alltoall_plain(send, "expert", eargs[-1]),
                 "send.view(n, n, c).transpose(0, 1).contiguous()",
                 lambda: send.view(n, n, -1).transpose(0, 1).contiguous(),
                 2 * send.numel() * send.element_size(), 0)):
            plain_ms = timed(f"{name} plain on the world", plain, iters=5)
            lib_ms = timed(f"{name} yardstick {lib_label}", lib)
            bound, bound_by = _bound(nbytes, flops, x.dtype)
            rows[name] = (plain_ms, lib_ms, bound, bound_by)
    return mlp, ep, rows


def tp_peer_phase(card, ov, ring, entry_mod, tp_losses):
    """Phase 35: worker_tp_peer in TP_PEER_SIZES[-1] processes; the checks
    against the world runs (this process) and phase 14's dp x tp losses;
    the rows of the cross-process B5a, B5b and B8 for the kernels line."""
    from gloo_tpu_torch.entry import ENTRY_CONFIG

    t_phase = time.perf_counter()
    size = TP_PEER_SIZES[-1]
    env = {f"CHIP_SMOKE_TP_PORT_{key}": str(_free_port())
           for key in TP_PEER_PORTS}
    res = run_workers("35", timeout=TP_PEER_TIMEOUT, size=size, env=env)
    t_workers = time.perf_counter() - t_phase
    print(f"world runs of the fused MLP and the MoE path in one process, "
          f"and the twins' and yardsticks' times [{card}]:")
    mlp_ref, ep_ref, ref_rows = tp_peer_reference(ov, ring, entry_mod)
    failed = []
    a2a_err = 0.0
    ov_err = dict.fromkeys(OV_PEER_NAMES, 0.0)
    for p in sorted(set(TP_PEER_SIZES) | set(OV_PEER_SIZES)):
        parts = [r["sizes"][str(p)] for r in res[:p]]
        if p in TP_PEER_SIZES:
            a2a = [part["a2a"] for part in parts]
            wrong = [w for a in a2a for w in a["wrong"]]
            a2a_err = max([a2a_err] + [a["err"] for a in a2a])
            print(f"B8 across {p} processes (process_of "
                  f"{parts[0]['process_of']}, {a2a[0]['cases']} calls per "
                  f"process, {PEER_BACK_TO_BACK} back to back per case: "
                  f"rows and strided, bf16 and f32) against its twin: "
                  f"{'all bitwise equal' if not wrong else 'DIFFER ' + str(wrong[:6])}"
                  f"; max |kernel - twin| {max(a['err'] for a in a2a)}; "
                  f"launches per process {[a['launches'] for a in a2a]}")
            if wrong or any(a["launches"] != a["cases"] for a in a2a):
                failed.append(f"B8 across {p} processes")
        if p in OV_PEER_SIZES:
            ovs = [part["ov"] for part in parts]
            wrong = [w for o in ovs for w in o["wrong"]]
            far = [w for o in ovs for w in o["far"]]
            for name in OV_PEER_NAMES:
                ov_err[name] = max([ov_err[name]]
                                   + [o["err"][name] for o in ovs])
            print(f"B5a, B5b across {p} processes ({ovs[0]['cases']} calls "
                  f"per process: {', '.join(c[0] for c in OV_PEER_CASES)} "
                  f"in bf16 and f16, {PEER_BACK_TO_BACK} back to back) "
                  f"against the one-card kernel on the same world: "
                  f"{'all bitwise equal' if not wrong else 'DIFFER ' + str(wrong[:6])}"
                  f"; against the twin {'all within overlap_close' if not far else 'FAR ' + str(far[:6])}"
                  f" (max |kernel - twin| "
                  f"{ {n: max(o['err'][n] for o in ovs) for n in OV_PEER_NAMES} }"
                  f"); launches per process {[o['launches'] for o in ovs]}")
            want = dict.fromkeys(OV_PEER_NAMES, ovs[0]["cases"] // 2)
            if wrong or far or any(o["launches"] != want for o in ovs):
                failed.append(f"B5a, B5b across {p} processes")

    # (c) The fused MLP.
    mlps = [r["mlp"] for r in res]
    mlp_same = all(m["digests"] == mlp_ref[rank]
                   for rank, m in enumerate(mlps))
    print(f"fused MLP over {size} processes (1024 token rows, d_model 256, "
          f"d_ff 1024 over 4, bf16), forward + backward: y, dx, dw_up, "
          f"dw_down against the world run in one process "
          f"{'bitwise equal' if mlp_same else 'DIFFER'}; launches "
          f"(allgather_matmul, matmul_reduce_scatter, ring_allgather, "
          f"ring_reduce_scatter, ring_allreduce) per process "
          f"{[m['launches'] for m in mlps]}; step "
          f"{[round(m['step_ms'], 6) for m in mlps]} ms (events) [{card}; "
          f"one card, time-sliced]")
    if not mlp_same or not all(m["finite"] for m in mlps) or any(
            m["launches"] != [1, 2, 1, 0, 0] for m in mlps):
        failed.append("the fused MLP across processes")

    # (d) The dp x tp step.
    dps = [r["dp_tp"] for r in res]
    layers = ENTRY_CONFIG.n_layers
    want = [DP_TP_STEPS * layers, DP_TP_STEPS * layers,
            DP_TP_STEPS * (4 * layers + 2)]
    diff = max(abs(a - b) for d in dps for a, b in zip(d["losses"],
                                                        tp_losses))
    rel = max(abs(a - b) / abs(b) for d in dps
              for a, b in zip(d["losses"], tp_losses))
    replicated = len({d["replicated"] for d in dps}) == 1
    by_model = {}
    for d in dps:
        by_model.setdefault(d["model_index"], set()).add(d["shards"])
    shards = all(len(v) == 1 for v in by_model.values())
    for rank, d in enumerate(dps):
        print(f"multihost_dp_tp_entry process {rank}: losses "
              f"{', '.join(f'{x:.6f}' for x in d['losses'])}; launches "
              f"(flash_fwd, flash_bwd, ring_allreduce) {d['launches']}; "
              f"step {d['step_ms']:.6f} ms (events) [{card}]")
    print(f"multihost dp x tp vs phase 14's world step: max |loss - "
          f"loss_world| {diff:.3e} (rel {rel:.3e}, tol {TRAIN_TOL['loss']}; "
          f"{'bitwise' if diff == 0 else 'not bitwise'}); after "
          f"{DP_TP_STEPS} steps replicated parameters "
          f"{'bitwise equal' if replicated else 'DIFFER'} across the "
          f"{size} processes, shards {'bitwise equal' if shards else 'DIFFER'}"
          f" across data ranks (state_digest)")
    lead = dps[0]
    busy = "not measured" if lead["device_ms"] is None \
        else f"{lead['device_ms'] / lead['step_ms']:.3f}"
    print(f"multihost dp x tp step (process 0): {lead['step_ms']:.6f} ms "
          f"(events), device {lead['device_ms']} ms, busy share {busy}, the "
          f"cross-process B3 {lead['b3_ms']} ms of it [{card}; one card, "
          f"time-sliced]")
    for dev_ms, calls, kname in lead["device_rows"]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")
    if any(d["launches"] != want for d in dps):
        failed.append(f"dp x tp launches {[d['launches'] for d in dps]}, "
                      f"expected {want}")
    if rel > TRAIN_TOL["loss"] or not replicated or not shards \
            or not all(np.isfinite(d["losses"]).all() for d in dps):
        failed.append("the multihost dp x tp step")

    # (e) The MoE path.
    eps = [r["ep"] for r in res]
    ep_same = all(e["digests"] == ep_ref[rank] for rank, e in enumerate(eps))
    print(f"MoE path over {size} processes: out and the gradients (tokens, "
          f"w_up, w_down) against the world run in one process "
          f"{'bitwise equal' if ep_same else 'DIFFER'}; B8 launches per "
          f"process {[e['launches'] for e in eps]}; step "
          f"{[round(e['step_ms'], 6) for e in eps]} ms (events) [{card}; "
          f"one card, time-sliced]")
    if not ep_same or any(e["launches"] != 4 for e in eps):
        failed.append("the MoE path across processes")

    # (f) Times.
    rows = {}
    for name in ("matmul_reduce_scatter", "allgather_matmul", "alltoall"):
        t = res[0]["times"][name]
        plain_ms, lib_ms, bound, bound_by = ref_rows[name]
        print(f"  {name} across {size} processes, {t['label']}: device "
              f"{t['ms']} ms per launch (rank 0's profile), per call "
              f"(events) {[round(r['times'][name]['event_ms'], 6) for r in res]}"
              f" ms; the world's twin {plain_ms} ms, yardstick {lib_ms} ms, "
              f"bound {bound:.6f} ms ({bound_by}) [{card}; one card, "
              f"time-sliced]")
        n = {"matmul_reduce_scatter": mlps[0]["launches"][1],
             "allgather_matmul": mlps[0]["launches"][0],
             "alltoall": eps[0]["launches"]}[name]
        err = a2a_err if name == "alltoall" else ov_err[name]
        rows[name] = (n, err, (t["ms"], plain_ms, lib_ms, bound, bound_by))
    print(f"phase 35: {time.perf_counter() - t_phase:.1f} s (workers "
          f"{t_workers:.1f} s, each {max(r['wall_s'] for r in res):.1f} s)")
    if failed:
        raise AssertionError(f"phase 35 failed: {failed}")
    return rows


# ---- phase 36: the ring variants, spmd's point-to-point collectives, and
# sequence and pipeline parallelism across processes ----
# 4 worker processes on the card, one rank each, as phases 34-35. (a) B9,
# B10 and B11 across 2, 3 and 4 processes (the first P joined by
# init_multihost at CHIP_SMOKE_SPP_PORT_<P>, the rest waiting at a
# barrier of the whole group) at VAR_PEER_CASES, bitwise against the
# one-card kernel on the same world (launched in each process) and
# against the twin, PEER_BACK_TO_BACK calls back to back on inputs that
# differ, B10 at 4 processes also past its register form's reach; (b)
# the transport
# (ppermute, shift +-1 with and without wrap, broadcast, scatter) and
# max/min/product and barrier at the same sizes, bitwise against the
# world's spmd, and CudaProcessGroup's broadcast, send_recv and barrier;
# (c) multihost_ring_variants_entry's three steps, (d)
# multihost_sp_entry's three paths, (e) SPP_STEPS multihost_pp_entry
# 1F1B steps and a GPipe forward, each over the 4 processes against its
# world run in one process (written by the main process to
# CHIP_SMOKE_SPP_REF); (f) the kernels' and the transport's times.
SPP_PEER_SIZES = (2, 3, 4)
# (label, rows per rank, cols) by variant: the ring-variant path's
# buffer, and ragged rows and columns (B9's columns padded to whole
# 16-byte units; B11 needs cols % 256, B10 rows / n % 32); 6912, 60 and
# 384 divide by 2, 3 and 4 (and 6912 and 384 by 32 n).
VAR_PEER_CASES = {"hbm": (("buffer", 6912, 256), ("ragged", 60, 99)),
                  "q8": (("buffer", 6912, 256), ("ragged", 384, 100)),
                  "bidir": (("buffer", 6912, 256), ("ragged", 60, 512))}
VAR_PEER_DTYPES = {"hbm": (torch.float32, torch.bfloat16),
                   "q8": (torch.float32,),
                   "bidir": (torch.float32, torch.bfloat16)}
VAR_PEER_KERNELS = {"hbm": "hbm_peer_kernel", "q8": "q8_peer_kernel",
                    "bidir": "bidir_peer_kernel"}
# Each rank's value of the transport's cases (scatter splits the 12 rows
# over the ring), its dtypes and rounds on inputs that differ.
PERM_PEER_SHAPE = (3, 12, 40)
PERM_PEER_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
PERM_PEER_ROUNDS = 2
SPP_STEPS = 3
# The paths whose kernels and products give the world's bits on any rows
# (B1, B6 and cuBLAS's products are deterministic per row); the others are
# held within their tolerance: B2's and B7's dQ are summed by TMA
# reduce-add in the order the blocks finish, which the grid and the
# scheduler set, so the world run does not repeat its own bits either
# (spp_peer_reference prints whether it does).
SPP_BITWISE = ("ring_attention", "gpipe")
# The workers took 47.9-52.7 s each (61.8-66.5 s from the first start to
# the last exit) on an H100 with 4 processes time-slicing it.
SPP_PEER_TIMEOUT = 300
SPP_PEER_PORTS = ("2", "3", "4", "variants", "sp", "pp")


def var_peer_cases(ring, make_mesh, mesh, size, note=print):
    """B9, B10 and B11 on the process mesh against the one-card kernel on
    the same world (bitwise) and against the twin (equal values):
    {"wrong", "err", "launches", "cases", "past_cap_rows"}."""
    mine = torch.tensor(mesh.local_ranks)
    world = make_mesh({"data": size}, devices=[mesh.device] * size)
    # B10's out-of-register form: a chunk past what the agreed slices of
    # the register form hold, at 256 columns.
    reach = ring._variant_peer_slices(ring._Q8, ring._variants_lib(), mesh,
                                      1 << 30)
    past = (reach * ring.KERNEL_THREADS * ring.Q8_REGISTER_UNITS * 4 // 256
            + 32) * size
    wrong, calls = [], 0
    err = dict.fromkeys(VAR_PEER_CASES, 0.0)
    launches = dict.fromkeys(VAR_PEER_CASES, 0)
    for name, cases in VAR_PEER_CASES.items():
        fn = getattr(ring, f"ring_allreduce_{name}")
        plain = getattr(ring, f"ring_allreduce_{name}_plain")
        if name == "q8" and size == SPP_PEER_SIZES[-1]:
            cases = cases + (("past_cap", past, 256),)
        for label, rows, cols in cases:
            for dtype in VAR_PEER_DTYPES[name]:
                xs = [peer_tensor(dtype, (size, rows, cols), k, mesh.device,
                                  seed=37) for k in range(PEER_BACK_TO_BACK)]
                with torch.no_grad():
                    before = fn.launches
                    outs = [fn(x[mine], "data", mesh) for x in xs]
                    torch.cuda.synchronize()
                    launches[name] += fn.launches - before
                    for k, (x, out) in enumerate(zip(xs, outs)):
                        ref = fn(x, "data", world)[mine]
                        twin = plain(x, "data", world)[mine]
                        err[name] = max(err[name], float(
                            (out.float() - twin.float()).abs().max()))
                        # Bitwise the one-card kernel; the twin's values
                        # (B10's twin keeps the sign of a code rounded to
                        # zero, -0.0, where the kernels decode +0.0).
                        if not (same_bits(out, ref)
                                and torch.equal(out, twin)):
                            wrong.append(f"{name} {label} {str(dtype)[6:]} "
                                         f"P {size} call {k}")
                calls += len(xs)
                note(f"{name} {label} {str(dtype)[6:]} ({size}, {rows}, "
                     f"{cols})")
    return {"wrong": wrong, "err": err, "launches": launches,
            "cases": calls, "past_cap_rows": past}


def perm_peer_ops(spmd, size):
    """The transport's cases by name: fn(x, mesh) along "data"."""
    return {
        "ppermute": lambda x, m: spmd.ppermute(x, "data", [(0, 1), (1, 0)],
                                               mesh=m),
        "shift+1": lambda x, m: spmd.shift(x, "data", 1, mesh=m),
        "shift-1": lambda x, m: spmd.shift(x, "data", -1, mesh=m),
        "shift+1 no wrap": lambda x, m: spmd.shift(x, "data", 1, wrap=False,
                                                   mesh=m),
        "shift-1 no wrap": lambda x, m: spmd.shift(x, "data", -1,
                                                   wrap=False, mesh=m),
        "broadcast": lambda x, m: spmd.broadcast(x, "data", size - 1,
                                                 mesh=m),
        "scatter": lambda x, m: spmd.scatter(x, "data", 1, scatter_axis=1,
                                             mesh=m),
        "max": lambda x, m: spmd.allreduce(x, "data", "max", mesh=m),
        "min": lambda x, m: spmd.allreduce(x, "data", "min", mesh=m),
        "product": lambda x, m: spmd.allreduce(x, "data", "product", mesh=m),
    }


def perm_peer_cases(spmd, permute, ring, CudaProcessGroup, make_mesh, mesh,
                    size):
    """The transport, max/min/product and barrier on the process mesh, and
    CudaProcessGroup's broadcast, send_recv and barrier, against the
    world's spmd on the card: {"wrong", "err" (max |got - world|),
    "launches" (pull, B4b, B3), "want", "cases"}."""
    mine = torch.tensor(mesh.local_ranks)
    world = make_mesh({"data": size}, devices=[mesh.device] * size)
    ops = perm_peer_ops(spmd, size)
    group, world_group = CudaProcessGroup(mesh), CudaProcessGroup(world)
    counters = (permute.pull, ring.ring_allgather, ring.ring_allreduce)
    launches = [0] * len(counters)

    def counted(fn):
        """fn() with its launches added to `launches` (the world's
        references launch too, on the one-card kernels)."""
        before = [c.launches for c in counters]
        result = fn()
        for i, (c, b) in enumerate(zip(counters, before)):
            launches[i] += c.launches - b
        return result

    wrong, calls, err = [], 0, 0.0
    for dtype in PERM_PEER_DTYPES:
        for k in range(PERM_PEER_ROUNDS):
            shape = (size, *PERM_PEER_SHAPE)
            if dtype == torch.int32:
                gen = torch.Generator(mesh.device).manual_seed(38 + k)
                x = torch.randint(-9, 10, shape, generator=gen,
                                  device=mesh.device, dtype=torch.int32)
            else:
                x = peer_tensor(dtype, shape, k, mesh.device, seed=38)
            got = counted(lambda: {name: op(x[mine], mesh)
                                   for name, op in ops.items()})
            got["group broadcast"] = counted(
                lambda: group.broadcast(x[mine], root=1))
            got["group send_recv"] = counted(
                lambda: group.send_recv(x[mine], [(0, 1), (1, 0)]))
            torch.cuda.synchronize()
            for name, out in got.items():
                if name.startswith("group"):
                    ref = (world_group.broadcast(x, root=1)
                           if name == "group broadcast"
                           else world_group.send_recv(x, [(0, 1), (1, 0)]))
                else:
                    ref = ops[name](x, world)
                err = max(err, abs_err(out, ref[mine]))
                if not same_bits(out, ref[mine]):
                    wrong.append(f"{name} {str(dtype)[6:]} P {size} "
                                 f"round {k}")
            calls += len(got)
    for k in range(PERM_PEER_ROUNDS):
        out = counted(lambda: spmd.barrier("data", mesh=mesh))
        counted(group.barrier)
        if not same_bits(out, spmd.barrier("data", mesh=world)[mine]):
            wrong.append(f"barrier P {size} round {k}")
    torch.cuda.synchronize()
    rounds = len(PERM_PEER_DTYPES) * PERM_PEER_ROUNDS
    # Pulls: the seven point-to-point cases and the group's two; B4b:
    # max, min, product; B3: the two barriers.
    want = [9 * rounds, 3 * rounds, 2 * PERM_PEER_ROUNDS]
    return {"wrong": wrong, "err": err, "launches": launches, "want": want,
            "cases": calls + PERM_PEER_ROUNDS}


def abs_err(a, b):
    """max |a - b| in f64, 0 for empty tensors, inf where the shapes
    differ."""
    if a.shape != b.shape:
        return math.inf
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def shift_peer_cases(spmd, make_mesh, k, axis, mesh, size, carrier):
    """spmd.shift at the ring-flash path's own shapes, a K/V block like k
    and an f32 dK/dV carrier of shape `carrier` per process (the
    multi-slice launches that path makes), by +1 and -1 with wrap and +1
    without, against the world's spmd.shift on the same inputs:
    {"wrong", "err" (max |shift - world|), "cases"}."""
    mine = torch.tensor(mesh.local_ranks)
    world = make_mesh({axis: size}, devices=[mesh.device] * size)
    wrong, err, cases = [], 0.0, 0
    for j, (dtype, shape) in enumerate(((k.dtype, tuple(k.shape[1:])),
                                        (torch.float32, carrier[1:]))):
        x = peer_tensor(dtype, (size, *shape), j, mesh.device, seed=39)
        for offset, wrap in ((1, True), (-1, True), (1, False)):
            got = spmd.shift(x[mine], axis, offset, wrap, mesh=mesh)
            want = spmd.shift(x, axis, offset, wrap, mesh=world)[mine]
            torch.cuda.synchronize()
            err = max(err, abs_err(got, want))
            if not same_bits(got, want):
                wrong.append(f"shift {offset:+d} wrap {wrap} "
                             f"{str(dtype)[6:]} {shape}")
            cases += 1
    return {"wrong": wrong, "err": err, "cases": cases}


def close_rel(a, b):
    """|a - b| / |b| by norms, 0 where both are exactly zero."""
    if not b.float().norm():
        return 0.0 if not a.float().norm() else math.inf
    return rel_norm(a, b)


def held(got, want, tol):
    """(bitwise, worst relative norm, within tol) of tensors against
    their world rows."""
    same = all(same_bits(g, w) for g, w in zip(got, want))
    worst = max(close_rel(g, w) for g, w in zip(got, want))
    return same, worst, worst <= tol


def worker_spp_peer(rank, size, store, device="cuda"):
    """Phase 36 on one of `size` processes (see the comment above
    SPP_PEER_SIZES): the variants and the transport against their
    references at each size, the three multihost entries against the
    world runs in CHIP_SMOKE_SPP_REF, and the times."""
    import sys

    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import permute, ring
    from gloo_tpu_torch.tpu import (CudaProcessGroup, init_multihost,
                                    make_mesh, spmd)

    _share_cores(size)
    t0 = time.perf_counter()

    def note(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", file=sys.stderr,
              flush=True)

    def address(key):
        return f"127.0.0.1:{os.environ[f'CHIP_SMOKE_SPP_PORT_{key}']}"

    def plane(p):
        return init_multihost(
            rank, p, address(str(p)), timeout=60.0,
            device_hostname="127.0.0.1",
            devices=None if device == "cuda" else [device])

    ref = torch.load(os.environ["CHIP_SMOKE_SPP_REF"],
                     map_location=torch.device(device))
    ctx, mesh = plane(size)
    note("init_multihost")
    out = {"sizes": {}}
    for p in SPP_PEER_SIZES:
        if p == size:
            sub_ctx, sub_mesh = ctx, mesh
        elif rank < p:
            sub_ctx, sub_mesh = plane(p)
        else:
            ctx.barrier()
            continue
        part = {"process_of": sub_mesh.process_of}
        part["var"] = var_peer_cases(ring, make_mesh, sub_mesh, p, note)
        note(f"B9, B10, B11 across {p}")
        part["perm"] = perm_peer_cases(spmd, permute, ring,
                                       CudaProcessGroup, make_mesh,
                                       sub_mesh, p)
        note(f"the transport across {p}")
        out["sizes"][str(p)] = part
        if p != size:
            sub_ctx.close()
            ctx.barrier()
    ctx.close()
    mine = mesh.local_ranks
    times = {}

    # (c) The ring-variant path: forward and VJP, bitwise the world's.
    paths = entry_mod.multihost_ring_variants_entry(
        rank, size, address("variants"), device, device_hostname="127.0.0.1")
    step = paths["hbm"][0]
    variants = {}
    for name, (fn, args) in paths.items():
        counter = args[0]
        counter.launches = 0
        y, g = fn(*args)
        torch.cuda.synchronize()
        variants[name] = {
            "launches": counter.launches,
            "bitwise": same_bits(y, ref["variants"][name][0][mine])
            and same_bits(g, ref["variants"][name][1][mine])}
    # One profile of the three variants' calls (each kernel's device ms
    # per launch by its name), then each one's events per call.
    _, x, vmesh = paths["hbm"][1]
    with torch.no_grad():
        step.context.barrier()
        _, rows = same_calls(
            lambda: [variant(x, "data", vmesh)
                     for _, (variant, _, _) in paths.values()],
            rank, PEER_TIME_ITERS, want=tuple(VAR_PEER_KERNELS.values()))
        for name, (fn, (variant, _, _)) in paths.items():
            step.context.barrier()
            times[name] = {
                "ms": kernel_ms(rows, VAR_PEER_KERNELS[name])
                if rank == 0 else None,
                "event_ms": event_ms(lambda variant=variant:
                                     variant(x, "data", vmesh),
                                     iters=PEER_TIME_ITERS),
                "label": f"ring_allreduce_{name} at the buffer (1, "
                         f"{x.shape[1]}, {x.shape[2]}) f32 per process"}
    for name, (fn, args) in paths.items():
        variants[name]["step_ms"] = event_ms(lambda fn=fn, args=args:
                                             fn(*args), iters=2)
    note("ring-variant path")
    step.context.close()

    # (d) The long-context path.
    paths = entry_mod.multihost_sp_entry(rank, size, address("sp"), device,
                                         device_hostname="127.0.0.1")
    counters = (attn.flash_attention_step, attn.flash_attention_bwd_step,
                attn.prepare_bwd_step, attn.flash_bwd_step_finish,
                ring.alltoall, attn.flash_attention_fwd,
                attn.flash_attention_bwd, permute.pull)
    sp_res = {}
    for name, (fn, args) in paths.items():
        for c in counters:
            c.launches = 0
        res = fn(*args)
        torch.cuda.synchronize()
        got = [res] if name == "ring_attention" else [res[0], *res[1]]
        want = [t[mine] for t in ref["sp"][name]]
        same, worst, ok = held(got, want, SP_TOL)
        sp_res[name] = {"launches": [c.launches for c in counters],
                        "bitwise": same, "rel": worst, "ok": ok,
                        "finite": all(bool(torch.isfinite(t.float()).all())
                                      for t in got)}
    ctx_sp = paths["ring_flash"][0].context
    _, q, k, v, sp_mesh = paths["ring_flash"][1]
    times["permute"] = tp_peer_time(
        rank, f"spmd.shift of a K block {tuple(k.shape)} bf16 per process",
        lambda: spmd.shift(k, "seq", 1, mesh=sp_mesh), "permute_peer_kernel",
        ctx_sp)
    b, h_kv, t_local, d = k.shape[1:]
    out["shift"] = shift_peer_cases(
        spmd, make_mesh, k, "seq", sp_mesh, size,
        (k.shape[0], b * h_kv, t_local, attn.kernel_head_dim(d)))
    for name, (fn, args) in paths.items():
        ctx_sp.barrier()
        sp_res[name]["ms"] = event_ms(lambda fn=fn, args=args: fn(*args),
                                      iters=2)
    note("long-context path")
    ctx_sp.close()

    # (e) The pipeline path.
    paths = entry_mod.multihost_pp_entry(rank, size, address("pp"), device,
                                         device_hostname="127.0.0.1")
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd,
                permute.pull)
    pp_res = {}
    fn, args = paths["gpipe"]
    for c in counters:
        c.launches = 0
    y = fn(*args)
    torch.cuda.synchronize()
    same, worst, ok = held([y], [ref["pp"]["gpipe"][mine]], PP_TOL["out"])
    pp_res["gpipe"] = {"launches": [c.launches for c in counters],
                       "bitwise": same, "rel": worst, "ok": ok}
    fn, args = paths["1f1b"]
    steps = []
    for c in counters:
        c.launches = 0
    for _ in range(SPP_STEPS):
        steps.append(fn(*args))
    torch.cuda.synchronize()
    grads_ref, loss_ref = ref["pp"]["1f1b"]
    names = sorted(grads_ref)
    rels, same_all, repeat = [], True, True
    for grads, loss_sum in steps:
        got = [grads[n] for n in names]
        want = [grads_ref[n][mine] for n in names]
        same, worst, _ = held(got + [loss_sum], want + [loss_ref[mine]],
                              math.inf)
        same_all = same_all and same
        loss_rel = close_rel(loss_sum, loss_ref[mine])
        rels.append((loss_rel, max(close_rel(g, w)
                                   for g, w in zip(got, want))))
        repeat = repeat and all(same_bits(grads[n], steps[0][0][n])
                                for n in names)
    pp_res["1f1b"] = {
        "launches": [c.launches for c in counters], "bitwise": same_all,
        "loss_rel": max(r[0] for r in rels),
        "grad_rel": max(r[1] for r in rels), "repeat": repeat,
        "ok": all(r[0] <= TRAIN_TOL["loss"] and r[1] <= TRAIN_TOL["grad"]
                  for r in rels),
        "finite": all(bool(torch.isfinite(t.float()).all())
                      for grads, loss in steps
                      for t in (loss, *grads.values()))}
    ctx_pp = paths["gpipe"][0].context
    for name, (fn, args) in paths.items():
        ctx_pp.barrier()
        pp_res[name]["ms"] = event_ms(lambda fn=fn, args=args: fn(*args),
                                      iters=1)
    note("pipeline path")
    ctx_pp.close()
    out.update(variants=variants, sp=sp_res, pp=pp_res, times=times,
               wall_s=time.perf_counter() - t0)
    return out


def spp_peer_reference(ring, permute, entry_mod, path):
    """The world runs of phase 36's paths in this process on the card,
    saved to `path` for the workers (the variants' (y, dx), the three SP
    paths' outputs and gradients, GPipe's output and the 1F1B step's
    grads and loss_sum); and the twins', yardsticks' times and bounds of
    the cross-process kernels and the transport at the paths' shapes."""
    ref = {"variants": {}, "sp": {}, "pp": {}}
    vpaths = entry_mod.ring_variants_entry()
    for name, (fn, args) in vpaths.items():
        ref["variants"][name] = fn(*args)
    for name, (fn, args) in entry_mod.sp_entry().items():
        res = fn(*args)
        ref["sp"][name] = [res] if name == "ring_attention" \
            else [res[0], *res[1]]
    ppaths = entry_mod.pp_entry()
    for name, (fn, args) in ppaths.items():
        ref["pp"][name] = fn(*args)
    torch.cuda.synchronize()
    torch.save(ref, path)
    # Whether the world runs repeat their own bits.
    spaths = entry_mod.sp_entry()
    again = {name: spaths[name][0](*spaths[name][1])
             for name in ("ring_flash", "ulysses")}
    again["1f1b"] = ppaths["1f1b"][0](*ppaths["1f1b"][1])
    grads, loss = ref["pp"]["1f1b"]
    repeat = {name: all(same_bits(a, b) for a, b in zip(
        [again[name][0], *again[name][1]], ref["sp"][name]))
        for name in ("ring_flash", "ulysses")}
    repeat["1f1b"] = same_bits(again["1f1b"][1], loss) and all(
        same_bits(again["1f1b"][0][k], grads[k]) for k in grads)
    print(f"  the world runs repeat their own bits: {repeat}")
    rows = {}
    _, x, mesh = vpaths["hbm"][1]
    ranks, per_rank = x.shape[0], x[0].numel() * x.element_size()
    bound, bound_by = _bound(2 * ranks * per_rank,
                             (ranks - 1) * x[0].numel(), torch.float32)
    with torch.no_grad():
        lib = timed("variants' yardstick x.sum(0) then "
                    "expand(P).contiguous()",
                    lambda: x.sum(0).expand(ranks, -1, -1).contiguous(),
                    kinds=2)
        for name in VAR_PEER_CASES:
            plain = getattr(ring, f"ring_allreduce_{name}_plain")
            plain_ms = timed(f"ring_allreduce_{name} plain on the world",
                             lambda plain=plain: plain(x, "data", mesh),
                             iters=3)
            rows[name] = (plain_ms, None if name == "q8" else lib, bound,
                          bound_by)
        _, q, k, v, sp_mesh = entry_mod.sp_entry()["ring_flash"][1]
        n = k.shape[0]
        perm = [(n - 1 + i) % n for i in range(n)]  # ring index k pulls k - 1
        plain_ms = timed("the transport plain (pull_plain) on the world at "
                         "a K block",
                         lambda: permute.pull_plain(k, "seq", sp_mesh, perm,
                                                    [0] * n, k[0].numel()))
        lib_ms = timed("the transport's yardstick torch.roll(k, 1, 0)",
                       lambda: torch.roll(k, 1, 0))
        bound_p, by_p = _bound(2 * k.numel() * k.element_size(), 0,
                               torch.bfloat16)
        rows["permute"] = (plain_ms, lib_ms, bound_p, by_p)
    return rows


def spp_peer_phase(card, ring, permute, pp, entry_mod):
    """Phase 36: worker_spp_peer in SPP_PEER_SIZES[-1] processes; the
    checks; the rows of the cross-process B9, B10, B11 and the
    transport for the kernels line."""
    import tempfile

    t_phase = time.perf_counter()
    size = SPP_PEER_SIZES[-1]
    env = {f"CHIP_SMOKE_SPP_PORT_{key}": str(_free_port())
           for key in SPP_PEER_PORTS}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        env["CHIP_SMOKE_SPP_REF"] = os.path.join(tmp, "ref.pt")
        print(f"world runs of the ring-variant, long-context and pipeline "
              f"paths in one process, and the twins' and yardsticks' "
              f"times [{card}]:")
        ref_rows = spp_peer_reference(ring, permute, entry_mod,
                                      env["CHIP_SMOKE_SPP_REF"])
        t_ref = time.perf_counter() - t_phase
        # The workers share the card with this process, whose allocator
        # still caches what the earlier phases freed (~77 GiB after phase
        # 33 in one run, where a worker then found no room for B10's
        # past-cap case): give it back first.
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        print(f"  this process holds "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB and "
              f"reserves {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB "
              f"of the card while the workers run")
        res = run_workers("36", timeout=SPP_PEER_TIMEOUT, size=size, env=env)
    t_workers = time.perf_counter() - t_phase - t_ref
    var_err = dict.fromkeys(VAR_PEER_CASES, 0.0)
    perm_err = 0.0
    for p in SPP_PEER_SIZES:
        parts = [r["sizes"][str(p)] for r in res[:p]]
        var = [part["var"] for part in parts]
        wrong = [w for v_ in var for w in v_["wrong"]]
        past = f" also past its register form at ({p}, " \
            f"{var[0]['past_cap_rows']}, 256)" if p == SPP_PEER_SIZES[-1] \
            else ""
        for name in VAR_PEER_CASES:
            var_err[name] = max([var_err[name]]
                                + [v_["err"][name] for v_ in var])
        print(f"B9, B10, B11 across {p} processes (process_of "
              f"{parts[0]['process_of']}, {var[0]['cases']} calls per "
              f"process, {PEER_BACK_TO_BACK} back to back per case: the "
              f"buffer and ragged shapes, B9 and B11 in f32 and bf16, B10 "
              f"f32{past}) against the one-card "
              f"kernel on the same world and the twin: "
              f"{'all bitwise equal' if not wrong else 'DIFFER ' + str(wrong[:6])}"
              f"; max |kernel - twin| "
              f"{ {n: max(v_['err'][n] for v_ in var) for n in VAR_PEER_CASES} }"
              f"; launches per process {[v_['launches'] for v_ in var]}")
        per = {name: len(cases) * len(VAR_PEER_DTYPES[name])
               * PEER_BACK_TO_BACK for name, cases in VAR_PEER_CASES.items()}
        if p == SPP_PEER_SIZES[-1]:
            per["q8"] += PEER_BACK_TO_BACK
        if wrong or any(v_["launches"] != per for v_ in var):
            failed.append(f"B9, B10, B11 across {p} processes")
        perm = [part["perm"] for part in parts]
        wrong = [w for pm in perm for w in pm["wrong"]]
        perm_err = max([perm_err] + [pm["err"] for pm in perm])
        print(f"the transport across {p} processes ({perm[0]['cases']} "
              f"calls per process: {', '.join(perm_peer_ops(None, p))}, "
              f"CudaProcessGroup's broadcast and send_recv in f32, bf16 and "
              f"int32, barrier; {PERM_PEER_ROUNDS} rounds) against the "
              f"world's spmd on the card: "
              f"{'all bitwise equal' if not wrong else 'DIFFER ' + str(wrong[:6])}"
              f"; launches (pull, B4b, B3) per process "
              f"{[pm['launches'] for pm in perm]}, expected "
              f"{perm[0]['want']}")
        if wrong or any(pm["launches"] != pm["want"] for pm in perm):
            failed.append(f"the transport across {p} processes")

    # (c) The ring-variant path.
    for name in VAR_PEER_CASES:
        got = [r["variants"][name] for r in res]
        print(f"multihost_ring_variants_entry {name} over {size} processes, "
              f"forward + VJP: (y, dx) against the world run "
              f"{'bitwise equal' if all(g['bitwise'] for g in got) else 'DIFFER'}"
              f"; launches per process {[g['launches'] for g in got]}; step "
              f"{[round(g['step_ms'], 6) for g in got]} ms (events) [{card}; "
              f"one card, time-sliced]")
        if not all(g["bitwise"] and g["launches"] == 2 for g in got):
            failed.append(f"the ring-variant path {name} across processes")

    # (d) The long-context path: the transport at its shapes, then the
    # paths.
    shift = [r["shift"] for r in res]
    wrong = [w for sh in shift for w in sh["wrong"]]
    perm_err = max([perm_err] + [sh["err"] for sh in shift])
    print(f"spmd.shift at the ring-flash path's shapes over {size} processes "
          f"({shift[0]['cases']} calls per process: a K block in bf16 and a "
          f"dK/dV carrier in f32, by +1 and -1 with wrap and +1 without) "
          f"against the world's spmd.shift on the card: "
          f"{'all bitwise equal' if not wrong else 'DIFFER ' + str(wrong[:6])}"
          f"; max |shift - world| {max(sh['err'] for sh in shift)}")
    if wrong:
        failed.append("the transport at the ring-flash path's shapes")
    want = {"ring_flash": [4, 4, 1, 1, 0, 0, 0, 20],
            "ulysses": [0, 0, 0, 0, 8, 1, 1, 0],
            "ring_attention": [0, 0, 0, 0, 0, 0, 0, 6]}
    for name in want:
        got = [r["sp"][name] for r in res]
        print(f"multihost_sp_entry {name} over {size} processes"
              f"{', forward + backward' if name != 'ring_attention' else ', forward'}"
              f": against the world run "
              f"{'bitwise equal' if all(g['bitwise'] for g in got) else 'not bitwise'}"
              f" (worst |a - b| / |b| {max(g['rel'] for g in got):.3e}, tol "
              f"{SP_TOL}); launches (B6, B7, prep, finish, B8, B1, B2, pull) "
              f"per process {[g['launches'] for g in got]}; "
              f"{[round(g['ms'], 6) for g in got]} ms per call (events) "
              f"[{card}; one card, time-sliced]")
        if not all(g["ok"] and g["finite"] and g["launches"] == want[name]
                   and (g["bitwise"] or name not in SPP_BITWISE)
                   for g in got):
            failed.append(f"the {name} path across processes")

    # (e) The pipeline path: per 1F1B tick B1 twice (the forward and the
    # recompute), B2 once, and two shifts; per GPipe tick B1 and a shift.
    ticks = pp._build_1f1b_tables(entry_mod.PP_STAGES,
                                  entry_mod.PP_MICROBATCHES)[0].shape[0]
    gp = [r["pp"]["gpipe"] for r in res]
    print(f"multihost_pp_entry GPipe forward over {size} processes: against "
          f"the world run {'bitwise equal' if all(g['bitwise'] for g in gp) else 'not bitwise'}"
          f" (worst |a - b| / |b| {max(g['rel'] for g in gp):.3e}, tol "
          f"{PP_TOL['out']}); launches (B1, B2, pull) per process "
          f"{[g['launches'] for g in gp]}; {[round(g['ms'], 6) for g in gp]} "
          f"ms (events) [{card}; one card, time-sliced]")
    gpipe_ticks = entry_mod.PP_STAGES + entry_mod.PP_MICROBATCHES - 1
    if not all(g["ok"] and g["bitwise"]
               and g["launches"] == [gpipe_ticks, 0, gpipe_ticks]
               for g in gp):
        failed.append("GPipe across processes")
    fb = [r["pp"]["1f1b"] for r in res]
    print(f"multihost_pp_entry {SPP_STEPS} 1F1B steps over {size} processes: "
          f"grads and loss_sum against the world run "
          f"{'bitwise equal' if all(f['bitwise'] for f in fb) else 'not bitwise'}"
          f" (loss rel {max(f['loss_rel'] for f in fb):.3e}, tol "
          f"{TRAIN_TOL['loss']}; grads |a - b| / |b| "
          f"{max(f['grad_rel'] for f in fb):.3e}, tol {TRAIN_TOL['grad']}); "
          f"the steps {'repeat bitwise' if all(f['repeat'] for f in fb) else 'DIFFER'}"
          f"; launches (B1, B2, pull) per process "
          f"{[f['launches'] for f in fb]}; "
          f"{[round(f['ms'], 6) for f in fb]} ms per step (events) [{card}; "
          f"one card, time-sliced]")
    if not all(f["ok"] and f["finite"] and f["repeat"]
               and f["launches"] == [2 * SPP_STEPS * ticks,
                                     SPP_STEPS * ticks,
                                     2 * SPP_STEPS * ticks] for f in fb):
        failed.append("1F1B across processes")

    # (f) Times.
    rows = {}
    for name in (*VAR_PEER_CASES, "permute"):
        t = res[0]["times"][name]
        plain_ms, lib_ms, bound, bound_by = ref_rows[name]
        print(f"  {t['label']} across {size} processes: device {t['ms']} ms "
              f"per launch (rank 0's profile), per call (events) "
              f"{[round(r['times'][name]['event_ms'], 6) for r in res]} ms; "
              f"the world's twin {plain_ms} ms, yardstick {lib_ms} ms, bound "
              f"{bound:.6f} ms ({bound_by}) [{card}; one card, time-sliced]")
        if name == "permute":
            n, err = res[0]["sp"]["ring_flash"]["launches"][-1], perm_err
        else:
            n, err = res[0]["variants"][name]["launches"], var_err[name]
        rows[name] = (n, err, (t["ms"], plain_ms, lib_ms, bound, bound_by))
    print(f"phase 36: {time.perf_counter() - t_phase:.1f} s (world runs "
          f"{t_ref:.1f} s, workers {t_workers:.1f} s, each "
          f"{max(r['wall_s'] for r in res):.1f} s)")
    if failed:
        raise AssertionError(f"phase 36 failed: {failed}")
    return rows


# ---- phase 37: FSDP across processes ----
# 4 worker processes on the card, one rank each: FSDP_PEER_STEPS steps of
# multihost_fsdp_entry with the launch counts read around each, then the
# step's event ms and rank 0's device profile of it. After each step a
# process gathers the parameters (not counted) and holds rank 0's rows
# against phase 23's world parameters after the same step: its
# state_digest, and as numbers the step's implied gradient (old - new) / lr
# against the world's, |g - g_world| / |g_world| per leaf. The world and
# the processes run the same per-rank computations, and the cross-process
# B3/B4a/B4b are bitwise their one-card kernels (phase 34), so the steps
# are expected to agree to the bit; only B2's dQ reduce-add, which lands
# in no fixed order, may round otherwise, an f32 rounding (~1e-7) of the
# gradient carried through FSDP_PEER_STEPS steps, and the implied gradient
# adds ulp(p) / lr. FSDP_PEER_GRAD_TOL sits well above both and far below
# any lost or doubled partial of the reduce-scatter (a whole rank's
# share, ~1/4 of a leaf's gradient or more).
FSDP_PEER_SIZE = 4
FSDP_PEER_STEPS = 3
FSDP_PEER_TIMING_STEPS = 3
FSDP_PEER_TIMEOUT = 300
FSDP_PEER_GRAD_TOL = 1e-3
FSDP_PEER_NAMES = ("ring_allgather", "ring_reduce_scatter", "ring_allreduce",
                   "flash_attention_fwd", "flash_attention_bwd")


def worker_fsdp_peer(rank, size, store, device="cuda"):
    """Phase 37 on one of `size` processes (see the comment above
    FSDP_PEER_SIZE). CHIP_SMOKE_FSDP_WORLD names the file of phase 23's
    world rows (fsdp_path's)."""
    import sys

    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.checkpoint import state_digest
    from gloo_tpu_torch.models import Transformer
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.parallel.fsdp import unshard_params

    _share_cores(size)
    t0 = time.perf_counter()

    def note(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", file=sys.stderr,
              flush=True)

    world = torch.load(os.environ["CHIP_SMOKE_FSDP_WORLD"])
    step, (state, batch) = entry_mod.multihost_fsdp_entry(
        rank, size, f"127.0.0.1:{os.environ['CHIP_SMOKE_FSDP_PORT']}",
        device, device_hostname="127.0.0.1")
    note("multihost_fsdp_entry")
    counters = (ring.ring_allgather, ring.ring_reduce_scatter,
                ring.ring_allreduce, attn.flash_attention_fwd,
                attn.flash_attention_bwd)
    template = Transformer(entry_mod.ENTRY_CONFIG, device="meta").state_dict()
    lr = entry_mod.FSDP_LR

    def gathered():
        full = unshard_params(state, template, "data", mesh=step.mesh)
        return {k: v[0].cpu() for k, v in full.items()}

    old = gathered()
    out = {"local_ranks": step.mesh.local_ranks,
           "shard_numel": {k: v.numel() for k, v in state.items()},
           "start_is_world": state_digest(old) == state_digest(world[0]),
           "launches": [], "losses": [], "digests": [], "world_digest": [],
           "grad_rel": [], "max_abs": []}
    for i in range(FSDP_PEER_STEPS):
        for c in counters:
            c.launches = 0
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        out["launches"].append([c.launches for c in counters])
        out["losses"].append([float(x) for x in loss])
        new = gathered()
        out["digests"].append(state_digest(new))
        out["world_digest"].append(out["digests"][-1]
                                   == state_digest(world[i + 1]))
        rel = {}
        for k in new:
            g = (old[k].float() - new[k].float()) / lr
            gw = (world[i][k].float() - world[i + 1][k].float()) / lr
            rel[k] = float((g - gw).norm() / gw.norm().clamp_min(1e-30))
        out["grad_rel"].append(max(rel.values()))
        out["max_abs"].append(max(float((new[k].float()
                                         - world[i + 1][k].float())
                                        .abs().max()) for k in new))
        old = new
    out["finite"] = all(bool(torch.isfinite(v).all())
                        for v in state.values())
    note("steps")

    def once():
        step(state, batch)

    step.context.barrier()
    out["step_ms"] = event_ms(once, iters=FSDP_PEER_TIMING_STEPS)
    step.context.barrier()
    out["device_ms"], rows = same_calls(once, rank, FSDP_PEER_TIMING_STEPS,
                                        want=("ring_peer_kernel",))
    peer = [r for r in rows if "ring_peer_kernel" in r[2]]
    out["peer_ms"] = sum(r[0] for r in peer) if peer else None
    out["peer_calls"] = sum(r[1] for r in peer)
    out["device_rows"] = rows[:8]
    note("times")
    step.context.close()
    out["wall_s"] = time.perf_counter() - t0
    return out


def fsdp_peer_phase(card, world_losses, world_params):
    """Phase 37: worker_fsdp_peer in FSDP_PEER_SIZE processes; the checks
    against phase 23's world losses and parameters (fsdp_path's). Returns
    rank 0's launches of the cross-process B4b, B4a and B3 over the
    steps."""
    import gc
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    # The workers share the card with this process: give back what its
    # allocator caches first, as phase 36 does.
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-37-world-")
    try:
        path = os.path.join(tmp, "world.pt")
        torch.save(world_params, path)
        env = {"CHIP_SMOKE_FSDP_PORT": str(_free_port()),
               "CHIP_SMOKE_FSDP_WORLD": path}
        res = run_workers("37", timeout=FSDP_PEER_TIMEOUT,
                          size=FSDP_PEER_SIZE, env=env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from gloo_tpu_torch.entry import ENTRY_CONFIG, FSDP_MESH

    failed = []
    per_rank = FSDP_MESH["data"] // FSDP_PEER_SIZE
    layers = ENTRY_CONFIG.n_layers
    want = [15, 15, 1, per_rank * layers, per_rank * layers]
    world = world_losses[:FSDP_PEER_STEPS]
    for rank, r in enumerate(res):
        print(f"multihost_fsdp_entry process {rank} (ranks "
              f"{r['local_ranks']}, {len(r['shard_numel'])} leaves, "
              f"{sum(r['shard_numel'].values())} shard elements): losses "
              f"{', '.join(f'{x[0]:.6f}' for x in r['losses'])}; launches "
              f"({', '.join(FSDP_PEER_NAMES)}) per step {r['launches']}; "
              f"step {r['step_ms']:.6f} ms (events) [{card}; one card, "
              f"time-sliced]")
        print(f"  gathered parameters vs phase 23's world after each step: "
              f"state_digest {'equal' if all(r['world_digest']) else 'not'}"
              f" the world's ({r['world_digest']}), max |p - p_world| "
              f"{', '.join(f'{x:.3e}' for x in r['max_abs'])}; implied "
              f"grads |g - g_world| / |g_world| max over leaves "
              f"{', '.join(f'{x:.3e}' for x in r['grad_rel'])} (tol "
              f"{FSDP_PEER_GRAD_TOL}); the start "
              f"{'is' if r['start_is_world'] else 'IS NOT'} the world's")
        if any(l != want for l in r["launches"]) \
                or len(r["shard_numel"]) != 15:
            failed.append(f"process {rank}'s launches {r['launches']}, "
                          f"expected {want} per step over 15 leaves")
        if not r["start_is_world"] \
                or not all(x <= FSDP_PEER_GRAD_TOL for x in r["grad_rel"]):
            failed.append(f"process {rank}'s parameters against the "
                          f"world's")
    losses = [[x for row in r["losses"] for x in row] for r in res]
    firsts = [row[0] for r in res for row in r["losses"]]
    same = all(l == losses[0] for l in losses) and all(
        x == row[0] for r in res for row in r["losses"] for x in row)
    diffs = [abs(r["losses"][i][0] - world[i]) for r in res
             for i in range(FSDP_PEER_STEPS)]
    rel = max(abs(r["losses"][i][0] - world[i]) / abs(world[i])
              for r in res for i in range(FSDP_PEER_STEPS))
    digests = [r["digests"] for r in res]
    print(f"multihost FSDP vs phase 23's world steps "
          f"({', '.join(f'{x:.6f}' for x in world)}): max |loss - "
          f"loss_world| {max(diffs):.3e} (rel {rel:.3e}, tol "
          f"{TRAIN_TOL['loss']}; "
          f"{'bitwise equal' if max(diffs) == 0 else 'not bitwise'}); "
          f"losses {'equal' if same else 'DIFFER'} across the processes; "
          f"state_digest of the gathered parameters after each step "
          f"{'equal' if all(d == digests[0] for d in digests) else 'DIFFER'}"
          f" across the processes")
    if not same or rel > TRAIN_TOL["loss"] \
            or not all(np.isfinite(firsts)) \
            or not all(d == digests[0] for d in digests) \
            or not all(r["finite"] for r in res):
        failed.append("the multihost FSDP step")
    lead = res[0]
    busy = "not measured" if lead["device_ms"] is None \
        else f"{lead['device_ms'] / lead['step_ms']:.3f}"
    per_launch = None if not lead["peer_calls"] \
        else lead["peer_ms"] / lead["peer_calls"]
    print(f"multihost FSDP step (process 0): {lead['step_ms']:.6f} ms "
          f"(events), device {lead['device_ms']} ms, busy share {busy}; "
          f"the cross-process B4b, B4a and B3 {lead['peer_ms']} ms of it in "
          f"{lead['peer_calls']:g} launches, {per_launch} ms per launch "
          f"[{card}; one card, time-sliced]")
    for dev_ms, calls, kname in lead["device_rows"]:
        print(f"  {dev_ms:.6f} ms in {calls:g} calls: {kname[:90]}")
    print(f"phase 37: {time.perf_counter() - t_phase:.1f} s (workers "
          f"{max(r['wall_s'] for r in res):.1f} s)")
    if failed:
        raise AssertionError(f"phase 37 failed: {failed}")
    total = [sum(col) for col in zip(*lead["launches"])]
    return dict(zip(FSDP_PEER_NAMES[:3], total[:3]))


# ---- phase 39: worlds past 32 ranks ----
#
# The kernels' rank tables live in device memory (csrc/ring_common.cuh's
# PerRank and Rings; ops/ring.py's ring_table), so a world on one card is
# bounded by the residency of its cooperative launch alone. Phase 39 runs
# the port's dry run at WIDE_RANKS ranks (entry.dryrun_multichip, the
# reference's own scaling and asserts), holds each one-card kernel at that
# world against its plain version (WIDE_MESHES), runs the ring-variant
# path and B3 on the flagship's gradient buffer at WIDE_RANKS, times every
# kernel there, and runs the cross-process B3 over WIDE_PEER_PROCESSES
# processes of WIDE_RANKS / WIDE_PEER_PROCESSES local ranks each.
WIDE_RANKS = 64
# (label, mesh axes, ring axis): one ring of every rank, and the dry run's
# dp x tp mesh along each of its axes.
WIDE_MESHES = (("x64", {"x": WIDE_RANKS}, "x"),
               ("2x32_model", {"data": 2, "model": WIDE_RANKS // 2}, "model"),
               ("2x32_data", {"data": 2, "model": WIDE_RANKS // 2}, "data"))
WIDE_PEER_PROCESSES = 2
# Each rank's rows and columns of the cross-process B3 (f32).
WIDE_PEER_SHAPE = (2 * WIDE_RANKS, 64)
WIDE_PEER_CALLS = 3
WIDE_PEER_TIMEOUT = 300
# The dry run's kernels: the wrapper whose counter each one adds to.
WIDE_KERNELS = ("ring_allreduce", "ring_reduce_scatter", "ring_allgather",
                "matmul_reduce_scatter", "allgather_matmul", "alltoall",
                "ring_allreduce_hbm", "ring_allreduce_q8",
                "ring_allreduce_bidir", "flash_attention_fwd")


def wide_counters(ring, ov, attn):
    """{name: wrapper} of WIDE_KERNELS (each has its .launches)."""
    mods = (ring, ov, attn)
    return {name: next(getattr(m, name) for m in mods if hasattr(m, name))
            for name in WIDE_KERNELS}


def wide_bitwise(label, fn, plain, x, axis, mesh, same_ring=True):
    """RING_RUNS calls of fn against one of its plain version, bitwise, and
    (same_ring) every rank of a ring bitwise equal to the first of its ring.
    Returns (max |kernel - plain|, list of what failed); prints one line."""
    outs = [fn(x, axis, mesh) for _ in range(RING_RUNS)]
    torch.cuda.synchronize()
    ref = plain(x, axis, mesh)
    diff = max(float((o.double() - ref.double()).abs().max()) for o in outs)
    bad = [] if all(torch.equal(o, ref) for o in outs) \
        else ["differs from its plain version"]
    if same_ring and not torch.equal(
            outs[0], outs[0][[m[0] for m in mesh.ring_members(axis)]]):
        bad.append("ranks of a ring differ")
    print(f"{fn.__name__} {label}: {x.shape[0]} ranks of "
          f"{tuple(x.shape[1:])} {str(x.dtype)[6:]}, ring {axis!r} of "
          f"{mesh.shape[axis]}, {RING_RUNS} runs: max |kernel - plain| "
          f"{diff:.3e}{'; FAILED: ' + ', '.join(bad) if bad else ''}")
    return diff, bad


def wide_twins(ring, ov, make_mesh, gen):
    """Each one-card kernel at WIDE_RANKS ranks against its plain version:
    B3, B4a, B4b, B9, B11 and B8 bitwise, B10 bitwise and within Q8_REL of
    the f64 sum, B5a and B5b within overlap_close. Returns {kernel: max
    |kernel - plain|}."""
    dev = gen.device
    errs, failed = {}, []

    def keep(name, diff, bad, label):
        errs[name] = max(errs.get(name, 0.0), diff)
        failed.extend(f"{name} {label}: {b}" for b in bad)

    for label, axes, axis in WIDE_MESHES:
        mesh = make_mesh(axes, devices=[dev] * WIDE_RANKS)
        n = axes[axis]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((WIDE_RANKS, n * 4, 40), generator=gen,
                            device=dev).to(dtype)
            for fn, plain in (
                    (ring.ring_allreduce, ring.ring_allreduce_plain),
                    (ring.ring_reduce_scatter,
                     ring.ring_reduce_scatter_plain),
                    (ring.ring_allgather, ring.ring_allgather_plain)):
                diff, bad = wide_bitwise(
                    f"{label} {str(dtype)[6:]}", fn, plain, x, axis, mesh,
                    same_ring=fn is not ring.ring_reduce_scatter)
                keep(fn.__name__, diff, bad, label)
        for variant, per, cols in (("hbm", n * 8, 128), ("q8", n * 32, 128),
                                   ("bidir", n * 8, 256)):
            x = torch.randn((WIDE_RANKS, per, cols), generator=gen,
                            device=dev)
            fn = getattr(ring, f"ring_allreduce_{variant}")
            diff, bad = wide_bitwise(
                label, fn, getattr(ring, f"ring_allreduce_{variant}_plain"),
                x, axis, mesh)
            if variant == "q8":
                exact = torch.stack([x[row].double().sum(0)
                                     for row in mesh.ring_members(axis)])
                out = fn(x, axis, mesh)
                rel = float((out.double() - exact).abs().max()
                            / exact.abs().max())
                print(f"  q8 {label}: max |out - sum| / max |sum| {rel:.3e}")
                if not rel < Q8_REL:
                    bad.append(f"rel {rel:.3e} to the sum")
            keep(fn.__name__, diff, bad, label)
        x = torch.randint(-2 ** 20, 2 ** 20, (WIDE_RANKS, n * 4, 24),
                          generator=gen, device=dev).to(torch.bfloat16)
        diff, bad = wide_bitwise(label, ring.alltoall, ring.alltoall_plain,
                                 x, axis, mesh, same_ring=False)
        keep("alltoall", diff, bad, label)
        for dtype in (torch.float32, torch.bfloat16):
            rows, k, cols = 8, 64, 64
            x = torch.randn((WIDE_RANKS, n * rows, k), generator=gen,
                            device=dev).to(dtype)
            w = (torch.randn((WIDE_RANKS, k, cols), generator=gen,
                             device=dev) / math.sqrt(k)).to(dtype)
            xs = x[:, :rows].contiguous()
            a_err = b_err = 0.0
            ok = True
            for _ in range(RING_RUNS):
                out = ov.matmul_reduce_scatter(x, w, axis, mesh)
                y, _ = ov.allgather_matmul_fwd(xs, w, axis, mesh)
                torch.cuda.synchronize()
                err, a_ok = overlap_close(
                    out, ov.matmul_reduce_scatter_plain(x, w, axis, mesh))
                a_err = max(a_err, err)
                err, b_ok = overlap_close(
                    y, ov.allgather_matmul_plain(xs, w, axis, mesh)[0])
                b_err = max(b_err, err)
                ok = ok and a_ok and b_ok
            print(f"overlap {label} {str(dtype)[6:]}: {WIDE_RANKS} ranks, "
                  f"ring {axis!r} of {n}, {RING_RUNS} runs: max |kernel - "
                  f"plain| B5a {a_err:.3e}, B5b {b_err:.3e}"
                  f"{'' if ok else '; FAILED'}")
            keep("matmul_reduce_scatter", a_err,
                 [] if ok else ["outside its tolerance"], label)
            keep("allgather_matmul", b_err, [], label)
    if failed:
        raise AssertionError(f"the kernels disagree at {WIDE_RANKS} ranks: "
                             f"{failed}")
    return errs


def wide_dry_run(entry_mod, counters):
    """entry.dryrun_multichip(WIDE_RANKS) on the card, the counters set to 0
    just before it and read just after. Returns ({kernel: launches},
    seconds)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = entry_mod.dryrun_multichip(WIDE_RANKS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    grads, loss = out["1f1b"]
    print(f"dryrun_multichip({WIDE_RANKS}) on the card in {seconds:.2f} s: "
          f"dp x tp loss {float(out['dp_tp']):.6f}, FSDP loss "
          f"{float(out['fsdp'][0]):.6f}, 1F1B loss {float(loss.sum()):.6f}, "
          f"dispatch_combine all 2.0 "
          f"{bool((out['dispatch_combine'] == 2.0).all())}; launches "
          f"{launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"dryrun_multichip({WIDE_RANKS}) launched no "
                             f"{missing}")
    finite = all(bool(torch.isfinite(t).all()) for key, t in out.items()
                 if key != "1f1b")
    if not finite or not bool((out["dispatch_combine"] == 2.0).all()):
        raise AssertionError(f"dryrun_multichip({WIDE_RANKS}) gave a "
                             f"non-finite section or dropped a token")
    return launches, seconds


def wide_buffer(ring, entry_mod):
    """The ring-variant path at WIDE_RANKS (ring_variants_entry(ranks=)):
    each variant's forward and backward of sum(y ** 2) on the flagship's
    gradient buffer, the launch counts read around it (2 of its own, no
    other), y and dx bitwise their plain versions' and the same on every
    rank; B9 and B11 also within VARIANT_RTOL of the f64 sum (dx of 2 n
    sum). B10 is held to its plain version only: its int8 error grows with
    the ring (phase 21 holds it within Q8_REL at 4 ranks; here it is
    printed). Then B3 on the same buffer, bitwise its plain version.
    Returns (x, mesh)."""
    paths = entry_mod.ring_variants_entry(ranks=WIDE_RANKS)
    counters = {"hbm": ring.ring_allreduce_hbm, "q8": ring.ring_allreduce_q8,
                "bidir": ring.ring_allreduce_bidir, "b3": ring.ring_allreduce}
    failed = []
    for name, (fn, args) in paths.items():
        variant, x, mesh = args
        for c in counters.values():
            c.launches = 0
        y, g = fn(*args)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        plain = getattr(ring, f"{variant.__name__}_plain")
        y_ref = plain(x, "data", mesh)
        g_ref = plain(2 * y_ref, "data", mesh)
        n = x.shape[0]
        exact = x.double().sum(0)
        rels = [float((t[0].double() - w).abs().max() / w.abs().max())
                for t, w in ((y, exact), (g, 2 * n * exact))]
        bitwise = torch.equal(y, y_ref) and torch.equal(g, g_ref)
        same = all(torch.equal(t[r], t[0]) for t in (y, g)
                   for r in range(n))
        print(f"ring-variant path {name} at {n} ranks: {tuple(x.shape[1:])} "
              f"f32 a rank, forward + backward of sum(y ** 2): launches "
              f"{got}; y and dx bitwise their plain versions {bitwise}; "
              f"every rank bitwise equal {same}; max |y - sum| / max |sum| "
              f"{rels[0]:.3e}, max |dx - 2 n sum| / max |2 n sum| "
              f"{rels[1]:.3e}")
        if got != {k: 2 if k == name else 0 for k in counters} \
                or not bitwise or not same \
                or (name != "q8" and max(rels) >= VARIANT_RTOL):
            failed.append(name)
        del y, g, y_ref, g_ref
    if failed:
        raise AssertionError(f"the ring-variant path at {WIDE_RANKS} ranks "
                             f"failed: {failed}")
    _, x, mesh = paths["hbm"][1]
    print(f"flagship buffer at {WIDE_RANKS} ranks: {tuple(x.shape)} f32, "
          f"{x[0].numel() * 4 / 1e6:.2f} MB a rank")
    _, bad = wide_bitwise("flagship buffer", ring.ring_allreduce,
                          ring.ring_allreduce_plain, x, "data", mesh)
    if bad:
        raise AssertionError(f"B3 on the flagship buffer at {WIDE_RANKS} "
                             f"ranks: {bad}")
    return x, mesh


def wide_times(ring, ov, make_mesh, gen, x, mesh, card):
    """Device ms per launch of every kernel at WIDE_RANKS ranks, beside the
    bytes bound (each input read once, each output written once at
    HBM_BYTES_PER_S): B3, B4a, B4b, B9, B10, B11 and B8 on the flagship
    buffer x (P, 8192, 256) f32 along "data", B5a and B5b at 64-row bf16
    chunks of the flagship's width. Returns {kernel: (ms, bound ms)}."""
    p = x.shape[0]
    s = x[0].numel() * 4
    chunk = x[:, : x.shape[1] // p].contiguous()
    d = x.shape[2]  # the flagship's d_model
    dev = x.device
    xa = torch.randn((p, p * 64, d), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((p, d, d), generator=gen, device=dev)
         / math.sqrt(d)).to(torch.bfloat16)
    xb = xa[:, :64].contiguous()
    cases = (
        ("ring_allreduce", "ring_kernel",
         lambda: ring.ring_allreduce(x, "data", mesh), 2 * p * s),
        ("ring_reduce_scatter", "ring_kernel",
         lambda: ring.ring_reduce_scatter(x, "data", mesh), p * s + s),
        ("ring_allgather", "ring_kernel",
         lambda: ring.ring_allgather(chunk, "data", mesh), s + p * s),
        ("ring_allreduce_hbm", "hbm_kernel",
         lambda: ring.ring_allreduce_hbm(x, "data", mesh), 2 * p * s),
        ("ring_allreduce_q8", "q8_kernel",
         lambda: ring.ring_allreduce_q8(x, "data", mesh), 2 * p * s),
        ("ring_allreduce_bidir", "bidir_kernel",
         lambda: ring.ring_allreduce_bidir(x, "data", mesh), 2 * p * s),
        ("alltoall", "alltoall_kernel",
         lambda: ring.alltoall(x, "data", mesh), 2 * p * s),
        ("matmul_reduce_scatter", "matmul_rs_kernel",
         lambda: ov.matmul_reduce_scatter(xa, w, "data", mesh),
         2 * (xa.numel() + w.numel() + p * 64 * d)),
        ("allgather_matmul", "ag_matmul_kernel",
         lambda: ov.allgather_matmul_fwd(xb, w, "data", mesh),
         2 * (xb.numel() + w.numel() + 2 * p * p * 64 * d)))
    times = {}
    for name, kernel, fn, nbytes in cases:
        ms = timed_kernel(f"{name} at {p} ranks", fn, kernel)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        times[name] = (ms, bound)
        print(f"  {name} at {p} ranks: bound {bound:.6f} ms (bytes, "
              f"{nbytes / 1e6:.1f} MB), {card}")
    missing = [name for name, (ms, _) in times.items() if ms is None]
    if missing:
        raise AssertionError(f"the profiler showed no device time at "
                             f"{p} ranks for {missing}")
    return times


def worker_wide_peer(rank, size, store, device="cuda"):
    """Phase 39 on one of WIDE_PEER_PROCESSES processes: a process mesh
    {"data": WIDE_RANKS} of WIDE_RANKS / size local ranks on the card each,
    the cross-process B3 WIDE_PEER_CALLS times on this process's rows of a
    world drawn from a seed, each bitwise the rows of B3's plain version
    on the whole world; its launches and event ms per call."""
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.tpu import init_multihost, make_mesh

    _share_cores(size)
    local = WIDE_RANKS // size
    ctx, mesh = init_multihost(
        rank, size, f"127.0.0.1:{os.environ['CHIP_SMOKE_WIDE_PORT']}",
        {"data": WIDE_RANKS}, device_hostname="127.0.0.1",
        devices=[device] * local)
    world = torch.randn((WIDE_RANKS, *WIDE_PEER_SHAPE),
                        generator=torch.Generator().manual_seed(39))
    cpu = make_mesh({"data": WIDE_RANKS}, devices=["cpu"] * WIDE_RANKS)
    want = ring.ring_allreduce_plain(world, "data", cpu)[mesh.local_ranks]
    x = world[mesh.local_ranks].to(mesh.device)
    ring.ring_allreduce.launches = 0
    same = []
    for _ in range(WIDE_PEER_CALLS):
        out = ring.ring_allreduce(x, "data", mesh)
        torch.cuda.synchronize()
        same.append(torch.equal(out.cpu(), want))
    launches = ring.ring_allreduce.launches
    ctx.barrier()
    ms = event_ms(lambda: ring.ring_allreduce(x, "data", mesh), iters=5)
    ctx.barrier()
    result = {"local_ranks": mesh.local_ranks, "bitwise": same,
              "launches": launches, "event_ms": ms}
    ctx.close()
    return result


def wide_peer_phase(card):
    """Phase 39's cross-process B3: worker_wide_peer in WIDE_PEER_PROCESSES
    processes on the card. Returns rank 0's event ms per call."""
    env = {"CHIP_SMOKE_WIDE_PORT": str(_free_port())}
    res = run_workers("39", timeout=WIDE_PEER_TIMEOUT,
                      size=WIDE_PEER_PROCESSES, env=env)
    for rank, r in enumerate(res):
        print(f"cross-process ring_allreduce, process {rank} of "
              f"{WIDE_PEER_PROCESSES}: {len(r['local_ranks'])} local ranks "
              f"of {WIDE_RANKS} ({r['local_ranks'][0]}..."
              f"{r['local_ranks'][-1]}), {WIDE_PEER_SHAPE} f32 each; "
              f"launches {r['launches']}, bitwise the world's plain rows "
              f"{r['bitwise']}; {r['event_ms']:.3f} ms per call (events, "
              f"time-sliced), {card}")
        if not all(r["bitwise"]) or r["launches"] != WIDE_PEER_CALLS:
            raise AssertionError(f"the cross-process ring_allreduce at "
                                 f"{WIDE_RANKS} ranks failed on process "
                                 f"{rank}: {r}")
    return res[0]["event_ms"]


def wide_world_phase(ring, ov, attn, entry_mod, make_mesh, gen, card):
    """Phase 39 (see the comment above WIDE_RANKS). Returns {kernel:
    (launches in the dry run, max |kernel - plain| at WIDE_RANKS, device
    ms, bound ms)}."""
    t0 = time.perf_counter()
    counters = wide_counters(ring, ov, attn)
    launches, _ = wide_dry_run(entry_mod, counters)
    errs = wide_twins(ring, ov, make_mesh, gen)
    x, mesh = wide_buffer(ring, entry_mod)
    times = wide_times(ring, ov, make_mesh, gen, x, mesh, card)
    del x
    torch.cuda.empty_cache()
    wide_peer_phase(card)
    rows = {name: (launches[name], errs[name], *times[name])
            for name in times}
    print(json.dumps({"wide_world": {
        "ranks": WIDE_RANKS, "card": card,
        "kernels": {k: dict(zip(("launches", "max_abs_err", "ms",
                                 "bound_ms"), v)) for k, v in rows.items()},
        "flash_fwd_launches": launches["flash_attention_fwd"],
        "seconds": time.perf_counter() - t0}}))
    return rows


WORKERS = {"26": worker_staging, "27": worker_host_sync, "28": worker_hier,
           "29": worker_elastic, "29b": worker_run_elastic,
           "30": worker_surface, "32": worker_traced,
           "34": worker_peer, "35": worker_tp_peer, "36": worker_spp_peer,
           "37": worker_fsdp_peer, "39": worker_wide_peer}


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
    from gloo_tpu_torch.ops import permute, ring
    from gloo_tpu_torch.parallel import dp_tp, pp, sp, tp
    from gloo_tpu_torch.parallel.ddp import buffer_width
    from gloo_tpu_torch.parallel.fsdp import unshard_params
    from gloo_tpu_torch.tpu import CudaProcessGroup, make_mesh, spmd
    from gloo_tpu_torch.utils import tracing

    t_main = time.perf_counter()

    def at_phase(n):
        print(f"phase {n} starts at {time.perf_counter() - t_main:.1f} s",
              flush=True)

    # Phase 1: the card.
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f16 products accumulate in f32, as on the CPU and in the kernels.
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

    at_phase("2")
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

    at_phase("3")
    # Phase 3: kernel against plain on the card.
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_errs, bwd_errs = {}, {}
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
        fwd_errs[name] = out_err
    failed = []
    with torch.enable_grad():
        for case in FLASH_CASES:
            err, ok = check_bwd(attn, *case, gen)
            bwd_errs[case[0]] = err
            if not ok:
                failed.append(case[0])
    if failed:
        raise AssertionError(f"flash_bwd disagrees with its plain version "
                             f"or the reference at {failed}")

    at_phase("4")
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

    at_phase("5")
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

    at_phase("6")
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

    at_phase("7")
    # Phase 7: times. SDPA is a yardstick only; the port never calls it.
    print(f"times on {card}:")
    t_phase = time.perf_counter()
    timed_cases = [c for c in FLASH_CASES if c[0] not in UNTIMED_CASES]
    rows = {}
    for name, b, h, h_kv, t, d, dtype, causal in timed_cases:
        t_row = time.perf_counter()
        fused = dtype != torch.float32
        q, k, v = make_qkv(b, h, h_kv, t, d, dtype, gen, fused)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=h != h_kv)

        with torch.inference_mode():
            ms = timed(f"{name} kernel",
                       lambda: attn.flash_attention_fwd(q, k, v, causal))
            plain = timed(f"{name} plain",
                          lambda: attn.flash_attention_plain(q, k, v, causal))
            backend = sdpa_backend(q, k, v, causal)
            lib = timed(f"{name} sdpa ({backend} backend)", sdpa)
        bound, bound_by = flash_bound(b, h, h_kv, t, d, dtype, causal)
        print(f"  {name} bound {bound:.6f} ms ({bound_by}); row "
              f"{time.perf_counter() - t_row:.1f} s")
        rows[name] = (ms, plain, lib, bound, bound_by)
    bwd_rows = {}
    for name, b, h, h_kv, t, d, dtype, causal in timed_cases:
        t_row = time.perf_counter()
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
                attn.FLASH_BWD_WIDE_KERNELS
                if attn.kernel_head_dim(d) > attn.KERNEL_HEAD_DIMS[-1]
                else attn.FLASH_BWD_KERNELS[dtype])
            timed(f"{name} bwd op (autograd: the three launches, and at "
                  f"a padded head_dim the pads and the slices' copies)",
                  lambda: torch.autograd.grad(op_out, leaves, do,
                                              retain_graph=True))
            plain = timed(
                f"{name} bwd plain",
                lambda: attn.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                       causal), iters=3)
            backend = sdpa_backend(*leaves, causal)
            lib = timed(f"{name} bwd sdpa ({backend} backend)",
                        lambda: torch.autograd.grad(sdpa_out, leaves, do,
                                                    retain_graph=True))
        bound, bound_by = flash_bwd_bound(b, h, h_kv, t, d, dtype, causal)
        print(f"  {name} bwd bound {bound:.6f} ms ({bound_by}); row "
              f"{time.perf_counter() - t_row:.1f} s")
        bwd_rows[name] = (ms, plain, lib, bound, bound_by)
    print(f"phase 7, the FLASH_CASES rows: "
          f"{time.perf_counter() - t_phase:.1f} s")
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

    at_phase("8")
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

    at_phase("9")
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

    at_phase("10")
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

    at_phase("11")
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

    at_phase("12")
    # Phase 12: the collective matmuls against their plain versions.
    overlap_errs = overlap_cases(ov, make_mesh, gen)

    at_phase("13")
    # Phase 13: the fused Megatron-SP MLP (path B).
    slice4 = (ov.allgather_matmul, ov.matmul_reduce_scatter,
              ring.ring_allgather, ring.ring_reduce_scatter,
              ring.ring_allreduce)
    mlp_launches, (mlp_mesh, mlp_args, mlp_hidden, mlp_leaves, mlp_dy) = \
        fused_mlp_path(ov, tp, slice4, make_mesh, gen, cfg)

    at_phase("14")
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

    at_phase("15")
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

    at_phase("16")
    # Phase 16: the ring-attention step kernels and the all-to-all against
    # their plain versions.
    step_errs = step_cases(attn, sp, spmd, make_mesh, gen)
    hidden_tiles_untouched(attn, sp, spmd, make_mesh, gen)
    unrounded_guard(attn, sp, spmd, make_mesh, gen)
    a2a_err = alltoall_cases(ring, make_mesh, gen)

    at_phase("17")
    # Phase 17: the long-context path (path S).
    sp_launches, sp_paths = sp_path(attn, ring, sp_entry)

    at_phase("18")
    # Phase 18: the MoE path (path E).
    ep_launches, ep = ep_path(ring, ep_entry, expert_mlp)

    at_phase("19")
    # Phase 19: times of B6, B7a, B7b and B8 at the paths' shapes, and of
    # the three paths.
    slice5_rows = slice5_times(attn, sp, spmd, ring, sp_paths, ep, card)
    print(f"B8 launches: {sp_launches['ulysses'][4]} on the Ulysses path "
          f"(the kernels line), {ep_launches} on the MoE path")

    at_phase("20")
    # Phase 20: the ring variants against their plain versions, and the
    # sum collectives at more dtypes.
    variant_errs = variant_cases(ring, make_mesh, gen)
    sum_dtype_cases(ring, spmd, make_mesh, gen)

    at_phase("21")
    # Phase 21: the ring-variant path, and B10 on a DDP step's gradients.
    variant_launches, variant_paths = variants_path(ring,
                                                    ring_variants_entry)
    _, vx, vmesh = variant_paths["q8"][1]
    q8_on_ddp_grads(ring, ddp_train_entry, vx, vmesh)

    at_phase("22")
    # Phase 22: times of B9, B10 and B11 at the path's shape; and phases
    # 21 and 22 at every sum dtype for B9 and B11.
    variant_rows = variant_times(ring, variant_paths, card)
    variant_dtypes(ring, variant_paths, card, gen)

    at_phase("23")
    # Phase 23: the FSDP path (B4b, B4a and B3 around each rank's B1/B2).
    _, fsdp_losses, fsdp_world, fsdp = fsdp_path(
        attn, ring, entry_mod, unshard_params, make_mesh, cfg)

    at_phase("24")
    # Phase 24: the pipeline path (B1 and B2 in every tick).
    _, pp_paths = pp_path(attn, pp, entry_mod)

    at_phase("25")
    # Phase 25: times of the FSDP and pipeline paths, and the device time
    # under their scopes.
    parallel_times(tracing, fsdp, pp_paths, card)

    at_phase("26")
    # Phases 26-28: the host plane in two processes on the card.
    hier = host_phases(card)

    at_phase("29")
    # Phase 29: elastic acceptance on the card.
    elastic_phase(card)

    at_phase("30")
    # Phase 30: the rest of the host plane's Context surface in three
    # processes on the card.
    surface_phase(card)

    at_phase("31")
    # Phase 31: the flagship at one head of 256 in f16.
    d256_f16_phase(attn, ov, tp, ring, sp, spmd, make_mesh, entry_mod, gen,
                   card, rows, bwd_rows)

    at_phase("32")
    # Phase 32: phase 28's step, encrypted and traced, under a fault and
    # the elected schedule and tuning table.
    traced_phase(card, hier)

    at_phase("33")
    # Phase 33: the device-plane bench tool, the examples and the dump
    # viewers on the card.
    tool_phase(attn, ov, ring, make_mesh, gen, card)

    at_phase("34")
    # Phase 34: the device plane across processes: the probe, B3, B4a and
    # B4b across 2, 3 and 4 processes on the card, and the flagship's DDP
    # step at one process per rank.
    peer_rows = peer_phase(card, ddp_losses)

    at_phase("35")
    # Phase 35: tensor and expert parallelism across processes: B8, B5a and
    # B5b across 2-4 processes, the fused MLP, the dp x tp step and the
    # MoE path at one process per rank.
    tp_peer_rows = tp_peer_phase(card, ov, ring, entry_mod, tp_losses)

    at_phase("36")
    # Phase 36: the ring variants, spmd's point-to-point collectives, and
    # sequence and pipeline parallelism across processes: B9, B10, B11 and
    # the transport across 2-4 processes, the ring-variant, long-context
    # and pipeline paths at one process per rank.
    spp_peer_rows = spp_peer_phase(card, ring, permute, pp, entry_mod)

    at_phase("37")
    # Phase 37: FSDP across processes: the flagship's fully-sharded step at
    # one process per rank over the cross-process B4b, B4a and B3.
    fsdp_peer_launches = fsdp_peer_phase(card, fsdp_losses, fsdp_world)

    at_phase("38")
    # Phase 38: the flagship at head widths 36 and 512: the padded d 64
    # instances and the wide kernels on its serving, training and
    # ring-flash paths.
    wide = head_width_phase(attn, sp, spmd, make_mesh, entry_mod, card)

    at_phase("39")
    # Phase 39: worlds past 32 ranks: the dry run at WIDE_RANKS ranks on
    # the card, every one-card kernel there against its plain version, the
    # flagship's gradient buffer through B3, B9, B10 and B11, each kernel's
    # device ms per launch, and the cross-process B3 at WIDE_RANKS ranks
    # over WIDE_PEER_PROCESSES processes.
    wide_world_phase(ring, ov, attn, entry_mod, make_mesh, gen, card)
    at_phase("end")

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
             fwd_errs["entry"], rows["entry"]),
            ("flash_bwd", "flash_bwd.cu", "attention.py:313",
             train_launches[1], bwd_errs["entry"], bwd_rows["entry"]),
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
             variant_errs["bidir"], variant_rows["bidir"]),
            # The wide kernels past d 256 (flash_wide.cuh in each source):
            # their launches on the D512 flagship's paths (phase 38), their
            # errors and times at its shapes (phases 3, 7, 16, 38).
            ("flash_fwd_wide", "flash_fwd.cu", "attention.py:92",
             wide["launches"][0], fwd_errs["d512_path"], rows["d512_path"]),
            ("flash_bwd_wide", "flash_bwd.cu", "attention.py:313",
             wide["launches"][1], bwd_errs["d512_path"],
             bwd_rows["d512_path"]),
            ("flash_step_wide", "flash_step.cu", "attention.py:477",
             wide["launches"][2], step_errs["d512_pathS"][0],
             wide["steps"]["flash_step"]),
            ("flash_bwd_dq_step_wide", "flash_bwd_step.cu",
             "attention.py:588", wide["launches"][3],
             step_errs["d512_pathS"][1], wide["steps"]["flash_bwd_step"]),
            ("flash_bwd_dkv_step_wide", "flash_bwd_step.cu",
             "attention.py:635", wide["launches"][3],
             step_errs["d512_pathS"][2], wide["steps"]["flash_bwd_step"])):
        no_library = kname in ("flash_step", "flash_step_wide",
                               "ring_allreduce_q8")
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
    # The cross-process instances (phase 34): B3's launches on the DDP path
    # at one process per rank, B4a's and B4b's on the FSDP path at one
    # process per rank (phase 37); times at the DDP buffer across 4
    # processes on one card (time-sliced).
    for name, replaces in (("ring_allreduce", "pallas_ring.py:63"),
                           ("ring_reduce_scatter", "pallas_ring.py:876"),
                           ("ring_allgather", "pallas_ring.py:995")):
        n, err, (ms, plain, lib, bound, bound_by) = peer_rows[name]
        if name != "ring_allreduce":
            n = fsdp_peer_launches[name]
        if None in (ms, plain, lib):
            raise AssertionError(
                f"the profiler showed no device time for the cross-process "
                f"{name}, its plain version or its library call")
        kernels.append({
            "name": f"{name}_across_processes", "route": "cuda",
            "source": "gloo_tpu_torch/csrc/ring.cu",
            "replaces": f"gloo_tpu/ops/{replaces}", "launches": n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib})
    # The cross-process instances of phase 35: B5a's and B5b's launches on
    # the fused MLP path per process, B8's on the MoE path; times at those
    # paths' shapes across 4 processes on one card (time-sliced).
    for name, source, replaces in (
            ("matmul_reduce_scatter", "overlap.cu", "overlap.py:38"),
            ("allgather_matmul", "overlap.cu", "overlap.py:205"),
            ("alltoall", "alltoall.cu", "pallas_ring.py:1109")):
        n, err, (ms, plain, lib, bound, bound_by) = tp_peer_rows[name]
        if None in (ms, plain, lib):
            raise AssertionError(
                f"the profiler showed no device time for the cross-process "
                f"{name}, its plain version or its library call")
        kernels.append({
            "name": f"{name}_across_processes", "route": "cuda",
            "source": f"gloo_tpu_torch/csrc/{source}",
            "replaces": f"gloo_tpu/ops/{replaces}", "launches": n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib})
    # The cross-process instances of phase 36: B9's, B10's and B11's
    # launches on the ring-variant path per process, the transport's on
    # the ring-flash path (20 shifts of K, V and the dK/dV carriers); times
    # at the variant buffer and a K block across 4 processes on one card
    # (time-sliced). The transport replaces no Pallas kernel: its
    # "replaces" is the XLA collective it stands for, lax.ppermute.
    for name, kname, source, replaces in (
            ("hbm", "ring_allreduce_hbm", "ring_variants.cu",
             "ops/pallas_ring.py:246"),
            ("q8", "ring_allreduce_q8", "ring_variants.cu",
             "ops/pallas_ring.py:485"),
            ("bidir", "ring_allreduce_bidir", "ring_variants.cu",
             "ops/pallas_ring.py:691"),
            ("permute", "permute", "permute.cu", "tpu/spmd.py:118")):
        n, err, (ms, plain, lib, bound, bound_by) = spp_peer_rows[name]
        if None in (ms, plain) or (lib is None and name != "q8"):
            raise AssertionError(
                f"the profiler showed no device time for the cross-process "
                f"{kname}, its plain version or its library call")
        kernels.append({
            "name": f"{kname}_across_processes", "route": "cuda",
            "source": f"gloo_tpu_torch/csrc/{source}",
            "replaces": f"gloo_tpu/{replaces}", "launches": n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
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
