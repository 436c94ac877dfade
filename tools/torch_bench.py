#!/usr/bin/env python
"""Device-plane benchmark of the PyTorch/CUDA port (gloo_tpu_torch).

The counterpart of tools/tpu_bench.py, with its options, ops, header and
columns. It times, over a world of ranks on one card:
  - the mesh collectives of gloo_tpu_torch.tpu.spmd (allreduce on the ring
    kernel B3, allgather B4b, reduce_scatter B4a, alltoall B8, ppermute in
    plain torch), the port's counterpart of the XLA path;
  - the ring kernels themselves: pallas_ring is B3 (ring_allreduce),
    pallas_ring_hbm B9 (ring_allreduce_hbm);
  - the flash kernels: flash_attention (B1) and flash_bwd (B1 + B2 through
    autograd), the last column GFLOP/s;
  - the collective matmuls (B5a matmul_rs, B5b ag_matmul) beside a plain
    torch.matmul of the same world product;
  - tp_step: the Megatron-SP MLP pair's training step on B5b and B5a
    against the unfused step of the same FLOPs, and the port's fused/
    unfused dispatcher against the measured winner.

    python tools/torch_bench.py --op allreduce --elements 1024,1048576
    python tools/torch_bench.py --op all
    python tools/torch_bench.py --op all --device cpu --elements 1024,65536

On the card each call is timed between a pair of CUDA events on the
current stream, the device synchronised once after the samples, and min,
p50 and p99 come from those events. With --device cpu the kernels' plain
PyTorch versions run, timed on the host clock, at the reference's
interpreter sizes (t <= 256, m and k <= 256, tp_step 256^3): a functional
smoke whose numbers say nothing about a card. A row that fails prints
"skipped: <error>" and the tool exits 1.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

AXIS = "data"
COLLECTIVES = ("allreduce", "allgather", "reduce_scatter", "alltoall",
               "ppermute", "pallas_ring", "pallas_ring_hbm")
OPS = COLLECTIVES + ("flash_attention", "flash_attention_bwd", "overlap",
                     "tp_step")
# Calls timed back to back between one event pair to size the run.
PROBE_CALLS = 3
MAX_SAMPLES = 100_000
# The reference's interpreter clamps, the sizes of a --device cpu run.
CPU_FLASH_T = 256
CPU_OVERLAP = 256
CPU_TP = 256
FLASH_H, FLASH_D = 8, 128
TP_LR = 1e-3


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--op", default="allreduce", choices=OPS + ("all",))
    parser.add_argument("--tp-shape", default="2048x4096x4096",
                        help="MxDxF for --op tp_step (seq x model x ffn)")
    parser.add_argument("--elements", default="1024,65536,1048576,16777216")
    parser.add_argument("--min-time", type=float, default=1.0)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--flash-blocks", default=None,
                        help="BQxBK pairs of the reference's sweep; the "
                             "Hopper kernels fix their tiles, so the rows "
                             "run once at them")
    parser.add_argument("--overlap-shapes", default="4096x2048,2048x4096,"
                        "4096x4096",
                        help="MxK list for --op overlap (cols==K)")
    parser.add_argument("--overlap-ranks", type=int, default=8,
                        help="ranks of the ring for --op overlap and tp_step")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain versions)")
    parser.add_argument("--ranks", type=int, default=8,
                        help="size of the world of ranks on the one device")
    return parser.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True).stdout.strip()


class Bench:
    """The run's device, its timing rule and its record of rows: every
    measured row goes to `rows` (dicts), every failed one to `failed`."""

    def __init__(self, args, dev: torch.device, rows: list):
        self.args, self.dev, self.rows, self.failed = args, dev, rows, []
        self.on_card = dev.type == "cuda"

    def samples(self, fn) -> list:
        """Sorted seconds per call of fn after the warm-up: CUDA events
        around each call on the card (one synchronise after the last),
        the host clock on the CPU; min_time's worth of calls."""
        for _ in range(max(1, self.args.warmup)):
            fn()
        if not self.on_card:
            out, t_start = [], time.perf_counter()
            while not out or time.perf_counter() - t_start < \
                    self.args.min_time:
                t0 = time.perf_counter()
                fn()
                out.append(time.perf_counter() - t0)
            return sorted(out)
        torch.cuda.synchronize(self.dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(PROBE_CALLS):
            fn()
        end.record()
        end.synchronize()
        per = max(start.elapsed_time(end) / 1e3 / PROBE_CALLS, 1e-7)
        count = min(MAX_SAMPLES, max(1, math.ceil(self.args.min_time / per)))
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(count)]
        for s, e in pairs:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize(self.dev)
        return sorted(s.elapsed_time(e) / 1e3 for s, e in pairs)

    def fail(self, op, what, exc):
        traceback.print_exception(exc, file=sys.stderr)
        print(f"{op:>16} {'-':>12} {what:>12}   skipped: {str(exc)[:50]}")
        self.failed.append((op, what, repr(exc)))

    def row(self, op, nbytes, elements, s, work, extra=""):
        """Prints and records one row; `work` is bytes for a collective,
        FLOPs for the rest (the rate column then reads GFLOP/s)."""
        p = _percentiles(s)
        rate = work / p[1] / 1e9
        print(f"{op:>16} {nbytes:>12} {elements:>12} {p[0] * 1e6:>9.1f} "
              f"{p[1] * 1e6:>9.1f} {p[2] * 1e6:>9.1f} {rate:>12.3f} "
              f"{len(s):>7}{extra}")
        self.rows.append({"op": op, "bytes": nbytes, "elements": elements,
                          "min_us": p[0] * 1e6, "p50_us": p[1] * 1e6,
                          "p99_us": p[2] * 1e6, "rate": rate,
                          "iters": len(s)})
        return rate


def _percentiles(s):
    """(min, p50, p99) of sorted samples, the reference's indexing."""
    return tuple(s[min(len(s) - 1, int(q * len(s)))] for q in (0, .5, .99))


def collective(op, elements, n, mesh, dev):
    """(fn, bytes per rank) of one collective row, the reference's
    operands: ones (n, elements / n) f32 for the spmd rows, (n, rows, 128)
    f32 for the ring kernels, with its row rounding."""
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.tpu import spmd

    per = max(elements // n, 1)
    if op in ("pallas_ring", "pallas_ring_hbm"):
        kernel = ring.ring_allreduce if op == "pallas_ring" \
            else ring.ring_allreduce_hbm
        rows = max(per // 128, n)
        rows -= rows % n or 0
        rows = max(rows, n)
        if op == "pallas_ring_hbm" and (rows // n) > 256:
            rows -= rows % (256 * n)
        x = torch.ones((n, rows, 128), dtype=torch.float32, device=dev)
        return (lambda: kernel(x, AXIS, mesh)), rows * 128 * 4
    x = torch.ones((n, per), dtype=torch.float32, device=dev)
    fns = {
        "allreduce": lambda: spmd.allreduce(x, AXIS, mesh=mesh),
        "allgather": lambda: spmd.allgather(x, AXIS, mesh=mesh),
        "reduce_scatter": lambda: spmd.reduce_scatter(
            x.view(n, n, -1), AXIS, mesh=mesh),
        "alltoall": lambda: spmd.alltoall(x.view(n, n, -1), AXIS, mesh=mesh),
        "ppermute": lambda: spmd.shift(x, AXIS, 1, mesh=mesh),
    }
    return fns[op], per * 4


def bench_collectives(bench, ops, elements_list, n, mesh):
    for op in ops:
        for elements in elements_list:
            try:
                fn, nbytes = collective(op, elements, n, mesh, bench.dev)
                s = bench.samples(fn)
            except Exception as exc:  # noqa: BLE001 - row reports, exit 1
                bench.fail(op, elements, exc)
                continue
            bench.row(op, nbytes, elements, s, nbytes)


def flash_counts(h, t, d, backward):
    """(FLOPs, bytes) of one flash row, the reference's counts
    (tpu_bench.py:248-253): causal forward 2 h (t^2 / 2) d 2, the backward
    3.5 times that; q, k, v read, and for the backward dO, O, lse and delta
    read and three f32 gradients written."""
    fwd_flops = 2 * h * (t * t // 2) * d * 2
    flops = int(fwd_flops * 3.5) if backward else fwd_flops
    nbytes = 3 * h * t * d * 2
    if backward:
        nbytes = nbytes + 2 * h * t * d * 2 + 3 * h * t * d * 4
    return flops, nbytes


def flash_t(elements, on_card):
    t = max(elements // (FLASH_H * FLASH_D) // 128 * 128, 128)
    return t if on_card else min(t, CPU_FLASH_T)


def bench_flash(bench, elements_list, backward):
    """B1 (and B2 through autograd for flash_bwd) at (1, 8, t, 128) bf16,
    causal, t from the element count as in the reference."""
    from gloo_tpu_torch.ops import flash_attention

    h, d = FLASH_H, FLASH_D
    label = "flash_bwd" if backward else "flash_attention"
    print(f"# {label} rows: the last column is GFLOP/s, not GB/s")
    gen = torch.Generator(device=bench.dev).manual_seed(0)
    seen = set()
    for elements in elements_list:
        t = flash_t(elements, bench.on_card)
        if t in seen:  # small elements values clamp to the same shape
            continue
        seen.add(t)
        try:
            q, k, v = (torch.randn((1, h, t, d), generator=gen,
                                   device=bench.dev).to(torch.bfloat16)
                       .requires_grad_(backward) for _ in "qkv")

            def step():
                out = flash_attention(q, k, v, causal=True)
                if backward:
                    torch.autograd.grad(out.float().square().sum(),
                                        (q, k, v))
                return out

            with torch.set_grad_enabled(backward):
                s = bench.samples(step)
        except Exception as exc:  # noqa: BLE001 - row reports, exit 1
            bench.fail(label, elements, exc)
            continue
        flops, nbytes = flash_counts(h, t, d, backward)
        bench.row(label, nbytes, h * t * d, s, flops)


def overlap_shapes(args, on_card):
    shapes = []
    for spec in args.overlap_shapes.split(","):
        m, k = (int(v) for v in spec.split("x"))
        if not on_card:
            m, k = min(m, CPU_OVERLAP), min(k, CPU_OVERLAP)
        if (m, k) not in shapes:  # the CPU clamp collapses shapes
            shapes.append((m, k))
    return shapes


def bench_overlap(bench):
    """plain_dot, matmul_rs (B5a) and ag_matmul (B5b) over a ring of
    --overlap-ranks ranks on the device, on measure_fused_ratio's operands;
    every row counts the FLOPs the device does across all ranks."""
    from gloo_tpu_torch.ops import overlap as ov
    from gloo_tpu_torch.parallel.tp import PROBE_AXIS, fused_ratio_operands

    v = bench.args.overlap_ranks
    print(f"# overlap: a ring of V={v} ranks on one device, x (V, M, K), "
          f"w (V, K, K) bf16; GFLOP/s counts V * 2*M*K*K, what the device "
          f"does across all ranks, in all three rows; last columns are "
          f"GFLOP/s, iters and the fused/plain ratio")
    for m, k in overlap_shapes(bench.args, bench.on_card):
        chunk = m // v
        if chunk == 0 or chunk % 8:
            bench.fail("overlap", f"{m}x{k}", ValueError(
                f"M/V={m}/{v} not a usable chunk"))
            continue
        flops = v * 2 * m * k * k
        try:
            mesh, x, w = fused_ratio_operands(m, k, v, torch.bfloat16,
                                              bench.dev)
        except Exception as exc:  # noqa: BLE001 - row reports, exit 1
            bench.fail("overlap", f"{m}x{k}", exc)
            continue
        x_rows = x[:, :chunk].contiguous()
        variants = (("plain_dot", lambda: torch.matmul(x, w)),
                    ("matmul_rs", lambda: ov.matmul_reduce_scatter(
                        x, w, PROBE_AXIS, mesh)),
                    ("ag_matmul", lambda: ov.allgather_matmul(
                        x_rows, w, PROBE_AXIS, mesh)))
        rates = {}
        for name, fn in variants:
            try:
                with torch.no_grad():
                    s = bench.samples(fn)
            except Exception as exc:  # noqa: BLE001 - row reports, exit 1
                bench.fail(name, f"{m}x{k}", exc)
                continue
            p50 = _percentiles(s)[1]
            rate = flops / p50 / 1e9
            ratio = f"{rate / rates['plain_dot']:>8.2f}" \
                if name != "plain_dot" and "plain_dot" in rates \
                else f"{'-':>8}"
            rates[name] = bench.row(name, m * k * 2, f"{m}x{k}", s, flops,
                                    f" {ratio}")


class _AgMm(torch.autograd.Function):
    """gather(x) @ w on B5b; its VJP dx on B5a (the dual kernel), dw from
    the gathered x that B5b returns."""

    @staticmethod
    def forward(ctx, x, w, mesh):
        from gloo_tpu_torch.ops import overlap as ov

        y, gx = ov.allgather_matmul_fwd(x, w, AXIS, mesh)
        ctx.save_for_backward(gx, w)
        ctx.mesh = mesh
        return y

    @staticmethod
    def backward(ctx, g):
        from gloo_tpu_torch.ops import overlap as ov

        gx, w = ctx.saved_tensors
        g = g.contiguous()
        dx = ov.matmul_reduce_scatter(g, w.transpose(1, 2), AXIS, ctx.mesh)
        return dx, torch.matmul(gx.transpose(1, 2), g), None


class _RsMm(torch.autograd.Function):
    """reduce_scatter(a @ w) on B5a; its VJP da on B5b (the dual kernel),
    dw from the gathered cotangent that B5b returns (tpu_bench.py's
    make_fused_pair)."""

    @staticmethod
    def forward(ctx, a, w, mesh):
        from gloo_tpu_torch.ops import overlap as ov

        ctx.save_for_backward(a, w)
        ctx.mesh = mesh
        return ov.matmul_reduce_scatter(a, w, AXIS, mesh)

    @staticmethod
    def backward(ctx, g):
        from gloo_tpu_torch.ops import overlap as ov

        a, w = ctx.saved_tensors
        da, gfull = ov.allgather_matmul_fwd(g.contiguous(),
                                            w.transpose(1, 2), AXIS,
                                            ctx.mesh)
        return da, torch.matmul(a.transpose(1, 2), gfull), None


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _sgd(leaves, grads, lr):
    return [(p - lr * g.float()).to(p.dtype) for p, g in zip(leaves, grads)]


def tp_steps(m, d, f, v, dev):
    """{name: step()} of the Megatron-SP MLP pair's training step (forward,
    backward, SGD on both weights and on x, as tpu_bench.py's make_step):
    "unfused_step" in plain torch.matmul on the unsharded x (M, D), up
    (D, F), down (F, D); "fused_step" over a ring of V ranks, rank r
    holding rows r of x (V, M / V, D) and the F / V column shard of up
    (V, D, F / V) and of down (V, F / V, D), up on B5b and down on B5a,
    their VJPs on the dual kernels. Both do 2 M D F 6 FLOPs."""
    from gloo_tpu_torch.tpu import make_mesh

    bf16 = torch.bfloat16
    mesh = make_mesh({AXIS: v}, devices=[dev] * v)
    full = {"x": torch.ones((m, d), dtype=bf16, device=dev),
            "up": torch.full((d, f), 1.0 / d, dtype=bf16, device=dev),
            "down": torch.full((f, d), 1.0 / f, dtype=bf16, device=dev)}
    shard = {"x": torch.ones((v, m // v, d), dtype=bf16, device=dev),
             "up": torch.full((v, d, f // v), 1.0 / d, dtype=bf16,
                              device=dev),
             "down": torch.full((v, f // v, d), 1.0 / f, dtype=bf16,
                                device=dev)}

    def unfused_loss(x, up, down):
        h = _gelu(torch.matmul(x, up))
        return torch.matmul(h, down).float().square().mean()

    def fused_loss(x, up, down):
        h = _gelu(_AgMm.apply(x, up, mesh))
        return _RsMm.apply(h, down, mesh).float().square().mean()

    def make_step(state, loss_fn):
        def step():
            leaves = [state[k].detach().requires_grad_()
                      for k in ("x", "up", "down")]
            with torch.enable_grad():
                grads = torch.autograd.grad(loss_fn(*leaves), leaves)
            with torch.no_grad():
                # The tiny x update keeps dx live, as a layer below would.
                x = (leaves[0] - 1e-6 * grads[0].float()).to(bf16)
                up, down = _sgd(leaves[1:], grads[1:], TP_LR)
            state.update(x=x, up=up, down=down)
            return up
        return step

    return {"unfused_step": make_step(full, unfused_loss),
            "fused_step": make_step(shard, fused_loss)}


def bench_tp_step(bench):
    from gloo_tpu_torch.parallel.tp import (estimate_comm_share,
                                            use_fused_overlap)

    v = bench.args.overlap_ranks
    m, d, f = (int(x) for x in bench.args.tp_shape.split("x"))
    if not bench.on_card:
        m = d = f = CPU_TP
    flops = 2 * m * d * f * 6
    print(f"# tp_step: Megatron-SP MLP pair, M={m} D={d} F={f}, a ring of "
          f"V={v} ranks on one device (F/V column shards); full train step "
          f"(fwd+bwd+sgd) beside the unfused step of the same {flops} "
          f"FLOPs in plain torch.matmul; p50 us/step, GFLOP/s and ratio")
    chunk = m // v
    if chunk == 0 or chunk % 8 or f % v:
        bench.fail("tp_step", bench.args.tp_shape, ValueError(
            f"M/V={m}/{v} or F/V={f}/{v} not a usable shard"))
        return
    try:
        steps = tp_steps(m, d, f, v, bench.dev)
    except Exception as exc:  # noqa: BLE001 - row reports, exit 1
        bench.fail("tp_step", bench.args.tp_shape, exc)
        return
    rates = {}
    for name, step in steps.items():
        try:
            s = bench.samples(step)
        except Exception as exc:  # noqa: BLE001 - row reports, exit 1
            bench.fail(name, bench.args.tp_shape, exc)
            continue
        lo, p50, hi = _percentiles(s)
        rates[name] = flops / p50 / 1e9
        ratio = "" if name == "unfused_step" or "unfused_step" not in rates \
            else f" {rates[name] / rates['unfused_step']:>8.2f}"
        print(f"{name:>16} {p50 * 1e6:>12.1f} us/step {rates[name]:>12.1f} "
              f"GFLOP/s{ratio}  (min {lo * 1e6:.1f} us, p99 "
              f"{hi * 1e6:.1f} us, {len(s)} steps)")
        bench.rows.append({"op": name, "bytes": None,
                           "elements": bench.args.tp_shape,
                           "min_us": lo * 1e6, "p50_us": p50 * 1e6,
                           "p99_us": hi * 1e6, "rate": rates[name],
                           "iters": len(s)})
    if len(rates) < 2:
        return
    # One device: the ring's hops cost no link time, so the collective's
    # share of the unfused step is 0 and the rule fuses only where the
    # fused kernels out-run plain products (ratio > 1).
    measured = rates["fused_step"] / rates["unfused_step"]
    share = estimate_comm_share(m, d, f // v, v, link_bytes_per_s=math.inf,
                                flops_per_s=rates["unfused_step"] * 1e9)
    picks_fused = use_fused_overlap(m, d, f // v, v, comm_share=share,
                                    ratio=measured)
    forced = os.environ.get("TPUCOLL_TP_OVERLAP", "auto") not in ("auto", "")
    print(f"# dispatch: use_fused_overlap at share {share:.2f} (one device) "
          f"and the measured ratio {measured:.2f} (flip at comm>"
          f"{1 - measured:.0%}) picks "
          f"{'fused' if picks_fused else 'unfused'}"
          f"{' (forced by TPUCOLL_TP_OVERLAP)' if forced else ''} -> "
          f"{'MATCHES' if picks_fused == (measured > 1.0) else 'CONTRADICTS'}"
          f" measured winner")


def main(argv=None, rows=None) -> int:
    """Runs the benchmark; returns the exit status (1 if any row failed).
    Each measured row is appended to `rows` as a dict when it is given."""
    from gloo_tpu_torch.device import resolve_device
    from gloo_tpu_torch.tpu import make_mesh

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    bench = Bench(args, dev, [] if rows is None else rows)
    n = args.ranks
    mesh = make_mesh({AXIS: n}, devices=[dev] * n)
    if bench.on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"# card: {card_line()}")
        note = " (world of ranks on one card)"
    else:
        note = (" (world of ranks on one device; CPU: the kernels' plain "
                "versions on the host clock at clamped sizes, a functional "
                "smoke only)")
    print(f"# torch_bench devices={n}x{dev} mesh={dict(mesh.shape)}{note}")
    print(f"{'op':>16} {'bytes':>12} {'elements':>12} {'min(us)':>9} "
          f"{'p50(us)':>9} {'p99(us)':>9} {'algbw(GB/s)':>12} {'iters':>7}")
    ops = list(OPS) if args.op == "all" else [args.op]
    elements_list = [int(e) for e in args.elements.split(",")]
    bench_collectives(bench, [o for o in ops if o in COLLECTIVES],
                      elements_list, n, mesh)
    flash = [o for o in ops if o.startswith("flash_attention")]
    if flash and args.flash_blocks:
        print("# --flash-blocks skipped: the Hopper kernels fix their tiles")
    for mode in flash:
        bench_flash(bench, elements_list, backward=mode.endswith("bwd"))
    if "overlap" in ops:
        bench_overlap(bench)
    if "tp_step" in ops:
        bench_tp_step(bench)
    if bench.failed:
        print(f"# {len(bench.failed)} row(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
