#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (gloo_tpu_torch) on one GPU and checks it.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from gloo_tpu_torch/csrc (set-up time);
  3. hold each kernel against its plain PyTorch version on the card: the
     flash forward, and the flash backward (in f32 also against autograd
     through the materialized-scores reference);
  4. the serving path: the flagship forward of gloo_tpu_torch.entry at full
     width plus greedy serving, with the kernels' launch counts read around
     it, and its logits against the same model on the CPU (plain attention);
  5. exact greedy-decode parity on an f32 copy of the model;
  6. the training path: 5 steps of gloo_tpu_torch.entry.train_step at full
     width, with the launch counts read around them, a falling loss, and
     the first step's loss and gradients against the same model on the CPU;
  7. times of each kernel, its plain version and the library yardstick,
     and of the forward and the training step.
The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or gloo_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import torch
import torch.nn.functional as F

# Tolerances of a kernel against its plain version, as (rtol, atol) in
# max|a - b| <= atol + rtol * |b|. bf16: p and out are rounded to bf16, so a
# last-bit difference in the f32 sums before a rounding can flip one bf16
# ulp (2**-8 relative) of p and then of out; two ulps are allowed. f32: sums
# in another order. lse is f32 in both.
KERNEL_TOL = {
    torch.bfloat16: {"out": (1.6e-2, 1e-2), "lse": (1e-5, 1e-4)},
    torch.float32: {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-4)},
}
# The backward kernel against its plain version, (rtol, atol) as above but
# with atol relative to the largest |plain| of each gradient. bf16: p and ds
# are rounded to bf16 inside the sums and dq, dk, dv at the end, so a
# flipped ulp of one term or of the result moves an element by up to about
# one ulp of the largest terms (the same bound holds the plain version
# against JAX on the CPU). f32: sums in another order, dq's atomics in an
# order that changes from run to run.
BWD_TOL = {torch.bfloat16: (1.6e-2, 8e-3), torch.float32: (1e-4, 1e-5)}
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

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (name, b, h, h_kv, t, d, dtype, causal). The first is the shape the
# entry forward and the training step give the kernels.
FLASH_CASES = [
    ("entry", 8, 4, 4, 128, 64, torch.bfloat16, True),
    ("t1024_d128_causal", 4, 8, 8, 1024, 128, torch.bfloat16, True),
    ("t1024_d128_full", 4, 8, 8, 1024, 128, torch.bfloat16, False),
    ("gqa_h8_kv2", 2, 8, 2, 256, 64, torch.bfloat16, True),
    ("ragged_t200", 2, 4, 4, 200, 128, torch.bfloat16, True),
    ("f32_t256", 2, 4, 4, 256, 64, torch.float32, True),
    ("f32_d128_gqa_t100_full", 2, 4, 2, 100, 128, torch.float32, False),
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


def device_profile(fn, iters=20):
    """Per-call device time of fn from torch.profiler (CUPTI): (total ms or
    None where the trace shows no device time, [(ms, calls, name)] per
    kernel name, longest first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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


def timed(label, fn, iters=20):
    """Device ms per call from the profiler, or None where its trace shows
    no device time; the per-call time between CUDA events is printed
    beside it and never stands in for it."""
    dev = device_profile(fn, iters)[0]
    ev = event_ms(fn, max(5, iters))
    shown = "not measured" if dev is None else f"{dev:.6f} ms"
    print(f"  {label}: device {shown}, per call (events) {ev:.6f} ms")
    return dev


def timed_kernel(label, fn, name):
    """Device ms of one call of fn in the kernels whose names contain
    `name` (those of one CUDA source, each launched once per call), or None
    where the trace shows none. Each kernel counts its mean time per
    launch, so a record the trace drops does not lower the time."""
    rows = device_profile(fn)[1]
    mine = [r for r in rows if name in r[2]]
    dev = sum(r[0] / r[1] for r in mine) if mine else None
    shown = "not measured" if dev is None else f"{dev:.6f} ms"
    seen = "+".join(f"{r[1]:g}" for r in mine)
    print(f"  {label}: device {shown} ({seen or 0} launches seen per call)")
    return dev


def check_bwd(attn, name, b, h, h_kv, t, d, dtype, causal, gen):
    """The backward kernel against its plain version at one shape, on B1's
    own out and lse; in f32 also against autograd through the
    materialized reference. Returns (max abs error over dq, dk, dv,
    whether every check held)."""
    fused = dtype == torch.bfloat16
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")

    from gloo_tpu_torch import _build
    from gloo_tpu_torch.entry import ENTRY_CONFIG, entry, train_entry
    from gloo_tpu_torch.entry import forward as entry_forward
    from gloo_tpu_torch.models import Transformer
    from gloo_tpu_torch.ops import attention as attn

    # Phase 1: the card.
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build every kernel (set-up time, not part of any metric).
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
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
                           fused=dtype == torch.bfloat16)
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
        fused = dtype == torch.bfloat16
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
        fused = dtype == torch.bfloat16
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
                f"{name} bwd kernel",
                lambda: attn.flash_attention_bwd(q, k, v, out, lse, do,
                                                 causal), "flash_bwd")
            timed(f"{name} bwd op (autograd: delta, kernel, dq pass)",
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

    kernels = []
    for kname, source, line, n, err, (ms, plain, lib, bound, bound_by) in (
            ("flash_fwd", "flash_fwd.cu", 92, launches, entry_err,
             rows["entry"]),
            ("flash_bwd", "flash_bwd.cu", 313, train_launches[1],
             entry_bwd_err, bwd_rows["entry"])):
        if None in (ms, plain, lib):
            raise AssertionError(
                f"the profiler showed no device time for {kname}'s kernel, "
                f"plain or library call at the entry shape")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"gloo_tpu_torch/csrc/{source}",
            "replaces": f"gloo_tpu/ops/attention.py:{line}",
            "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
