#!/usr/bin/env python3
"""Host-side times of the PyTorch/CUDA port (gloo_tpu_torch) on one GPU.

    python3 host_times.py

Prints, for the gloo_tpu_torch found beside this script:
  - the host's cost per call of the wrappers, by the CPU clock over many
    back-to-back calls with no synchronization (the device keeps up, so the
    clock reads what the host spends to launch): flash_attention_fwd (B1)
    at the entry forward's shape, on the fused-qkv views the transformer
    hands it, flash_attention_bwd (B2) at the same shape with the strided
    dO of the transformer's backward, spmd.alltoall (B8) at one exchange of
    the Ulysses path, spmd.allgather (B4b) at the DDP buffer's shape, and
    B6 at the ring-flash path's first ring step: flash_attention_step (out
    of place) and, where the tree has it, flash_attention_step_into;
  - the time per call between CUDA events (chip_smoke.event_ms) of the
    entry forward, a training step, a DDP step, a dp x tp step, the
    Ulysses, ring-flash and MoE paths' forward + backward and the
    ring-flash forward alone, and the host's cost per ring-flash forward +
    backward, per ring-flash forward, per DDP step and per dp x tp step by
    the CPU clock (as above);
  - where the tree has them: the host's cost of one ``annotate`` scope
    with no profiler running (gloo_tpu_torch.utils.tracing), and the
    event ms and device time of an FSDP step, a 1F1B step and a GPipe
    forward (fsdp_train_entry, pp_entry);
  - where the tree has the host plane (gloo_tpu_torch.core), from two
    processes of this script on the card over a FileStore: the host's
    cost of one Context.allreduce of a CUDA f32 tensor of the flagship's
    gradient row (6.95 MB), whole and split into its staging copies
    (device to pinned host, synchronize, back, the event) and the native
    call on the pinned buffer, and the event ms and device ms of a
    hier_ddp_entry step (2 processes x 2 local ranks);
  - the device time (chip_smoke.device_profile) of the ring-flash path's
    forward + backward and of its forward alone, and of
    flash_attention_bwd_step per ring step at that path's shape (every
    launch of the call: B7a and B7b, or the fused kernel with its prep
    launch);
  - the device time of each path's call (the entry forward, a training,
    DDP and dp x tp step, Ulysses and MoE forward + backward, the q8
    variant's forward + backward), and per launch (chip_smoke.timed_kernel)
    of B6 at the ring-flash path's four ring steps as that path launches
    it (in place where the tree has flash_attention_step_into), of B3,
    B4a, B9, B10 and B11 at the ring-variant path's shape (B4b gathering
    its chunks back to that shape), of B10 at 64 MiB per rank, of B8 at the
    Ulysses path's first exchange, and of B5b and B5a at the fused MLP's
    up and down products (fused_mlp_entry).

It uses only the entry points, wrappers and chip_smoke helpers whose
signatures earlier versions of the port share, so that the same script
can time two trees: copy it into the other tree's root and run it there,
alternating trees within one session on one card. The last line is one
JSON object of every number printed.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (BIG_ROWS, card_line, device_profile,  # noqa: E402
                        event_ms, ring_steps, timed_kernel)


def host_us(fn, calls=500):
    """Microseconds of the host's clock per call over `calls` calls."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def bwd_step_device_ms(attn, args):
    """Device ms per ring step of flash_attention_bwd_step (every launch
    of the call, whatever the tree's kernels are) over the ring-flash
    path's four steps, with an f32 torch.randn cotangent and the lse and
    delta of the path's forward."""
    from gloo_tpu_torch.parallel import sp
    from gloo_tpu_torch.tpu import spmd

    _, q, k, v, mesh = args
    qf, steps, q_off, _ = ring_steps(sp, spmd, q, k, v, "seq", mesh, True)
    with torch.no_grad():
        out, lse = sp._ring_flash_forward(q, k, v, "seq", True, mesh)
        gen = torch.Generator(device="cuda").manual_seed(1)
        g = torch.randn(qf.shape, generator=gen, device="cuda")
        delta = (g * out.float().reshape(qf.shape)).sum(-1, keepdim=True)
        dev = device_profile(lambda: [attn.flash_attention_bwd_step(
            qf, ks, vs, g, delta, lse, q_off, k_off)
            for ks, vs, k_off in steps], 10)[0]
    return None if dev is None else dev / len(steps)


def forward_times(attn, args):
    """The ring-flash forward alone (sp._ring_flash_forward, no autograd):
    event ms, host us and device ms per call; and B6's wrappers' host us
    per call at its first ring step (each rank's own block, every row
    visible), out of place and, where the tree has it, in place."""
    from gloo_tpu_torch.parallel import sp
    from gloo_tpu_torch.tpu import spmd

    _, q, k, v, mesh = args
    qf, steps, q_off, _ = ring_steps(sp, spmd, q, k, v, "seq", mesh, True)
    bh, t, d = qf.shape
    ks, vs, k_off = steps[0]
    state = [torch.zeros((bh, t, d), device="cuda"),
             torch.full((bh, t, 1), -float("inf"), device="cuda"),
             torch.zeros((bh, t, 1), device="cuda")]
    out = {}
    with torch.no_grad():
        def fwd():
            sp._ring_flash_forward(q, k, v, "seq", True, mesh)

        out["ring_flash_forward_ms"] = event_ms(fwd, 20)
        out["ring_flash_forward_host_us"] = host_us(fwd, calls=50)
        out["ring_flash_forward_device_ms"] = device_profile(fwd, 10)[0]
        out["flash_attention_step_host_us"] = host_us(
            lambda: attn.flash_attention_step(qf, ks, vs, *state, q_off,
                                              k_off))
        if hasattr(attn, "flash_attention_step_into"):
            out["flash_attention_step_into_host_us"] = host_us(
                lambda: attn.flash_attention_step_into(qf, ks, vs, *state,
                                                       q_off, k_off))
    return out


def device_times(attn, ring, paths, variants):
    """Device ms of the paths' calls and of B6, B3, B4a, B4b, B5a, B5b, B8,
    B9, B10 and B11 per launch, as listed in the module's docstring."""
    from gloo_tpu_torch.entry import fused_mlp_entry
    from gloo_tpu_torch.ops import overlap as ov
    from gloo_tpu_torch.parallel import sp
    from gloo_tpu_torch.tpu import make_mesh, spmd

    out = {}
    for key, (fn, args) in paths.items():
        out[f"{key}_device_ms"] = device_profile(lambda: fn(*args), 5)[0]
    _, q, k, v, mesh = paths["ring_flash_path"][1]
    qf, steps, q_off, _ = ring_steps(sp, spmd, q, k, v, "seq", mesh, True)
    bh, t, d = qf.shape
    state = (torch.zeros((bh, t, d), device="cuda"),
             torch.full((bh, t, 1), -float("inf"), device="cuda"),
             torch.zeros((bh, t, 1), device="cuda"))
    states = []
    for ks, vs, k_off in steps:
        states.append([x.clone() for x in state])
        state = attn.flash_attention_step(qf, ks, vs, *state, q_off, k_off)
    step = getattr(attn, "flash_attention_step_into",
                   attn.flash_attention_step)
    _, x, vmesh = variants["hbm"][1]
    big = torch.randn((x.shape[0], BIG_ROWS, x.shape[2]), device="cuda")
    with torch.no_grad():
        out["b6_ms"] = timed_kernel(
            "B6 per launch at the ring-flash path's ring steps",
            lambda: [step(qf, ks, vs, *st, q_off, k_off)
                     for (ks, vs, k_off), st in zip(steps, states)],
            "flash_step_")
        for name, label in (("allreduce", "ring_kernel"),
                            ("allreduce_hbm", "hbm_kernel"),
                            ("allreduce_q8", "q8_kernel"),
                            ("allreduce_bidir", "bidir_kernel")):
            fn = getattr(ring, f"ring_{name}")
            out[f"ring_{name}_ms"] = timed_kernel(
                f"ring_{name} at the ring-variant path's shape",
                lambda fn=fn: fn(x, "data", vmesh), label)
        out["ring_allreduce_q8_64mib_ms"] = timed_kernel(
            "ring_allreduce_q8 at 64 MiB per rank",
            lambda: ring.ring_allreduce_q8(big, "data", vmesh), "q8_kernel")
        chunk = x[:, :x.shape[1] // x.shape[0]].contiguous()
        out["ring_reduce_scatter_ms"] = timed_kernel(
            "ring_reduce_scatter at the ring-variant path's shape",
            lambda: ring.ring_reduce_scatter(x, "data", vmesh), "ring_kernel")
        out["ring_allgather_ms"] = timed_kernel(
            "ring_allgather to the ring-variant path's shape",
            lambda: ring.ring_allgather(chunk, "data", vmesh), "ring_kernel")
        seq = make_mesh({"seq": 4}, devices=[x.device] * 4)
        xu = torch.randn((4, 2, 4, 1024, 64), device="cuda").to(
            torch.bfloat16)
        out["alltoall_ms"] = timed_kernel(
            "alltoall at the Ulysses path's first exchange",
            lambda: spmd.alltoall(xu, "seq", 1, 2, mesh=seq),
            "alltoall_kernel")
        _, (xm, w_up, w_down, _, mmesh) = fused_mlp_entry()
        hidden = ov.allgather_matmul_fwd(xm, w_up, "model", mmesh)[0]
        out["allgather_matmul_ms"] = timed_kernel(
            "allgather_matmul at the fused MLP's up product",
            lambda: ov.allgather_matmul_fwd(xm, w_up, "model", mmesh),
            "ag_matmul_kernel")
        out["matmul_reduce_scatter_ms"] = timed_kernel(
            "matmul_reduce_scatter at the fused MLP's down product",
            lambda: ov.matmul_reduce_scatter(hidden, w_down, "model", mmesh),
            "matmul_rs_kernel")
    fn, args = variants["q8"]
    out["q8_variant_path_device_ms"] = device_profile(lambda: fn(*args),
                                                      10)[0]
    return out


def parallel_times():
    """annotate's host us with no profiler running, and the FSDP and
    pipeline paths' event ms and device ms, where the tree has them."""
    from gloo_tpu_torch import entry as entry_mod

    out = {}
    try:
        from gloo_tpu_torch.utils.tracing import annotate
    except ImportError:
        return out

    def scope():
        with annotate("gloo_tpu.allreduce"):
            pass

    out["annotate_host_us"] = host_us(scope, calls=20000)
    step, (sharded, batch) = entry_mod.fsdp_train_entry()
    pp_paths = entry_mod.pp_entry()
    for key, fn in (("fsdp_step", lambda: step(sharded, batch)),
                    ("1f1b_step", lambda: pp_paths["1f1b"][0](
                        *pp_paths["1f1b"][1])),
                    ("gpipe_forward", lambda: pp_paths["gpipe"][0](
                        *pp_paths["gpipe"][1]))):
        out[f"{key}_ms"] = event_ms(fn, 10)
        out[f"{key}_device_ms"] = device_profile(fn, 5)[0]
    return out


def host_plane_worker(rank, store):
    """One of the two processes of host_plane_times: its numbers."""
    from gloo_tpu_torch import core
    from gloo_tpu_torch.entry import hier_ddp_entry

    step, (replicas, optimizers, batch) = hier_ddp_entry(rank, 2, store)
    ctx = step.group.ctx
    numel = sum(p.numel() for p in replicas[0].parameters())
    out = {}

    def collective_us(fn, calls=20):
        fn()
        ctx.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    row = torch.randn(numel, device="cuda")
    host = torch.empty(numel, pin_memory=True)
    dev = row.device

    def copies():
        core._to_host(host, row)
        core._sync(dev)
        core._to_device(row, host)
        core._record(dev)

    out["ctx_allreduce_cuda_host_us"] = collective_us(
        lambda: ctx.allreduce(row, tag=0x71))
    out["ctx_allreduce_staging_host_us"] = host_us(copies, calls=20)
    out["ctx_allreduce_native_host_us"] = collective_us(
        lambda: ctx.allreduce(host, tag=0x72))
    out["row_bytes"] = numel * 4

    def once():
        step(replicas, optimizers, batch)

    ctx.barrier()
    out["hier_step_ms"] = event_ms(once, 10)
    ctx.barrier()
    out["hier_step_device_ms"] = device_profile(once, 5, sessions=1)[0]
    ctx.barrier()
    ctx.close()
    return out


def host_plane_times():
    """host_plane_worker in two processes of this script; rank 0's numbers
    and rank 1's step times. {} when the tree has no host plane."""
    import subprocess
    import tempfile

    try:
        import gloo_tpu_torch.core  # noqa: F401
    except ImportError:
        return {}
    store = tempfile.mkdtemp(prefix="host_times-")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--worker", str(r), store],
                              stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        raise SystemExit(f"host_times: a host-plane worker failed "
                         f"{[p.returncode for p in procs]}")
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    out = dict(res[0])
    out["hier_step_ms_rank1"] = res[1]["hier_step_ms"]
    out["hier_step_device_ms_rank1"] = res[1]["hier_step_device_ms"]
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("host_times: no CUDA device is available")
    from gloo_tpu_torch import _build
    from gloo_tpu_torch.entry import (ddp_train_entry, dp_tp_train_entry,
                                      entry, ep_entry, ring_variants_entry,
                                      sp_entry, train_entry)
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.tpu import make_mesh, spmd

    card = card_line()
    print(f"card: {card}")
    _build.build()
    result = {"card": card}

    # B1's wrapper at the entry forward's shape: (b, h, t, d) = (8, 4, 128,
    # 64) bf16, causal, as views of one (b, t, 3 h d) projection.
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, t, d = 8, 4, 128, 64
    qkv = torch.randn((b, t, 3 * h * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
               .transpose(1, 2) for i in range(3))
    do = torch.randn((b, t, h, d), generator=gen,
                     device="cuda").to(torch.bfloat16).transpose(1, 2)
    with torch.inference_mode():
        result["flash_attention_fwd_host_us"] = host_us(
            lambda: attn.flash_attention_fwd(q, k, v, True))
        out, lse = attn.flash_attention_fwd(q, k, v, True)
        result["flash_attention_bwd_host_us"] = host_us(
            lambda: attn.flash_attention_bwd(q, k, v, out, lse, do, True))

    # B8 through spmd.alltoall at the Ulysses path's first exchange: each
    # of 4 ranks' (b, h, t_local, d) = (2, 4, 1024, 64) bf16, heads split,
    # sequence gathered.
    dev = torch.device("cuda")
    mesh = make_mesh({"seq": 4}, devices=[dev] * 4)
    x = torch.randn((4, 2, 4, 1024, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        result["spmd_alltoall_host_us"] = host_us(
            lambda: spmd.alltoall(x, "seq", 1, 2, mesh=mesh))

    # B4b through spmd.allgather at the DDP buffer's shape: 4 ranks of
    # 434,500 f32.
    data = make_mesh({"data": 4}, devices=[dev] * 4)
    grads = torch.randn((4, 434500), generator=gen, device="cuda")
    with torch.no_grad():
        result["spmd_allgather_host_us"] = host_us(
            lambda: spmd.allgather(grads, "data", mesh=data))

    sp_paths = sp_entry()
    paths = {"entry_forward": entry(), "training_step": train_entry(),
             "ddp_step": ddp_train_entry(), "dp_tp_step": dp_tp_train_entry(),
             "ulysses_path": sp_paths["ulysses"],
             "ring_flash_path": sp_paths["ring_flash"], "moe_path": ep_entry()}
    for key, (fn, args) in paths.items():
        result[f"{key}_ms"] = event_ms(lambda: fn(*args),
                                       20 if key in ("entry_forward",
                                                     "training_step") else 10)
    for key in ("ddp_step", "dp_tp_step", "ring_flash_path"):
        fn, args = paths[key]
        result[f"{key}_host_us"] = host_us(lambda: fn(*args), calls=30)
    result["ring_flash_host_us"] = result.pop("ring_flash_path_host_us")
    result.update(parallel_times())
    result["bwd_step_device_ms"] = bwd_step_device_ms(attn, args)
    result.update(forward_times(attn, args))
    result.update(device_times(attn, ring, paths, ring_variants_entry()))
    result.update(host_plane_times())

    for key, val in result.items():
        print(f"{key}: {val}")
    print(json.dumps(result))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(host_plane_worker(int(sys.argv[2]), sys.argv[3])))
    else:
        main()
