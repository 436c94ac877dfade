"""Chaos demo on the PyTorch/CUDA port: inject a peer stall, watch the
watchdog name the peer, then kill the link and rebuild the context.

The counterpart of examples/example_chaos.py. Two processes over a
FileStore, over torch tensors on --device (CUDA tensors are staged through
pinned host memory). A fault schedule (docs/faults.md) is shared via
TPUCOLL_FAULT_FILE:
 1. rank 1's first bulk message to rank 0 stalls 1.5s: rank 0's armed
    watchdog fires mid-wait and names rank 1 and the blocked slot, and the
    allreduce then completes correctly (a stall is a delay, not a death);
 2. rank 1's second bulk message hard-kills the pair: both ranks fail
    loudly, rebuild through gloo_tpu_torch.resilience over the same store,
    and the evidence published by rebuild_after_failure(failed_context=...)
    lets stall_reports name the faulted rank.
The same schedule and seed give the same firing sequence
(gloo_tpu_torch.fault.report()).
    python examples/torch_chaos.py              # on the card
    python examples/torch_chaos.py --device cpu # CPU tensors
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

SIZE = 2
WORKER_TIMEOUT = 300
SCHEDULE = {"seed": 2026, "faults": [
    {"when": {"rank": 1, "peer": 0, "opcode": "data", "nth": 1,
              "min_bytes": 1024},
     "action": "stall", "ms": 1500},
    {"when": {"rank": 1, "peer": 0, "opcode": "data", "nth": 2,
              "min_bytes": 1024},
     "action": "kill"},
]}


def worker(rank, store_dir, dev):
    import gloo_tpu_torch
    from gloo_tpu_torch import fault
    from gloo_tpu_torch.resilience import rebuild_after_failure, stall_reports
    from gloo_tpu_torch.utils import merge_traces

    store = gloo_tpu_torch.FileStore(store_dir)
    ctx = gloo_tpu_torch.Context(rank, SIZE, timeout=15.0)
    ctx.connect_full_mesh(store, gloo_tpu_torch.Device())
    ctx.set_watchdog(0.3)   # anything blocked > 300ms names its peer
    ctx.trace_start()       # fired faults land in the trace as spans

    # --- act 1: the stall. The collective survives; the watchdog saw it.
    x = torch.full((4096,), float(rank + 1), device=dev)
    ctx.allreduce(x, tag=1)
    if float(x[0]) != 3.0:
        raise AssertionError(f"allreduce gave {float(x[0])}, not 3")
    if rank == 0:
        wd = ctx.metrics()["watchdog"]
        if wd["stalls"] < 1 or wd["last"]["peer"] != 1:
            raise AssertionError(f"the watchdog missed rank 1: {wd}")
        print(f"[watchdog] rank0 was blocked "
              f"{wd['last']['waited_us'] // 1000}ms on rank "
              f"{wd['last']['peer']} slot {wd['last']['slot']}", flush=True)

    # --- act 2: the kill. Fail loudly, rebuild, keep going.
    y = torch.full((4096,), float(rank + 1), device=dev)
    try:
        ctx.allreduce(y, tag=2, timeout=3.0)
        raise SystemExit("allreduce unexpectedly survived the kill")
    except gloo_tpu_torch.IoError as exc:
        print(f"rank {rank}: failed loudly: {str(exc)[:72]}", flush=True)

    new_ctx, new_rank, new_size = rebuild_after_failure(
        store, gloo_tpu_torch.Device(), old_rank=rank, old_size=SIZE,
        generation=1, settle=2.0, timeout=60.0, failed_context=ctx)
    if new_ctx is None or new_size != SIZE:
        raise AssertionError(f"rebuild gave size {new_size}")
    z = torch.full((1024,), float(new_rank + 1), device=dev)
    new_ctx.allreduce(z, tag=3)
    if float(z[0]) != 3.0:
        raise AssertionError(f"rebuilt allreduce gave {float(z[0])}")
    if rank == 0:
        # At P=2 blame is symmetric (each survivor names the other end of
        # the dead link); what matters is that the HEALTHY side's watchdog
        # evidence names the faulted rank 1.
        reports = stall_reports(store, generation=1, old_size=SIZE)
        if reports[0]["suspect"] != 1:
            raise AssertionError(f"rank 0 does not suspect 1: {reports}")
        print(f"rebuilt OK; per-survivor evidence: "
              f"{ {r: v.get('suspect') for r, v in reports.items()} }",
              flush=True)
    if rank == 1:
        print("fault firing sequence:", json.dumps(fault.report(rank=1)),
              flush=True)
    # Merge both ranks' traces (stall/kill spans included) into one
    # Perfetto timeline: each worker parks its doc in the store dir, rank 0
    # merges after the new context's barrier orders the writes.
    with open(os.path.join(store_dir, f"trace_{rank}.json"), "w") as f:
        f.write(ctx.trace_json())
    new_ctx.barrier(tag=4)
    if rank == 0:
        docs = []
        for r in range(SIZE):
            with open(os.path.join(store_dir, f"trace_{r}.json")) as f:
                docs.append(f.read())
        merged_path = os.path.join(store_dir, "chaos_trace.json")
        with open(merged_path, "w") as f:
            f.write(merge_traces(docs))
        print(f"merged chaos trace (Perfetto: labeled rank rows, fault.* "
              f"spans) -> {merged_path}", flush=True)
    new_ctx.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        # The processes split the machine's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // SIZE))
        worker(args.rank, args.store, torch.device(args.device))
        return
    from gloo_tpu_torch.device import resolve_device

    resolve_device(args.device)
    store = tempfile.mkdtemp(prefix="torch_chaos-")
    sched_path = os.path.join(store, "schedule.json")
    with open(sched_path, "w") as f:
        json.dump(SCHEDULE, f)
    env = dict(os.environ, TPUCOLL_FAULT_FILE=sched_path)
    cmd = [sys.executable, os.path.abspath(__file__), "--device",
           args.device, "--store", store]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(SIZE)]
    try:
        codes = [p.wait(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * SIZE:
        raise SystemExit(f"a rank failed: exit codes {codes}")
    print("chaos example: OK")


if __name__ == "__main__":
    main()
