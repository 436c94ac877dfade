"""Observability tour on the PyTorch/CUDA port: tracer spans, metrics
registry, Prometheus text and the straggler watchdog, on a 2-rank
host-plane group in one process, over torch tensors (CUDA tensors are
staged through pinned host memory).

The counterpart of examples/example_observability.py. It shows:
 1. per-collective counters and latency histograms from
    `Context.metrics()`;
 2. Prometheus text exposition ready for a /metrics endpoint;
 3. a merged per-rank Chrome trace with labeled rank rows (Perfetto);
 4. the watchdog naming the peer a rank was stuck on.
    python examples/torch_observability.py              # on the card
    python examples/torch_observability.py --device cpu # CPU tensors
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

import gloo_tpu_torch  # noqa: E402
from gloo_tpu_torch.device import resolve_device  # noqa: E402
from gloo_tpu_torch.utils import (histogram_quantile,  # noqa: E402
                                  merge_snapshots, merge_traces,
                                  to_prometheus)

SIZE = 2


def worker(store, rank, size, dev, results, errors):
    try:
        device = gloo_tpu_torch.Device()
        ctx = gloo_tpu_torch.Context(rank, size, timeout=30)
        ctx.connect_full_mesh(store, device)

        # Arm the straggler watchdog: waits blocked > 80ms get reported.
        ctx.set_watchdog(0.08)
        ctx.trace_start()

        x = torch.ones(256 * 1024, dtype=torch.float32, device=dev)
        for _ in range(5):
            ctx.allreduce(x)
        ctx.broadcast(x, root=0)
        ctx.barrier()

        # Manufacture a straggler: rank 1 dawdles before serving rank 0's
        # receive, so rank 0's watchdog fires and names rank 1.
        y = torch.zeros(8, dtype=torch.float32, device=dev)
        if rank == 0:
            ctx.recv(y, 1, slot=42, timeout=10)
        else:
            time.sleep(0.25)
            ctx.send(y, 0, slot=42)

        ctx.trace_stop()
        results[rank] = (ctx.metrics(), ctx.trace_json())
        ctx.barrier()
        ctx.close()
    except BaseException as exc:  # noqa: BLE001 - re-raised by main
        errors.append((rank, exc))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None,
                        help="directory for the merged trace (default: a "
                             "new temporary directory)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    store = gloo_tpu_torch.HashStore()
    results, errors = [None] * SIZE, []
    threads = [threading.Thread(target=worker,
                                args=(store, r, SIZE, dev, results, errors))
               for r in range(SIZE)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        if t.is_alive():
            raise TimeoutError("worker timed out")
    if errors:
        rank, exc = errors[0]
        raise RuntimeError(f"rank {rank} failed") from exc

    snaps = [m for m, _ in results]
    ar = snaps[0]["ops"]["allreduce"]
    p50 = histogram_quantile(ar["latency_us"], 0.5)
    print(f"[metrics] allreduce: {ar['calls']} calls, "
          f"{ar['bytes']} bytes, p50 ~{p50:.0f}us")
    peer_stats = snaps[0]["transport"][1]
    print(f"[metrics] rank0 <-> rank1: sent {peer_stats['sent_bytes']}B "
          f"recv {peer_stats['recv_bytes']}B, last progress "
          f"{peer_stats['last_progress_age_us']}us ago")

    stall = snaps[0]["watchdog"]["last"]
    if stall is None or stall["peer"] != 1:
        raise AssertionError(f"the watchdog did not name rank 1: {stall}")
    print(f"[watchdog] rank0 was blocked {stall['waited_us'] // 1000}ms "
          f"on peer {stall['peer']} slot {stall['slot']} — the straggler "
          f"is named, not guessed")

    prom = to_prometheus(snaps[0], extra_labels={"job": "example"})
    print("[prometheus] first lines of the exposition:")
    for line in prom.splitlines()[:4]:
        print("   ", line)

    job = merge_snapshots(snaps)
    print(f"[merged] job-level allreduce calls: "
          f"{job['ops']['allreduce']['calls']}")

    merged_trace = merge_traces([t for _, t in results])
    out = args.out or tempfile.mkdtemp(prefix="torch_observability-")
    path = os.path.join(out, "observability_trace.json")
    with open(path, "w") as f:
        f.write(merged_trace)
    events = json.loads(merged_trace)
    rows = [e for e in events if e.get("ph") == "M"
            and e["name"] == "process_name"]
    print(f"[trace] {len(events)} events across {len(rows)} labeled rank "
          f"rows -> {path} (open in Perfetto)")

    print("observability example OK")


if __name__ == "__main__":
    main()
