"""Post-mortem demo on the PyTorch/CUDA port: chaos -> flight recorder ->
dump -> merge -> blame.

The counterpart of examples/example_flightrec.py. Three processes over a
FileStore, over torch tensors on --device (CUDA tensors are staged through
pinned host memory), with the always-on flight recorder (docs/
flightrec.md) pointed at a dump directory:
 1. a fault schedule stalls rank 1's first bulk message mid-allreduce:
    rank 0's armed watchdog fires while blocked and auto-dumps its ring
    (reason "stall", blaming peer 1) with the allreduce still in flight;
 2. after the run the other ranks dump explicitly, `flightrec.merge` folds
    the per-rank dumps into one timeline, and `flightrec.analyze` blames
    rank 1 naming the in-flight op;
 3. the same machinery detects the unrecoverable failure class: ranks
    deliberately issue different collectives at one sequence number, and
    the fingerprint comparison raises the typed DesyncError saying who ran
    what;
 4. the merged timeline converts to Perfetto JSON for the browser view.
The dumps stay in --out for tools/torch_flightrec_view.py.
    python examples/torch_flightrec.py              # on the card
    python examples/torch_flightrec.py --device cpu # CPU tensors
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

SIZE = 3
WORKER_TIMEOUT = 300
SCHEDULE = {"seed": 404, "faults": [
    {"when": {"rank": 1, "peer": 0, "opcode": "data", "nth": 1,
              "min_bytes": 1024},
     "action": "stall", "ms": 1200},
]}


def worker(rank, store_dir, fr_dir, dev):
    import gloo_tpu_torch
    from gloo_tpu_torch.utils import flightrec

    store = gloo_tpu_torch.FileStore(store_dir)
    ctx = gloo_tpu_torch.Context(rank, SIZE, timeout=15.0)
    ctx.connect_full_mesh(store, gloo_tpu_torch.Device())
    if rank == 0:
        ctx.set_watchdog(0.2)  # the blocked wait will auto-dump

    # --- act 1: a stalled allreduce. The recorder was already on (it
    # always is), so rank 0's watchdog dump catches the op in flight.
    x = torch.full((4096,), float(rank + 1), device=dev)
    ctx.allreduce(x, tag=1)
    if float(x[0]) != 6.0:
        raise AssertionError(f"allreduce gave {float(x[0])}, not 6")

    # --- act 2: a deliberate schedule desync at the next seq. Rank 2
    # issues a broadcast where everyone else issues an allreduce; the
    # collectives time out (this divergence is unrecoverable by design).
    y = torch.full((1024,), float(rank + 1), device=dev)
    try:
        if rank == 2:
            ctx.broadcast(y, root=2, tag=2, timeout=2.0)
        else:
            ctx.allreduce(y, tag=2, timeout=2.0)
        # rank 2's broadcast may complete locally (its sends land in
        # peers' stashes); only the allreduce ranks are sure to time out.
        if rank != 2:
            raise AssertionError("desynced allreduce unexpectedly completed")
    except gloo_tpu_torch.Error as exc:
        print(f"rank {rank}: desync victim: {str(exc)[:64]}", flush=True)

    # Ranks 1 and 2 dump explicitly; rank 0 keeps its mid-stall auto dump.
    if rank != 0:
        flightrec.dump(ctx, fr_dir)
    print(f"rank {rank}: recorded {ctx.flightrec_seq()} ops", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None,
                        help="dump directory (default: flightrec-demo in a "
                             "new temporary directory)")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // SIZE))
        worker(args.rank, args.store, args.out, torch.device(args.device))
        return
    from gloo_tpu_torch.device import resolve_device
    from gloo_tpu_torch.utils import flightrec
    from gloo_tpu_torch.utils.flightrec import DesyncError

    resolve_device(args.device)
    store = tempfile.mkdtemp(prefix="torch_flightrec-")
    fr_dir = os.path.abspath(args.out or os.path.join(store,
                                                      "flightrec-demo"))
    sched_path = os.path.join(store, "schedule.json")
    with open(sched_path, "w") as f:
        json.dump(SCHEDULE, f)
    env = dict(os.environ, TPUCOLL_FAULT_FILE=sched_path,
               TPUCOLL_FLIGHTREC_DIR=fr_dir)
    cmd = [sys.executable, os.path.abspath(__file__), "--device",
           args.device, "--store", store, "--out", fr_dir]
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

    # --- the post-mortem, as an operator would run it.
    merged = flightrec.merge(fr_dir)
    if sorted(merged["ranks"]) != list(range(SIZE)):
        raise AssertionError(f"dumps missing: {merged['missing']}")
    r0 = merged["ranks"][0]
    print(f"\nrank 0 dump: reason={r0['reason']} "
          f"blamed_peer={r0['blamed_peer']} (written mid-stall: its "
          f"allreduce is '{r0['events'][0]['state']}')")
    if r0["reason"] != "stall" or r0["blamed_peer"] != 1:
        raise AssertionError(f"rank 0's dump does not blame rank 1: {r0}")

    try:
        flightrec.raise_on_desync(merged)
        raise SystemExit("desync went undetected")
    except DesyncError as exc:
        print(f"desync verdict: {exc}")
        if "broadcast" not in str(exc) or "allreduce" not in str(exc):
            raise AssertionError(f"the verdict misses the ops: {exc}")

    perfetto_path = os.path.join(fr_dir, "postmortem_trace.json")
    with open(perfetto_path, "w") as f:
        f.write(flightrec.to_perfetto(merged))
    print(f"merged Perfetto timeline -> {perfetto_path}")
    print("flightrec example: OK")


if __name__ == "__main__":
    main()
