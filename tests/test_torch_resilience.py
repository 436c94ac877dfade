"""gloo_tpu_torch.resilience and utils.flightrec against gloo_tpu's.

The verdicts over store-published reports (analyze_stall_reports,
raise_on_desync_reports) and the flight-recorder analysis (detect_desync,
describe_event) are pure functions over dicts: the port's must return
the reference's on the same dicts. rebuild_after_failure runs over three
thread ranks on one HashStore: rank 2 leaves, the survivors' collective
fails, and they form the 2-rank group, publish their stall evidence and
reap the generation's bootstrap keys, as
tests/test_elastic.py::test_rebuild_after_failure_reaps_store_keys holds
the reference to with processes. Store.delete and Store.list are held to
tests/test_elastic.py::test_store_delete_and_list on every store.
"""

import json
import threading

import pytest
import torch

from gloo_tpu_torch import _lib, core, resilience
from gloo_tpu_torch.utils import flightrec

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()


def _event(seq, cseq, fp, op="allreduce", dtype="float32", nbytes=4096,
           state="completed"):
    return {"seq": seq, "cseq": cseq, "fp": fp, "op": op, "dtype": dtype,
            "bytes": nbytes, "state": state, "algo": "ring"}


def _tail(events):
    return {"next_seq": len(events),
            "tail": [{"seq": e["seq"], "cseq": e["cseq"], "fp": e["fp"],
                      "state": e["state"],
                      "desc": flightrec.describe_event(e)} for e in events]}


# Report sets: a desync at cseq 2 (rank 1 issued a broadcast), a stall
# blamed on rank 2 by both survivors, a stall with one vote each and no
# flight recorder, and nothing at all.
REPORTS = {
    "desync": {
        0: {"suspect": -1, "op": None, "flightrec": _tail(
            [_event(0, 0, 11), _event(1, 1, 12), _event(2, 2, 13)])},
        1: {"suspect": 0, "op": "transport", "flightrec": _tail(
            [_event(0, 0, 11), _event(1, 1, 12),
             _event(2, 2, 99, op="broadcast", nbytes=3 << 20)])},
        2: {"suspect": -1, "op": None, "flightrec": _tail(
            [_event(0, 0, 11), _event(1, 1, 12), _event(2, 2, 13),
             _event(3, None, 7, op="send")])},
    },
    "stall": {
        0: {"suspect": 2, "op": "allreduce", "slot": 5, "waited_ms": 900,
            "flightrec": _tail([_event(0, 0, 1), _event(1, 1, 2)])},
        1: {"suspect": 2, "op": "transport", "error": "closed",
            "flightrec": _tail([_event(0, 0, 1)])},
    },
    "split": {0: {"suspect": 1, "op": "transport"},
              1: {"suspect": 0, "op": "transport"},
              3: {"suspect": -1}},
    "none": {},
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_verdicts_match_the_reference(case):
    from gloo_tpu import resilience as ref

    reports = json.loads(json.dumps(REPORTS[case]))
    reports = {int(k): v for k, v in reports.items()}
    assert resilience.analyze_stall_reports(reports) == \
        ref.analyze_stall_reports(reports)
    if case == "desync":
        with pytest.raises(flightrec.DesyncError) as ours:
            resilience.raise_on_desync_reports(reports)
        with pytest.raises(ref.DesyncError) as theirs:
            ref.raise_on_desync_reports(reports)
        assert str(ours.value) == str(theirs.value)
        assert ours.value.report == theirs.value.report
        assert ours.value.report["blamed_ranks"] == [1]
    else:
        assert resilience.raise_on_desync_reports(reports) == \
            ref.raise_on_desync_reports(reports)


def test_flightrec_analysis_matches_the_reference():
    from gloo_tpu.utils import flightrec as ref

    assert flightrec.TAIL_K == ref.TAIL_K
    events = [_event(0, 0, 1, nbytes=n, dtype=d)
              for n in (0, 10, 1024, 5 << 20, 7 << 30, 1.5 * 2 ** 21)
              for d in ("", "bfloat16")]
    events.append({"op": "recv"})
    for e in events:
        assert flightrec.describe_event(e) == ref.describe_event(e)
    tails = {r: [e for e in REPORTS["desync"][r]["flightrec"]["tail"]]
             for r in REPORTS["desync"]}
    assert flightrec.detect_desync(tails) == ref.detect_desync(tails)
    # A 1 v 1 split names both sides; p2p records take no part.
    tails = {0: [_event(0, 0, 5)], 1: [_event(0, 0, 6)],
             2: [_event(0, None, 9, op="send")]}
    assert flightrec.detect_desync(tails) == ref.detect_desync(tails)
    assert flightrec.detect_desync({0: tails[0], 1: tails[0]}) is None


def _threads(size, fn, timeout=120.0):
    """fn(rank) on `size` threads; re-raises the first error."""
    results, errors = [None] * size, []

    def run(rank):
        try:
            results[rank] = fn(rank)
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors.append((rank, exc))

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"a rank did not finish in {timeout} s"
    if errors:
        rank, exc = errors[0]
        raise AssertionError(f"rank {rank} failed: {exc!r}") from exc
    return results


def test_rebuild_after_failure_forms_the_smaller_group_and_reaps():
    store = core.HashStore()
    left = threading.Event()

    def rank_fn(rank):
        ctx = core.Context(rank, 3, timeout=20.0)
        ctx.connect_full_mesh(store, core.Device())
        ctx.barrier()
        if rank == 2:
            ctx.close()
            left.set()
            return None
        left.wait(30)
        x = torch.full((1 << 12,), float(rank + 1))
        with pytest.raises(core.IoError):
            ctx.allreduce(x, tag=1)
        # Closing the poisoned context at once tells a survivor still
        # blocked on this one, so both reach the roll call within the
        # settle window.
        ctx.close()
        new, new_rank, new_size = resilience.rebuild_after_failure(
            store, core.Device(), old_rank=rank, old_size=3, generation=1,
            settle=3.0, timeout=60.0, failed_context=ctx)
        assert new is not None and (new_rank, new_size) == (rank, 2)
        y = torch.full((64,), float(new_rank + 1))
        new.allreduce(y, tag=2)
        assert bool((y == 3.0).all())
        new.barrier()
        new.close()
        return new_rank

    assert _threads(3, rank_fn) == [0, 1, None]
    # The mesh bootstrap and roll-call keys are reaped; the stall evidence
    # survives, as the post-mortem record.
    assert store.list("rebuild/1/mesh/tc/") == []
    assert store.list("rebuild/1/alive/") == []
    assert "rebuild/1/count" not in store.list("rebuild/1/")
    reports = resilience.stall_reports(store, generation=1, old_size=3)
    assert sorted(reports) == [0, 1]
    verdict = resilience.analyze_stall_reports(reports)
    assert verdict["kind"] in ("stall", "unknown"), verdict
    for rank, rep in reports.items():
        # A survivor blames the rank whose link it saw die first: rank 2,
        # or the other survivor once that one closed its context.
        assert rep["suspect"] in (-1, 1 - rank, 2), rep
        assert rep["flightrec"]["tail"][-1]["desc"].startswith("allreduce")


def test_rebuild_below_min_size_returns_none():
    store = core.HashStore()
    ctx, rank, size = resilience.rebuild_after_failure(
        store, core.Device(), old_rank=0, old_size=3, generation=4,
        settle=0.3, timeout=10.0, min_size=2)
    assert (ctx, rank, size) == (None, -1, 1)


def _stores(tmp_path):
    server = core.TcpStoreServer("127.0.0.1")
    return [("hash", core.HashStore(), None),
            ("file", core.FileStore(str(tmp_path)), None),
            ("tcp", core.TcpStore("127.0.0.1", server.port), server)]


def test_store_delete_and_list(tmp_path):
    for name, store, _server in _stores(tmp_path):
        store.set("lease/1", b"a")
        store.set("lease/2", b"b")
        store.set("doc", b"c")
        assert sorted(store.list("lease/")) == ["lease/1", "lease/2"], name
        assert sorted(store.list("")) == ["doc", "lease/1", "lease/2"]
        assert store.list("nope/") == []
        assert store.delete("lease/1") is True
        assert store.delete("lease/1") is False
        assert sorted(store.list("lease/")) == ["lease/2"]
        store.add("ctr", 5)
        assert store.delete("ctr") is True
        assert store.add("ctr", 1) == 1
        p = core.PrefixStore(store, "lease")
        assert sorted(p.list("")) == ["2"]
        assert p.delete("2") is True
        assert store.list("lease/") == []


def test_stall_evidence_of_a_live_context():
    """metrics() and flightrec() of a connected context feed the
    evidence: a context with collectives behind it publishes its
    flight-recorder tail, and none of its peers is blamed."""
    def rank_fn(rank):
        ctx = core.Context(rank, 2, timeout=20.0)
        ctx.connect_full_mesh(store, core.Device())
        ctx.allreduce(torch.ones(16), tag=3)
        ctx.barrier()
        snap = ctx.metrics()
        fr = ctx.flightrec()
        evidence = resilience._stall_evidence(ctx)
        seq = ctx.flightrec_seq()
        ctx.close()
        return snap, fr, evidence, seq

    store = core.HashStore()
    for rank, (snap, fr, evidence, seq) in enumerate(_threads(2, rank_fn)):
        assert snap["rank"] == rank and snap["size"] == 2
        assert all(isinstance(k, int) for k in snap["transport"])
        assert fr["next_seq"] == seq >= 2
        assert evidence["suspect"] == -1
        tail = evidence["flightrec"]["tail"]
        assert 0 < len(tail) <= flightrec.TAIL_K
        assert tail[0]["desc"].startswith("allreduce")
