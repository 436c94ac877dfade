"""Elastic membership plane: lease-based liveness, epoch transitions and
automatic shrink/grow recovery, over the port's host plane.

Counterpart of gloo_tpu/elastic.py. `resilience.rebuild_after_failure` is
application-driven: the program catches the error, picks a generation and
drives the roll call. This module inverts the control flow, so that the
system detects membership changes and the application just retries its
step:

- every worker runs a native :class:`ElasticAgent` (the C++ core's
  elastic plane): a heartbeat thread renews a store lease every
  ``TPUCOLL_LEASE_MS``, and a monitor thread watches the other members'
  leases (no renewal for ``TPUCOLL_LEASE_GRACE`` ms is death; a deleted
  lease is a graceful leave) and the published epoch documents;
- the coordinator (the lowest live worker id) publishes ``{epoch,
  members}`` on a lease expiry and on hard failure evidence from
  survivors (published through :meth:`ElasticContext.translate_failure`);
- an epoch bump CLOSES the bound context, so in-flight collectives raise
  typed errors instead of hanging; :class:`ElasticContext` turns them into
  :class:`EpochChanged`, and :func:`run_elastic` drives detect -> agree ->
  rebuild -> resume (re-creating async engines and gradient bucketers,
  and restoring from a :class:`~gloo_tpu_torch.checkpoint.StepCheckpointer`
  when given one).

Minimal usage (every worker runs the same code)::

    def step_fn(ectx, step, state):
        grad = compute_grad(state)        # a torch tensor
        ectx.allreduce(grad)              # EpochChanged on membership moves
        return apply(state, grad)

    summary = run_elastic(step_fn, store=store, device=Device(),
                          rank=rank, world_size=4, steps=1000,
                          min_size=2, checkpointer=ckpt, template=tmpl)

:class:`ElasticContext` wraps each of the reference's collectives
(``WRAPPED``: all 16 of them, point-to-point send and recv included).
"""

from __future__ import annotations

import ctypes
import json
import time
from typing import Any, Callable, Dict, Optional

from gloo_tpu_torch import _lib, core
from gloo_tpu_torch._lib import Aborted, Error, IoError, check, check_handle

__all__ = [
    "BelowMinSize",
    "ElasticAgent",
    "ElasticContext",
    "EpochChanged",
    "Evicted",
    "Left",
    "WRAPPED",
    "run_elastic",
]

_copy_out = _lib.copy_out

class EpochChanged(Error):
    """The membership moved past the epoch this collective ran in: a
    member died (lease expiry), left, was voted out on failure
    evidence, or new members were admitted. The old context is
    poisoned; call :meth:`ElasticContext.rebuild` (or let
    :func:`run_elastic` do it) and retry the step. ``epoch`` is the new
    head epoch."""

    def __init__(self, message: str, epoch: int):
        super().__init__(message)
        self.epoch = epoch


class Evicted(Error):
    """This worker was voted OUT of the membership (its lease expired —
    e.g. a long pause — or it was blamed on failure evidence twice
    running). Exit."""


class BelowMinSize(Error):
    """The membership shrank under ``min_size``: too few survivors to
    continue. Raised from rebuild on EVERY survivor — the loud,
    typed end the min-size contract promises."""


class Left(Error):
    """This worker gracefully departed via :meth:`ElasticContext.leave`
    (control-flow signal consumed by :func:`run_elastic`)."""


def _failure_evidence(ctx, members) -> dict:
    """This rank's verdict on a broken collective, in wid terms: the
    straggler-watchdog / transport-failure suspect (resilience's
    evidence extractor) mapped through the epoch's member list, plus
    the flight-recorder fingerprint tail."""
    from gloo_tpu_torch.resilience import _stall_evidence

    evidence = _stall_evidence(ctx) or {"suspect": -1}
    suspect = evidence.get("suspect", -1)
    wid = -1
    if isinstance(suspect, int) and 0 <= suspect < len(members):
        wid = members[suspect]
    evidence["suspect_wid"] = wid
    return evidence


def _wrap_context(handle: int, timeout: float, store, device):
    """Wrap a native context handle from tc_elastic_rebuild (ownership
    transfers to the wrapper; the agent must be unbound from it before
    the wrapper is dropped)."""
    return core.Context._from_handle(handle, timeout, store=store,
                                     device=device)


class ElasticAgent:
    """Handle to the native membership agent (heartbeat + monitor
    threads). Most applications use :class:`ElasticContext` /
    :func:`run_elastic` instead of driving this directly."""

    # Class-level fallbacks so __del__ is safe when __init__ raised
    # before assignment.
    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, store: core.Store, device: core.Device, *,
                 rank: int = 0, world_size: int = 1, min_size: int = 1,
                 join: bool = False, host_id: Optional[str] = None,
                 timeout: float = 60.0):
        """join=True enqueues a fresh worker (a new wid; `rank` is
        ignored) on the join queue, to be admitted at the next epoch
        boundary up to `world_size`. host_id overrides the host
        fingerprint of every epoch's context (Context.set_host_id)."""
        self._store = store    # keep the handles alive
        self._device = device
        self._handle = check_handle(_lib.lib().tc_elastic_new(
            store._handle, device._handle, rank, world_size, min_size,
            1 if join else 0, host_id.encode() if host_id else None,
            int(timeout * 1000)))
        self._free = _lib.lib().tc_elastic_free
        self.timeout = timeout

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)

    def rebuild(self, timeout: Optional[float] = None) -> core.Context:
        """Build the communicator for the current head epoch and bind
        it as this agent's monitored context. Typed failures:
        :class:`Evicted`, :class:`BelowMinSize`,
        :class:`~gloo_tpu_torch.core.TimeoutError`."""
        out = ctypes.c_void_p()
        ms = 0 if timeout is None else max(1, int(timeout * 1000))
        code = _lib.lib().tc_elastic_rebuild(self._handle, ms,
                                           ctypes.byref(out))
        if code != 0:
            msg = _lib.last_error()
            if "evicted" in msg:
                raise Evicted(msg)
            if "below min_size" in msg:
                raise BelowMinSize(msg)
            check(code)
        return _wrap_context(check_handle(out.value), self.timeout,
                             self._store, self._device)

    def note_failure(self, evidence: dict) -> None:
        """Publish hard failure evidence ({"suspect_wid": w|-1, ...})
        for the bound epoch; the coordinator folds it into the next
        membership decision."""
        check(_lib.lib().tc_elastic_note_failure(
            self._handle, json.dumps(evidence).encode()))

    def stop(self) -> None:
        """Graceful leave: stop the threads and delete this worker's
        lease (peers observe the departure immediately). Idempotent."""
        check(_lib.lib().tc_elastic_stop(self._handle))

    def epoch(self) -> int:
        return int(_lib.lib().tc_elastic_epoch(self._handle))

    def head_epoch(self) -> int:
        return int(_lib.lib().tc_elastic_head_epoch(self._handle))

    def poll(self) -> bool:
        """True when the membership moved past the bound epoch (the
        bound collective surface is — or is about to be — poisoned)."""
        return bool(_lib.lib().tc_elastic_poll(self._handle))

    def status(self) -> dict:
        """{"epoch", "head_epoch", "wid", "rank", "size", "members",
        "target_size", "min_size", "coordinator", "join_pending",
        "leases_renewed", "rebuilds", "bumps_published",
        "last_rebuild_ms", "fault_domain", "lease_ms",
        "lease_grace_ms"} — also attached as metrics()["elastic"] by
        ElasticContext (docs/observability.md)."""
        return json.loads(_copy_out(_lib.lib().tc_elastic_status_json,
                                    self._handle))


class ElasticContext:
    """A process-group context that survives membership changes.

    Wraps the current epoch's :class:`~gloo_tpu_torch.core.Context`; every
    collective that fails because the membership moved raises
    :class:`EpochChanged` instead of a raw IoError (after publishing
    this rank's failure evidence for the coordinator's verdict).
    :meth:`rebuild` swaps in the next epoch's context and re-binds the
    attachments created through this wrapper (async engines, gradient
    bucketers). ``rank`` / ``size`` always describe the CURRENT epoch.
    """

    def __init__(self, store: core.Store, device: core.Device, *,
                 rank: int = 0, world_size: int = 1, min_size: int = 1,
                 join: bool = False, host_id: Optional[str] = None,
                 timeout: float = 60.0):
        self._store = store
        self._device = device
        self._agent = ElasticAgent(
            store, device, rank=rank, world_size=world_size,
            min_size=min_size, join=join, host_id=host_id, timeout=timeout)
        self._grace_s = self._agent.status()["lease_grace_ms"] / 1000.0
        self._ctx: Optional[core.Context] = None
        self._engines: Dict[tuple, core.AsyncEngine] = {}
        self._bucketers: Dict[tuple, Any] = {}
        self.rebuild()

    # ---- identity of the current epoch ----

    @property
    def rank(self) -> int:
        return self._ctx.rank

    @property
    def size(self) -> int:
        return self._ctx.size

    @property
    def agent(self) -> ElasticAgent:
        return self._agent

    @property
    def context(self) -> core.Context:
        """The current epoch's raw Context (poisoned on the next
        membership change — prefer calling collectives through the
        wrapper, which translates failures)."""
        return self._ctx

    def status(self) -> dict:
        return self._agent.status()

    def epoch(self) -> int:
        return self._agent.epoch()

    # ---- failure translation ----

    def translate_failure(self, exc: BaseException):
        """Turn a collective failure into :class:`EpochChanged` when the
        membership moved (or is about to move): publishes this rank's
        failure evidence, then waits up to ~3 lease-grace windows for
        the coordinator's verdict. Re-raises `exc` unchanged when the
        membership holds (a genuine, non-membership failure). Public so
        failures surfacing OUTSIDE the wrapped collectives — e.g. a
        Work.wait() or GradientBucketer.finish() on an engine created
        through this wrapper — can join the same recovery path."""
        try:
            members = self._agent.status().get("members", [])
            self._agent.note_failure(_failure_evidence(self._ctx, members))
        except Exception:  # noqa: BLE001 - evidence is best-effort
            pass
        deadline = time.time() + 3.0 * self._grace_s + 1.0
        while time.time() < deadline:
            if self._agent.poll():
                head = self._agent.head_epoch()
                raise EpochChanged(
                    f"membership moved to epoch {head} "
                    f"(was {self._agent.epoch()}): {exc}", head) from exc
            time.sleep(0.05)
        raise exc

    def rebuild(self, timeout: Optional[float] = None) -> "ElasticContext":
        """Swap in the communicator for the current head epoch:
        shuts down engines bound to the old epoch, rebuilds through the
        agent (typed: Evicted / BelowMinSize / TimeoutError), closes and
        releases the old context. Attachments created through
        :meth:`async_engine` / :meth:`bucketer` are re-created lazily on
        next use — the re-binding `run_elastic` relies on."""
        self._shutdown_attachments()
        old = self._ctx
        self._ctx = self._agent.rebuild(timeout)
        if old is not None:
            try:
                old.close()  # idempotent; the monitor usually closed it
            except Exception:  # noqa: BLE001 - already-poisoned context
                pass
        return self

    def leave(self):
        """Graceful departure: peers observe the deleted lease
        immediately (no grace wait) and shrink at the next epoch.
        Raises :class:`Left` (consumed by :func:`run_elastic`)."""
        self.close()
        raise Left(f"wid {self._agent.status()['wid']} left the group")

    def close(self) -> None:
        """Stop the agent (graceful leave) and close the bound context.
        Idempotent."""
        self._shutdown_attachments()
        try:
            self._agent.stop()
        finally:
            if self._ctx is not None:
                try:
                    self._ctx.close()
                except Exception:  # noqa: BLE001 - poisoned context
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- per-epoch attachments (re-bound on rebuild) ----

    def async_engine(self, lanes: Optional[int] = None,
                     tag_base: int = 0) -> core.AsyncEngine:
        """The current epoch's async engine for this (lanes, tag_base)
        (created on first use per epoch — a COLLECTIVE, so every member
        must reach it together, exactly like Context.async_engine). After
        a rebuild the next call creates a fresh engine on the new mesh."""
        key = (lanes, tag_base)
        engine = self._engines.get(key)
        if engine is None or not engine._handle:
            engine = self._ctx.async_engine(lanes=lanes, tag_base=tag_base)
            self._engines[key] = engine
        return engine

    def bucketer(self, bucket_bytes: Optional[int] = None,
                 lanes: Optional[int] = None):
        """The current epoch's averaging GradientBucketer for this
        (bucket_bytes, lanes) over :meth:`async_engine` (re-created per
        epoch; buffers re-bind to the new lanes): finish() leaves each
        gradient summed over the epoch's members and divided by their
        count. Failures from its finish()/wait() should be routed through
        :meth:`translate_failure`."""
        from gloo_tpu_torch.bucketer import GradientBucketer

        key = (bucket_bytes, lanes)
        bucketer = self._bucketers.get(key)
        if bucketer is None:
            bucketer = GradientBucketer(self.async_engine(lanes=lanes),
                                        bucket_bytes=bucket_bytes,
                                        average=True)
            self._bucketers[key] = bucketer
        return bucketer

    def _shutdown_attachments(self) -> None:
        self._bucketers.clear()
        engines, self._engines = self._engines, {}
        for engine in engines.values():
            try:
                engine.shutdown()
            except Exception:  # noqa: BLE001 - poisoned lanes
                pass

    # ---- observability ----

    def metrics(self, drain: bool = False) -> dict:
        """Context.metrics() of the current epoch, with the agent's
        membership status attached under "elastic" (epoch gauge, member
        count, leases_renewed / rebuilds counters —
        docs/observability.md)."""
        snap = self._ctx.metrics(drain)
        snap["elastic"] = self._agent.status()
        return snap

    def __getattr__(self, name: str):
        # Everything else (flightrec, group_tag, topology, register,
        # plans, ...) delegates to the current epoch's context. Private
        # names never delegate: during __init__ self._ctx does not exist
        # yet and delegating "_ctx" itself would recurse.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._ctx, name)


def _wrap_collective(name: str) -> Callable:
    def method(self, *args, **kwargs):
        try:
            return getattr(self._ctx, name)(*args, **kwargs)
        except (IoError, Aborted) as exc:  # TimeoutError subclasses IoError
            self.translate_failure(exc)
            raise AssertionError("unreachable")  # translate always raises

    method.__name__ = name
    method.__qualname__ = f"ElasticContext.{name}"
    method.__doc__ = (
        f"Context.{name} on the current epoch's mesh; raises "
        f":class:`EpochChanged` instead of IoError when the membership "
        f"moved (see :meth:`ElasticContext.translate_failure`).")
    return method


# The reference's wrapped collectives (gloo_tpu/elastic.py); those the
# port's Context has are wrapped (today all of them).
REFERENCE_WRAPPED = ("allreduce", "allreduce_multi", "reduce",
                     "reduce_scatter", "reduce_scatter_inplace", "broadcast",
                     "barrier", "allgather", "allgatherv", "gather",
                     "gatherv", "scatter", "alltoall", "alltoallv", "send",
                     "recv")
WRAPPED = tuple(name for name in REFERENCE_WRAPPED
                if hasattr(core.Context, name))
for _name in WRAPPED:
    setattr(ElasticContext, _name, _wrap_collective(_name))


def run_elastic(step_fn: Callable, *, store: core.Store,
                device: core.Device, rank: int = 0, world_size: int = 1,
                steps: Optional[int] = None, min_size: int = 1,
                join: bool = False, host_id: Optional[str] = None,
                state: Any = None, checkpointer=None, template=None,
                max_rebuilds: int = 64,
                timeout: float = 60.0) -> dict:
    """Run ``state = step_fn(ectx, step, state)`` for `steps` successful
    steps (None = until `step_fn` raises StopIteration or leaves),
    recovering from membership changes automatically: on
    :class:`EpochChanged` the group is rebuilt (detect -> agree ->
    rebuild -> resume — no application-level rebuild call anywhere),
    engines/bucketers re-bind, and when a `checkpointer`
    (:class:`~gloo_tpu_torch.checkpoint.StepCheckpointer`) is given, `state`
    and the step counter restore from the newest committed checkpoint
    (resuming at its step + 1). Without a checkpointer the failed step
    simply retries — `step_fn` must then tolerate a retried step whose
    in-place buffers hold undefined contents (docs/errors.md).

    :class:`Evicted` / :class:`BelowMinSize` propagate: the caller (or
    its supervisor) decides whether to rejoin (join=True, a fresh worker
    admitted at the next epoch boundary) or die. The :class:`EpochChanged`
    past `max_rebuilds` rebuilds propagates too. host_id is the host
    fingerprint of every epoch's context.

    Returns {"steps", "rebuilds", "epochs": [{"epoch", "size", "rank",
    "group"}...], "rebuild_ms": [...], "elastic": final agent status,
    "stopped": bool, "left": bool, "state": final state}.
    """
    ectx = ElasticContext(store, device, rank=rank, world_size=world_size,
                          min_size=min_size, join=join, host_id=host_id,
                          timeout=timeout)
    summary: dict = {"steps": 0, "rebuilds": 0, "epochs": [],
                     "rebuild_ms": [], "stopped": False, "left": False}

    def record_epoch():
        summary["epochs"].append({
            "epoch": ectx.epoch(), "size": ectx.size, "rank": ectx.rank,
            "group": ectx.group_tag()})

    record_epoch()
    step = 0
    try:
        while steps is None or step < steps:
            try:
                state = step_fn(ectx, step, state)
                step += 1
                summary["steps"] += 1
            except StopIteration:
                summary["stopped"] = True
                break
            except Left:
                summary["left"] = True
                break
            except EpochChanged:
                summary["rebuilds"] += 1
                if summary["rebuilds"] > max_rebuilds:
                    raise
                ectx.rebuild()
                summary["rebuild_ms"].append(
                    ectx.status().get("last_rebuild_ms", -1))
                record_epoch()
                if checkpointer is not None:
                    ck_step, ck_state = checkpointer.load_latest(template)
                    if ck_step is not None:
                        step, state = int(ck_step) + 1, ck_state
        summary["elastic"] = ectx.status()
        summary["state"] = state
    finally:
        ectx.close()
    return summary
