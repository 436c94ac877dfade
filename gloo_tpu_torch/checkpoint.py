"""Step checkpoints of torch state, for recovery after a failure.

Counterpart of gloo_tpu/checkpoint.py's ``StepCheckpointer``, with its
contract: a directory per step, written by one rank (rank-0-writes,
everyone-reads), committed atomically, garbage-collected to the newest
`keep` steps, and read back with ``load_latest`` after
``resilience.rebuild_after_failure`` has formed the smaller group::

    ckpt = StepCheckpointer(dir)
    ckpt.save(step, {"model": model.state_dict(),
                     "adam": optimizer.state_dict(), "step": step})
    ...crash, rebuild_after_failure...
    step, state = ckpt.load_latest(template)   # template's devices, dtypes

The reference stores through orbax, which imports jax; this one through
``torch.save``. The two on-disk formats differ: a step written by one
cannot be read by the other (an orbax step cannot be read without jax).

A step is written as one file into ``step_<n>.tmp-<pid>``, fsynced, and
the directory renamed to ``step_<n>``: a crash leaves no half-written
``step_<n>``, and a step counts as committed once its directory holds the
state file. State is a tree of dicts, lists and tuples of tensors and
Python scalars (``optimizer.state_dict()`` is one); it is loaded with
``weights_only=True``. A template stands in for the reference's
shardings: each loaded tensor takes the device and dtype of the tensor at
its place in the template, so a CUDA state comes back on the card.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
from typing import Any, Optional, Tuple

import torch

__all__ = ["StepCheckpointer", "state_digest"]

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


def _like(value: Any, template: Any) -> Any:
    """`value` with each tensor on the device and in the dtype of the
    tensor at the same place of `template`; a None in the template leaves
    its subtree as loaded."""
    if template is None:
        return value
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor):
            raise TypeError(f"the template holds a tensor where the "
                            f"checkpoint holds {type(value).__name__}")
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        if not isinstance(value, dict) or set(value) != set(template):
            raise ValueError("the template's keys differ from the "
                             "checkpoint's")
        return {k: _like(value[k], template[k]) for k in value}
    if isinstance(template, (list, tuple)):
        if not isinstance(value, (list, tuple)) \
                or len(value) != len(template):
            raise ValueError("the template's sequence differs from the "
                             "checkpoint's")
        return type(value)(_like(v, t) for v, t in zip(value, template))
    return value


def state_digest(state: Any) -> str:
    """sha256 of a state tree: its structure (any mapping counts as a
    dict, its keys sorted by their text; lists and tuples apart), each
    tensor's dtype, shape and bytes (read on the CPU) and each other
    leaf's repr. Two ranks that hold the same state, on any device, get
    the same digest."""
    h = hashlib.sha256()

    def walk(node):
        if isinstance(node, torch.Tensor):
            t = node.detach().contiguous().cpu()
            h.update(f"T{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(node, dict):
            h.update(f"D{len(node)}".encode())
            for key in sorted(node, key=repr):
                h.update(repr(key).encode())
                walk(node[key])
        elif isinstance(node, (list, tuple)):
            kind = "T" if isinstance(node, tuple) else "L"
            h.update(f"{kind}{len(node)}".encode())
            for item in node:
                walk(item)
        else:
            h.update(repr(node).encode())

    walk(state)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class StepCheckpointer:
    """Durable torch state per step: one ``torch.save`` file in a directory
    per step, committed by an atomic rename, the newest `keep` steps kept
    (all of them when `keep` <= 0)."""

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep

    def _step_path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}")

    def steps(self):
        """Committed step numbers, ascending."""
        out = []
        for name in os.listdir(self._dir):
            m = _STEP_RE.match(name)
            if m and self._is_committed(os.path.join(self._dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    @staticmethod
    def _is_committed(path: str) -> bool:
        # The writer's _gc may delete a step between a reader's listing
        # and this check: a vanished step is simply not a candidate.
        return os.path.isfile(os.path.join(path, STATE_FILE))

    def save(self, step: int, state: Any, *, force: bool = False) -> None:
        """Write `state` under `step` (from one rank: rank-0-writes,
        everyone-reads); returns once the step is committed. A committed
        step is replaced only with force=True (else ValueError, as the
        reference's orbax raises): the old directory is renamed aside, the
        new one renamed in, then the old one deleted."""
        final = self._step_path(step)
        if os.path.exists(final) and not force:
            raise ValueError(f"Destination {final} already exists "
                             f"(pass force=True to replace it).")
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            old = f"{final}.old-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        _fsync_dir(self._dir)
        self._gc()

    def load(self, step: int, template: Optional[Any] = None) -> Any:
        """The state of one step, its tensors on the CPU; with a template
        (a tree of the same structure), each tensor takes the device and
        dtype of the template's tensor at its place (a None in the
        template keeps its subtree as loaded). FileNotFoundError if the
        step is gone."""
        state = torch.load(os.path.join(self._step_path(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        return state if template is None else _like(state, template)

    def load_latest(self, template: Optional[Any] = None
                    ) -> Tuple[Optional[int], Optional[Any]]:
        """(step, state) of the newest committed step, or (None, None)
        when there is none. A step that the writer's garbage collection
        deletes between the listing and the load is skipped for the next
        newest."""
        for step in reversed(self.steps()):
            try:
                return step, self.load(step, template)
            except FileNotFoundError:
                continue
        return None, None

    def _gc(self) -> None:
        steps = self.steps()
        for step in steps[:-self._keep] if self._keep > 0 else []:
            shutil.rmtree(self._step_path(step), ignore_errors=True)
