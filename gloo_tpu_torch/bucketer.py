"""DDP-style gradient-bucket coalescing over the async collective engine.

Counterpart of gloo_tpu/bucketer.py over torch tensors. Many small
gradient tensors are packed into flat per-dtype buckets of
``TPUCOLL_BUCKET_BYTES`` (default 25 MiB, torch DDP's ``bucket_cap_mb``),
and each bucket's allreduce is issued async the moment it fills, so the
packing of bucket k+1 overlaps the wire time of bucket k. ``finish()``
waits in issue order and writes the results back into the added tensors
in place.

CUDA members are packed on their card into a pooled flat; the engine
stages the flat once per bucket through a pinned host buffer and copies
the sums back at the wait (gloo_tpu_torch.core.AsyncEngine), and the
scaling and unpacking run on the card.

Ordering contract: every rank adds the same tensors (shape, dtype) in the
same order and calls ``finish()`` at the same point. Error contract: a
bucket failure surfaces typed at ``finish()``; every tensor added since
the last successful ``finish()`` then has undefined contents.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from gloo_tpu_torch import core
from gloo_tpu_torch._lib import Aborted, Error

__all__ = ["GradientBucketer", "DEFAULT_BUCKET_BYTES", "scale_inplace"]

DEFAULT_BUCKET_BYTES = 25 << 20  # torch DDP's bucket_cap_mb default


def scale_inplace(t: torch.Tensor, scale: float) -> torch.Tensor:
    """t *= scale with the reference's rounding (gloo_tpu/bucketer.py:52-60
    on numpy): f16, f32 and f64 multiply by scale rounded to the dtype; an
    integer dtype takes the truncated product computed in float64; bf16,
    which numpy does not count as inexact, takes the integer branch there,
    where bf16 * float is computed in float32 and cast back."""
    if t.dtype == torch.bfloat16:
        return t.copy_(t.float() * scale)
    if t.is_floating_point():
        return t.mul_(torch.tensor(scale, dtype=t.dtype))
    return t.copy_((t.double() * scale).to(t.dtype))


def _bucket_bytes_from_env() -> int:
    raw = os.environ.get("TPUCOLL_BUCKET_BYTES")
    if not raw:
        return DEFAULT_BUCKET_BYTES
    try:
        value = int(raw)
        if value <= 0:
            raise ValueError(raw)
    except ValueError:
        raise Error(f"TPUCOLL_BUCKET_BYTES: not a positive integer: "
                    f"{raw!r}") from None
    return value


class GradientBucketer:
    """Coalesce many small tensors into flat per-dtype async allreduces.

    One instance is reusable across steps (add... add, finish; repeat).
    Not thread-safe; drive it from one thread per rank.
    """

    def __init__(self, engine: "core.AsyncEngine",
                 bucket_bytes: Optional[int] = None, op="sum",
                 average: bool = False, wire: Optional[str] = None):
        """engine: the context's AsyncEngine (Context.async_engine()).
        bucket_bytes: flush threshold per dtype bucket (default
        TPUCOLL_BUCKET_BYTES, else 25 MiB). average=True divides every
        result by the world size after the wait (requires op="sum").
        wire: opt-in wire compression of float32 buckets ("q8", "bf16",
        "lossy"); other dtypes' buckets stay lossless."""
        if callable(op):
            raise Error("GradientBucketer does not support callable "
                        "reductions (async ops run on lane threads)")
        if average and core.ReduceOp.parse(op) != core.ReduceOp.SUM:
            raise Error("average=True requires op='sum'")
        if wire is not None:
            if wire not in core.Context._WIRE_ALGORITHMS:
                raise Error(f"wire= must be one of "
                            f"{sorted(core.Context._WIRE_ALGORITHMS)}, "
                            f"got {wire!r}")
            if core.ReduceOp.parse(op) != core.ReduceOp.SUM:
                raise Error("wire compression requires op='sum'")
        self._wire = wire
        self._engine = engine
        self._bucket_bytes = (bucket_bytes if bucket_bytes is not None
                              else _bucket_bytes_from_env())
        if self._bucket_bytes <= 0:
            raise Error("bucket_bytes must be positive")
        self._op = op
        self._average = average
        # (dtype, device) -> (member tensors, running byte total).
        self._pending = {}
        # Issued buckets in issue order: (work, flat, members); flat is
        # None when an oversized tensor was issued in place.
        self._issued: List = []
        # (dtype, device, elements) -> free flat buckets, reused across
        # steps so that each bucket's pointer stays stable (a native plan
        # cache hit). A flat returns here only after its wait completed.
        self._flat_pool = {}

    def add(self, tensor: torch.Tensor) -> None:
        """Queue one tensor (contiguous); every rank adds matching tensors
        in matching order. The tensor must not be touched again until
        finish() returns."""
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"add() needs a torch tensor, "
                            f"got {type(tensor)}")
        if not tensor.is_contiguous():
            raise Error("add() needs a C-contiguous array")
        key = (tensor.dtype, tensor.device)
        nbytes = tensor.numel() * tensor.element_size()
        if nbytes >= self._bucket_bytes:
            # Already bucket-sized: allreduce it in place as its own
            # bucket, in issue order with the flat buckets.
            self._flush(key)
            work = self._engine.allreduce_async(
                tensor, op=self._op, wire=self._wire_for(tensor.dtype))
            self._issued.append((work, None, None))
            return
        members, total = self._pending.get(key, ([], 0))
        members.append(tensor)
        total += nbytes
        self._pending[key] = (members, total)
        if total >= self._bucket_bytes:
            self._flush(key)

    def flush(self) -> None:
        """Issue every partially filled bucket (finish() does this)."""
        for key in list(self._pending):
            self._flush(key)

    def _wire_for(self, dtype) -> Optional[str]:
        return self._wire if dtype == torch.float32 else None

    def _take_flat(self, dtype, device, total: int) -> torch.Tensor:
        stack = self._flat_pool.get((dtype, device, total))
        if stack:
            return stack.pop()
        return torch.empty(total, dtype=dtype, device=device)

    def _release_flat(self, flat: torch.Tensor) -> None:
        stack = self._flat_pool.setdefault(
            (flat.dtype, flat.device, flat.numel()), [])
        # At most lanes + 1 buckets of one shape are ever in flight.
        if len(stack) < 4:
            stack.append(flat)

    def _flush(self, key) -> None:
        entry = self._pending.pop(key, None)
        if entry is None or not entry[0]:
            return
        members, _ = entry
        total = sum(m.numel() for m in members)
        flat = self._take_flat(*key, total)
        torch.cat([m.reshape(-1) for m in members], out=flat)
        work = self._engine.allreduce_async(
            flat, op=self._op, wire=self._wire_for(flat.dtype))
        self._issued.append((work, flat, members))

    def finish(self) -> None:
        """Flush partial buckets, wait for every issued bucket in issue
        order, and write the reduced values back into the added tensors in
        place (divided by the world size when average=True; integer dtypes
        get the truncated mean).

        On a bucket failure the typed error propagates after the backlog
        is drained; discard the bucketer and rebuild the context."""
        self.flush()
        scale = (1.0 / self._engine._context.size if self._average
                 else None)
        try:
            while self._issued:
                work, flat, members = self._issued[0]
                work.wait()
                if flat is None:
                    if scale is not None:
                        scale_inplace(work.result, scale)
                else:
                    if scale is not None:
                        scale_inplace(flat, scale)
                    off = 0
                    for m in members:
                        m.copy_(flat[off:off + m.numel()].view(m.shape))
                        off += m.numel()
                    self._release_flat(flat)
                self._issued.pop(0)
        except BaseException:
            self._drain_after_error()
            raise

    def _drain_after_error(self) -> None:
        # Later buckets may still be running on other lanes: wait each one
        # out (the first failure is what propagates), and keep anything
        # still in flight pinned in the backlog.
        remaining, self._issued = self._issued, []
        for entry in remaining:
            work = entry[0]
            try:
                work.wait()
            except (Error, Aborted):
                if not work.test():
                    self._issued.append(entry)
