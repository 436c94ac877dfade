"""Collective autotuning plane: measured tuning tables for kAuto dispatch.

Every ``algorithm="auto"`` dispatch in the native core historically ran
off compile-time thresholds measured once, on one loopback host. This
module replaces those guesses with deployment measurements: ``tune()``
sweeps the registered algorithm variants (ring / halving-doubling and its
fold/blocks sub-variants / recursive-doubling / bcube / bf16-wire for
allreduce; binomial vs ring for reduce; ring / halving-doubling / direct
for reduce_scatter) over log2 payload buckets on the live fabric, using
the metrics registry's latency histograms as the measurement source, and
installs the elected table on every rank. ``kAuto`` dispatch then
consults the table (interpolating crossovers between buckets) and falls
back to the historical constants when no table is installed, so untuned
contexts behave exactly as before.

Determinism contract
--------------------
Algorithm election must agree on every rank or a collective deadlocks.
``tune()`` guarantees this: rank 0's measurements are elected, serialized
once, published through the rendezvous store (or the context's own
broadcast for forked contexts), and every rank — rank 0 included —
installs the table parsed from those same bytes. ``install_table()`` is
the manual path and the caller owns that contract: install the SAME
table on every rank, never per-rank measurements.

Workflow
--------
>>> table = tuning.tune(ctx)                  # all ranks, collectively
>>> if ctx.rank == 0:
...     tuning.save_table(table, "prod.json") # commit per deployment
then in later jobs either ``TPUCOLL_TUNING_FILE=prod.json`` (loaded and
installed at context connect, no code changes) or::
>>> tuning.install_table(ctx, tuning.load_table("prod.json"))

``bench.py --autotune`` drives the sweep standalone and reports the
measured deltas against the default thresholds; see docs/tuning.md for
the table format and election protocol.
"""

from __future__ import annotations

import json
from typing import Optional, Union

from gloo_tpu_torch import _lib
from gloo_tpu_torch._lib import check
from gloo_tpu_torch.core import Context

__all__ = [
    "tune",
    "install_table",
    "installed_table",
    "clear_table",
    "save_table",
    "load_table",
]

TableLike = Union[dict, str]


def _to_json_str(table: TableLike) -> str:
    if isinstance(table, str):
        return table
    return json.dumps(table)


def tune(context: Context, min_bytes: int = 1 << 10,
         max_bytes: int = 4 << 20, iters: int = 8, warmup: int = 2,
         tag: int = 0, timeout: Optional[float] = None) -> dict:
    """Sweep, elect, and install a tuning table on `context`.

    COLLECTIVE: every rank of the group must call concurrently with
    identical arguments (the sweep runs real collectives, and the
    elected table is published to the whole group). One cell is measured
    per (collective, algorithm, log2 size bucket) from `min_bytes`
    through `max_bytes`; each cell runs `warmup` untimed plus `iters`
    timed iterations. `tag` namespaces the sweep's collectives — it must
    not collide with application collectives running concurrently.

    Returns the installed table as a dict (identical on every rank);
    pass it to save_table() to persist. Expect the sweep to take roughly
    iters * arms * buckets * (per-op latency); shrink the size range or
    iters for smoke runs.
    """
    return json.loads(_lib.copy_out(
        _lib.lib().tc_tune, context._handle, min_bytes, max_bytes, iters,
        warmup, tag, context._resolve_timeout_ms(timeout)).decode())


def install_table(context: Context, table: TableLike) -> None:
    """Install a table (dict or JSON string) on THIS rank's context.

    The caller owns the rank-consistency contract: every rank must
    install the same table, or groups will elect different algorithms
    and deadlock mid-collective. Malformed tables raise Error (never
    silently install as empty).
    """
    check(_lib.lib().tc_tuning_install(
        context._handle, _to_json_str(table).encode()))


def installed_table(context: Context) -> Optional[dict]:
    """The context's installed table as a dict, or None when untuned."""
    raw = _lib.copy_out(_lib.lib().tc_tuning_json,
                        context._handle).decode()
    return json.loads(raw) if raw else None


def clear_table(context: Context) -> None:
    """Remove the installed table; kAuto falls back to the built-in
    thresholds (TPUCOLL_ALLREDUCE_HD_MAX and friends)."""
    check(_lib.lib().tc_tuning_install(context._handle, None))


def save_table(table: TableLike, path: str) -> None:
    """Write a table to a JSON file (the TPUCOLL_TUNING_FILE format)."""
    with open(path, "w") as f:
        f.write(_to_json_str(table))
        f.write("\n")


def load_table(path: str) -> dict:
    """Read a table written by save_table() / tc_tune."""
    with open(path) as f:
        return json.load(f)


def set_transport_hints(table: TableLike, channels: Optional[int] = None,
                        stripe_bytes: Optional[int] = None) -> dict:
    """Attach tuned TRANSPORT knobs to a table: the per-pair data-channel
    count and the stripe threshold (docs/transport.md). A context that
    installs the table (or loads it via TPUCOLL_TUNING_FILE) applies
    them at connect time unless the TPUCOLL_CHANNELS /
    TPUCOLL_STRIPE_BYTES env overrides them. Pick the values from a
    ``bench.py --channel-sweep`` run on the target host. Returns the
    table as a dict. The same every-rank-same-table contract applies:
    channel counts must agree across ranks or connect fails loudly."""
    t = json.loads(_to_json_str(table))
    hints = dict(t.get("transport", {}))
    if channels is not None:
        # Ceiling mirrors transport::kMaxStripeChannels (csrc wire.h).
        if not 1 <= int(channels) <= 8:
            raise ValueError(f"channels must be in [1, 8], got {channels}")
        hints["channels"] = int(channels)
    if stripe_bytes is not None:
        if int(stripe_bytes) < 0:
            raise ValueError(f"stripe_bytes must be >= 0, got {stripe_bytes}")
        hints["stripe_bytes"] = int(stripe_bytes)
    if hints:
        t["transport"] = hints
    return t
