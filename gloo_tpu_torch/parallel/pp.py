"""Pipeline parallelism over a mesh axis, on world tensors.

Counterpart of gloo_tpu/parallel/pp.py: the same two schedules, with
``spmd.shift`` moving activations between stages.

- ``pipeline_apply``: GPipe-style forward pipeline. S + M - 1 ticks; at
  tick t, stage s computes microbatch t - s.
- ``pipeline_train_1f1b``: the 1F1B training schedule (one-forward-
  one-backward; the non-interleaved PipeDream-flush/Megatron schedule).
  Each stage runs min(S-1-s, M) warmup forwards, then strictly
  alternates forward/backward, then drains. The input stash and both
  receive rings hold S microbatches per stage, whatever M: the 1F1B
  memory bound.

There is no shard_map: rank r of the world is the stage at its ring index
s along `axis`, and every per-rank value is a world tensor (P, ...). So
``stage_fn(params_world, x_world)`` computes every stage in one call, and
``loss_fn(y_world, target_world)`` returns the (P,) losses. As in the
reference, every tick computes on every stage and selects the results
with ``torch.where`` (a multiply by a 0/1 mask would turn an idle stage's
inf or NaN into NaN). Each tick's slots and masks come from the numpy
timetable, moved to the device once per call: the tick loop reads nothing
back from the device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.mesh import Axis, Mesh
from gloo_tpu_torch.utils.tracing import annotate


def _select(cond: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Per-rank torch.where: cond (P,) bool picks row r of a or of b."""
    return torch.where(cond.view(-1, *[1] * (a.dim() - 1)), a, b)


def _check_world(x: torch.Tensor, mesh: Mesh, what: str) -> None:
    if x.dim() < 2 or x.shape[0] != mesh.size:
        raise ValueError(f"{what} must be a world tensor ({mesh.size}, M, "
                         f"...); got {tuple(x.shape)}")


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches, axis,
                   *, mesh: Mesh) -> torch.Tensor:
    """Run a pipeline of `stage_fn` along `axis`.

    stage_params: each rank's stage weights as world tensors (stage s on
    the ranks at ring index s), in whatever structure stage_fn takes;
    x_microbatches: (P, M, ...) microbatches, only stage 0's rows read.
    Returns (P, M, ...) outputs, meaningful on the LAST stage (zeros
    elsewhere). stage_fn(params, x) -> y over world tensors must be
    shape-preserving so that activations can rotate."""
    _check_world(x_microbatches, mesh, "x_microbatches")
    stages = spmd.size(axis, mesh=mesh)
    my = np.asarray(mesh.ring_index(axis))
    m = x_microbatches.shape[1]
    ticks = stages + m - 1
    dev = x_microbatches.device
    t_col = np.arange(ticks)[:, None]
    active = torch.as_tensor((t_col - my >= 0) & (t_col - my < m),
                             device=dev)
    last = torch.as_tensor(my == stages - 1, device=dev)
    first = torch.as_tensor(my == 0, device=dev)
    inflight = torch.zeros_like(x_microbatches[:, 0])
    outputs = torch.zeros_like(x_microbatches)
    for t in range(ticks):
        incoming = _select(first, x_microbatches[:, min(t, m - 1)], inflight)
        computed = stage_fn(stage_params, incoming)
        # Stages outside their window pass zeros along; their results are
        # never recorded.
        computed = _select(active[t], computed, torch.zeros_like(computed))
        if t >= stages - 1:
            done = t - (stages - 1)
            outputs[:, done] = _select(last, computed, outputs[:, done])
        with annotate("gloo_tpu.pp.stage_shift"):
            inflight = spmd.shift(computed, axis, 1, mesh=mesh)
    return outputs


def _build_1f1b_tables(stages: int, m: int):
    """Event-driven simulation of the non-interleaved 1F1B timetable.

    Returns (fwd, bwd): int32 arrays [T, S]; entry = the microbatch that
    stage s forwards/backwards at tick t, or -1. Policy per stage: run
    min(S-1-s, M) warmup forwards, then alternate forward/backward
    starting with a forward (the "1F1B" steady state), stalling on data
    dependencies (an op's input must have been produced at an EARLIER
    tick — the inter-tick ppermute is the only transport). With M >= S
    this reproduces the classic 2(M + S - 1)-tick timeline.
    """
    warm = [min(stages - 1 - s, m) for s in range(stages)]
    f_done = [[-1] * m for _ in range(stages)]  # tick F(s,i) completed
    b_done = [[-1] * m for _ in range(stages)]
    fc = [0] * stages  # forwards issued per stage
    bc = [0] * stages  # backwards issued per stage
    fwd_rows, bwd_rows = [], []
    t = 0
    limit = 4 * (m + stages) + 8  # any valid schedule is far shorter
    while any(b < m for b in bc):
        assert t < limit, "1F1B table simulation failed to converge"
        row_f, row_b = [-1] * stages, [-1] * stages
        for s in range(stages):
            i_f, i_b = fc[s], bc[s]
            # Completion times are recorded AFTER the per-stage loop, so
            # a recorded tick is always < t: "produced at an earlier
            # tick" is exactly "!= -1" here.
            can_f = i_f < m and (s == 0 or f_done[s - 1][i_f] != -1)
            can_b = i_b < m and f_done[s][i_b] != -1 and (
                s == stages - 1 or b_done[s + 1][i_b] != -1)
            if fc[s] < warm[s]:
                turn = "f"  # warmup
            elif fc[s] < m and (fc[s] - warm[s]) == bc[s]:
                turn = "f"  # steady state: forward's turn
            else:
                turn = "b"
            if turn == "f" and can_f:
                row_f[s] = i_f
            elif turn == "b" and can_b:
                row_b[s] = i_b
            # else: stall this tick (dependency bubble)
        for s in range(stages):
            if row_f[s] >= 0:
                f_done[s][row_f[s]] = t
                fc[s] += 1
            if row_b[s] >= 0:
                b_done[s][row_b[s]] = t
                bc[s] += 1
        fwd_rows.append(row_f)
        bwd_rows.append(row_b)
        t += 1
    return (np.asarray(fwd_rows, np.int32), np.asarray(bwd_rows, np.int32))


def _rank_tables(axis: Axis, mesh: Mesh, m: int, device):
    """The 1F1B timetable per flat rank, every tick at once, on `device`:
    a dict of (T, P) tensors (the microbatch each rank forwards and
    backwards, its stash slot, the slots it receives into, and the masks
    that select what it keeps) and the tick count T."""
    stages = spmd.size(axis, mesh=mesh)
    my = np.asarray(mesh.ring_index(axis))
    fwd, bwd = _build_1f1b_tables(stages, m)
    f_mb, b_mb = fwd[:, my], bwd[:, my]
    left_f = fwd[:, (my - 1) % stages]
    right_b = bwd[:, (my + 1) % stages]
    f_idx, b_idx = np.clip(f_mb, 0, m - 1), np.clip(b_mb, 0, m - 1)
    is_last = np.broadcast_to(my == stages - 1, f_mb.shape)
    tables = {
        "f_idx": f_idx, "f_slot": f_idx % stages,
        "b_idx": b_idx, "b_slot": b_idx % stages,
        "do_f": f_mb >= 0, "do_b": b_mb >= 0, "is_last": is_last,
        "first": np.broadcast_to(my == 0, f_mb.shape),
        "loss": (b_mb >= 0) & is_last,
        "take_f": (my > 0) & (left_f >= 0),
        "a_slot": np.clip(left_f, 0, m - 1) % stages,
        "take_b": (my < stages - 1) & (right_b >= 0),
        "g_slot": np.clip(right_b, 0, m - 1) % stages,
    }

    def to_device(v):
        t = torch.as_tensor(np.ascontiguousarray(v), device=device)
        return t if t.dtype == torch.bool else t.long()

    return {k: to_device(v) for k, v in tables.items()}, fwd.shape[0]


def _params_leaves(stage_params):
    """(leaves, rebuild) of a tensor or a dict of tensors."""
    if isinstance(stage_params, torch.Tensor):
        return [stage_params], lambda leaves: leaves[0]
    keys = list(stage_params)
    return ([stage_params[k] for k in keys],
            lambda leaves: dict(zip(keys, leaves)))


def pipeline_train_1f1b(stage_fn: Callable, loss_fn: Callable, stage_params,
                        x_microbatches, y_microbatches, axis, *,
                        mesh: Mesh):
    """One 1F1B training step along `axis`.

    stage_params: each rank's stage weights as world tensors (a tensor or
    a dict of them); x_microbatches: (P, M, ...) inputs, stage 0's
    rows read; y_microbatches: (P, M, ...) targets, the last stage's rows
    read. stage_fn(params, x) -> y over world tensors must be
    shape-preserving; loss_fn(y, target) -> (P,) is each rank's loss, the
    last stage's used. Returns (grads, loss_sum): grads in stage_params'
    structure, each rank's stage-parameter gradient SUMMED over
    microbatches; loss_sum (P,) the summed loss, nonzero on the last stage.

    The backward of a tick recomputes stage_fn on the stashed input and
    takes its VJP (torch.autograd.grad), seeded with dloss/dy on the last
    stage and with the received cotangent elsewhere: the reference's
    jax.vjp. Every tick computes a forward, a recompute and a backward on
    every stage, selected, not branched, as in the reference."""
    _check_world(x_microbatches, mesh, "x_microbatches")
    _check_world(y_microbatches, mesh, "y_microbatches")
    stages = spmd.size(axis, mesh=mesh)
    m = x_microbatches.shape[1]
    ranks = mesh.size
    dev = x_microbatches.device
    tbl, ticks = _rank_tables(axis, mesh, m, dev)
    ar = torch.arange(ranks, device=dev)
    leaves, rebuild = _params_leaves(stage_params)

    x0 = x_microbatches[:, 0]
    x_stash = x0.new_zeros((ranks, stages) + x0.shape[1:])
    a_recv = torch.zeros_like(x_stash)
    g_recv = torch.zeros_like(x_stash)
    grad_acc = [torch.zeros_like(p) for p in leaves]
    loss_acc = torch.zeros(ranks, dtype=torch.float32, device=dev)

    for t in range(ticks):
        f_slot, b_slot = tbl["f_slot"][t], tbl["b_slot"][t]
        # ---- forward ----
        x_in = _select(tbl["first"][t],
                       x_microbatches[ar, tbl["f_idx"][t]],
                       a_recv[ar, f_slot])
        with torch.no_grad():
            y_out = stage_fn(rebuild(leaves), x_in)
        x_stash[ar, f_slot] = _select(tbl["do_f"][t], x_in,
                                      x_stash[ar, f_slot])

        # ---- backward: recompute and VJP, seeded per stage ----
        xb = x_stash[ar, b_slot].requires_grad_()
        params = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            y_b = stage_fn(rebuild(params), xb)
            y_det = y_b.detach().requires_grad_()
            loss_val = loss_fn(y_det, y_microbatches[ar, tbl["b_idx"][t]])
            (dldy,) = torch.autograd.grad(loss_val.sum(), y_det)
            ct = _select(tbl["is_last"][t], dldy, g_recv[ar, b_slot])
            *gp, gx = torch.autograd.grad(y_b, params + [xb], ct)
        do_b = tbl["do_b"][t]
        for acc, g in zip(grad_acc, gp):
            acc += _select(do_b, g, torch.zeros_like(g))
        loss_acc += torch.where(tbl["loss"][t], loss_val.detach().float(),
                                0.0)

        # ---- communication (the inter-tick transport) ----
        with annotate("gloo_tpu.pp.fwd_shift"):
            sent_f = spmd.shift(
                _select(tbl["do_f"][t], y_out, torch.zeros_like(y_out)),
                axis, 1, mesh=mesh)
        a_slot = tbl["a_slot"][t]
        a_recv[ar, a_slot] = _select(tbl["take_f"][t], sent_f,
                                     a_recv[ar, a_slot])
        with annotate("gloo_tpu.pp.bwd_shift"):
            sent_b = spmd.shift(_select(do_b, gx, torch.zeros_like(gx)),
                                axis, -1, mesh=mesh)
        g_slot = tbl["g_slot"][t]
        g_recv[ar, g_slot] = _select(tbl["take_b"][t], sent_b,
                                     g_recv[ar, g_slot])
    return rebuild(grad_acc), loss_acc
