"""Sequence (context) parallelism: ring attention and Ulysses attention
over a world of ranks.

Counterpart of gloo_tpu/parallel/sp.py. There is no shard_map: q, k and v
are world tensors (P, batch, heads, t_local, head_dim) whose row r is flat
rank r's slice of the sequence, rank r holding global positions
my * t_local .. (my + 1) * t_local - 1, my its index along `axis`. On a
process mesh (tpu/multihost.py) they are this process's local tensors,
the rows of ``mesh.local_ranks``: the kernels run on those rows as they
are, the K/V blocks and the dK/dV carriers move between processes by
spmd's transport (``spmd.shift``) and Ulysses' exchanges by the
cross-process all-to-all.

- ``ring_attention``: plain torch, the K/V blocks rotating with
  ``spmd.shift`` while each rank folds the arriving block into f32
  online-softmax state (no kernel in JAX either).
- ``ring_flash_attention``: the same ring with the step kernels, a
  ``torch.autograd.Function``. The forward launches B6
  (``flash_attention_step_into``) once per ring step over every rank of
  the world at once (per-row offsets), into one f32 state updated in
  place; the backward is the second ring pass of
  JAX's custom VJP, one fused B7a + B7b launch per step
  (``flash_attention_bwd_step_into``) that adds into the dQ buffer and the
  dK/dV carriers, which ride the rotation home with their blocks.
- ``ulysses_attention``: two all-to-alls (B8, through ``spmd.alltoall``)
  turn sequence shards into head shards, full-sequence attention runs over
  the world at once (B1 forward, B2 backward by default), and one more
  all-to-all turns heads back into sequence shards.
"""

from __future__ import annotations

import math

import torch

from gloo_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_bwd_step_into,
                                          flash_attention_step_into,
                                          flash_bwd_step_finish,
                                          kernel_head_dim, prepare_bwd_step)
from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.mesh import Mesh
from gloo_tpu_torch.utils.tracing import annotate


def _check_world(q, k, v, mesh: Mesh):
    rows = len(mesh.local_ranks)
    if q.dim() != 5 or k.dim() != 5 or v.dim() != 5 \
            or not q.shape[0] == k.shape[0] == v.shape[0] == rows:
        what = "world tensors" if mesh.processes == 1 \
            else "this process's local tensors"
        raise ValueError(
            f"q, k and v must be {what} (ranks={rows}, batch, heads, "
            f"t_local, head_dim); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str, causal: bool = True, *,
                   mesh: Mesh) -> torch.Tensor:
    """Ring attention in plain torch: n steps, each folding the K/V block
    the rank holds into f32 (out, m, l) and shifting K/V one rank along
    the ring, as gloo_tpu's ring_attention does (same guards for rows with
    no visible key yet). Equal heads in q, k and v."""
    _check_world(q, k, v, mesh)
    n = spmd.size(axis, mesh=mesh)
    my = spmd.rank(axis, mesh=mesh)
    t_local, d = q.shape[3], q.shape[4]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                          device=q.device))
    q32 = q.float()
    local = torch.arange(t_local, device=q.device)
    pos_q = (my.view(-1, 1) * t_local + local)[:, None, None, :, None]
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:4], 1), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i + n) % n
        scores = torch.einsum("pbhqd,pbhkd->pbhqk", q32, k_blk.float())
        scores = scores * scale
        if causal:
            pos_k = (src.view(-1, 1) * t_local + local)[:, None, None, None]
            scores = scores.masked_fill(pos_k > pos_q, -math.inf)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(scores - m_safe)
        p = torch.where(torch.isfinite(scores), p, 0.0)
        correction = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                 0.0)
        l = l * correction + p.sum(-1, keepdim=True)
        out = out * correction + torch.einsum("pbhqk,pbhkd->pbhqd", p,
                                              v_blk.float())
        m = m_new
        if i < n - 1:
            with annotate("gloo_tpu.sp.ring_shift"):
                k_blk = spmd.shift(k_blk, axis, 1, mesh=mesh)
                v_blk = spmd.shift(v_blk, axis, 1, mesh=mesh)
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def _offset_tables(mesh: Mesh, axis: str, rows: int, t_local: int,
                   device: torch.device):
    """(q offsets (P rows,), k offsets (n, P rows)) int32 on `device`, all
    ring steps' tables in one copy: row (rank r, b, h) queries start at
    my_r * t_local, and at step i its key block came from src = my_r - i.
    On a process mesh, the local ranks' rows."""
    n = mesh.shape[axis]
    index = mesh.ring_index(axis)
    my = torch.tensor([index[r] for r in mesh.local_ranks],
                      dtype=torch.int32)
    steps = torch.arange(n, dtype=torch.int32)[:, None]
    src = (my[None, :] - steps) % n
    table = torch.cat([my[None, :], src]) * t_local
    table = table.repeat_interleave(rows, dim=1).to(device)
    return table[0], table[1:]


def _ring_flash_forward(q, k, v, axis, causal, mesh):
    """The forward ring loop on B6: (out in q's dtype, lse (P b h, t, 1)).
    One f32 state, allocated once, takes every step in place, so a rank
    whose queries see none of the arriving block's keys costs nothing."""
    n = mesh.shape[axis]
    ranks, b, h, t_local, d = q.shape
    h_kv = k.shape[2]
    if h % h_kv != 0:
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {h_kv}")
    group = h // h_kv
    bh = ranks * b * h
    qf = q.reshape(bh, t_local, d)
    q_off, k_offs = _offset_tables(mesh, axis, b * h, t_local, q.device)
    acc = torch.zeros((bh, t_local, d), device=q.device)
    m = torch.full((bh, t_local, 1), -math.inf, device=q.device)
    l = torch.zeros((bh, t_local, 1), device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        flash_attention_step_into(
            qf, k_blk.reshape(-1, t_local, d), v_blk.reshape(-1, t_local, d),
            acc, m, l, q_off, k_offs[i], causal=causal, kv_group=group)
        # JAX shifts after every step; the n-th shift's result is unused.
        if i < n - 1:
            with annotate("gloo_tpu.sp.ring_shift"):
                k_blk = spmd.shift(k_blk, axis, 1, mesh=mesh)
                v_blk = spmd.shift(v_blk, axis, 1, mesh=mesh)
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe).reshape(q.shape).to(q.dtype)
    return out, m + torch.log(l_safe)


class _RingFlash(torch.autograd.Function):
    """JAX's custom VJP (gloo_tpu/parallel/sp.py:114-176): the forward keeps
    (q, k, v, out, lse); the backward is a second ring pass whose softmax
    tiles come from the forward's global lse."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, mesh):
        out, lse = _ring_flash_forward(q, k, v, axis, causal, mesh)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.mesh = axis, causal, mesh
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        axis, mesh = ctx.axis, ctx.mesh
        n = mesh.shape[axis]
        ranks, b, h, t_local, d = q.shape
        h_kv = k.shape[2]
        group = h // h_kv
        bh = ranks * b * h
        qf = q.reshape(bh, t_local, d)
        # JAX takes the cotangent as f32. One in q's dtype (the model's: the
        # cotangent of a bf16 out) holds the same values and goes as it is,
        # so the kernel skips the f32 split's low-half passes.
        gf = (g if g.dtype == q.dtype else g.float()).reshape(bh, t_local, d)
        delta = (gf.float() * out.float().reshape(bh, t_local, d)).sum(
            -1, keepdim=True)
        cot = prepare_bwd_step(qf, gf, delta, lse)
        q_off, k_offs = _offset_tables(mesh, axis, b * h, t_local, q.device)
        # f32 carriers at the kernels' head_dim (kernel_head_dim: an
        # instance's or the wide kernels' width; padded columns stay 0).
        width = kernel_head_dim(d)
        kv_shape = (ranks, b * h_kv, t_local, width)
        dk_c = torch.zeros(kv_shape, device=q.device)
        dv_c = torch.zeros(kv_shape, device=q.device)
        dq = torch.zeros((bh, t_local, width), device=q.device)
        k_blk, v_blk = k, v
        for i in range(n):
            # One launch adds the step's dQ piece and its block's dK/dV,
            # summed over each GQA group, into the carriers; then they shift
            # with their block: after n shifts each block's gradient is
            # home.
            flash_attention_bwd_step_into(
                qf, k_blk.reshape(-1, t_local, d),
                v_blk.reshape(-1, t_local, d), cot, q_off, k_offs[i], dq,
                dk_c.view(-1, t_local, width), dv_c.view(-1, t_local, width),
                causal=ctx.causal, kv_group=group)
            dk_c = spmd.shift(dk_c, axis, 1, mesh=mesh)
            dv_c = spmd.shift(dv_c, axis, 1, mesh=mesh)
            if i < n - 1:
                k_blk = spmd.shift(k_blk, axis, 1, mesh=mesh)
                v_blk = spmd.shift(v_blk, axis, 1, mesh=mesh)
        dq = flash_bwd_step_finish(dq, d, q.dtype)
        return (dq.reshape(q.shape),
                dk_c[..., :d].reshape(k.shape).to(k.dtype),
                dv_c[..., :d].reshape(v.shape).to(v.dtype), None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: str, causal: bool = True, *,
                         mesh: Mesh) -> torch.Tensor:
    """Ring attention on the flash step kernels: K/V blocks rotate along
    `axis` while every rank folds the arriving block into carried
    online-softmax state, one B6 launch per ring step for the whole world.
    k/v may carry fewer heads (GQA: read through the head index, never
    replicated). Differentiable: the backward runs a second ring pass, one
    fused B7a + B7b launch per step that adds dQ locally and the block's
    dK/dV, group-summed in f32, into carriers that travel home with their
    block.

    The JAX version's block_q / block_k / interpret have no counterpart:
    the tiles are the kernels' own (64 x 64), and the kernels are compiled,
    not interpreted."""
    _check_world(q, k, v, mesh)
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _RingFlash.apply(q, k, v, axis, causal, mesh)
    return _ring_flash_forward(q, k, v, axis, causal, mesh)[0]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: str, causal: bool = True, attn_fn=None, *,
                      mesh: Mesh) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: two all-to-alls swap the
    sharded dimension from sequence to heads, so each rank runs attention
    over the FULL sequence for h / n of the heads; a final all-to-all
    restores sequence sharding. Needs heads % n == 0 (ValueError
    otherwise).

    The full-sequence attention defaults to the port's flash_attention
    (B1 forward, B2 backward), one launch over the whole world. Pass
    attn_fn(q, k, v, causal) to substitute another attention over
    (batch, heads, seq, head_dim); it receives the world flattened into
    the batch, (P * batch, heads / n, n * t_local, head_dim). The JAX
    version's attn_fn path fails with an UnboundLocalError before it runs
    (ROADMAP.md queue C); this one does what its docstring describes."""
    _check_world(q, k, v, mesh)
    n = spmd.size(axis, mesh=mesh)
    ranks, b, h = q.shape[:3]
    if h % n != 0:
        raise ValueError(f"heads {h} not divisible by group size {n}")
    if attn_fn is None:
        attn_fn = flash_attention
    # (b, h, t_local, d) -> (b, h / n, t, d) on every rank: scatter heads,
    # gather sequence.
    with annotate("gloo_tpu.sp.ulysses_exchange"):
        qh, kh, vh = (spmd.alltoall(x, axis, split_axis=1, concat_axis=2,
                                    mesh=mesh) for x in (q, k, v))
    out = attn_fn(*(x.reshape(ranks * b, *x.shape[2:])
                    for x in (qh, kh, vh)), causal)
    out = out.reshape(ranks, b, *out.shape[1:])
    # (b, h / n, t, d) -> (b, h, t_local, d): the inverse exchange.
    with annotate("gloo_tpu.sp.ulysses_exchange"):
        return spmd.alltoall(out, axis, split_axis=2, concat_axis=1,
                             mesh=mesh)
