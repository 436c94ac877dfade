"""Flash attention on hand-written Hopper kernels, forward and backward,
and the carried-state step kernels of ring attention.

Counterpart of gloo_tpu/ops/attention.py::flash_attention: attention over
(b, h, t, d) without materializing the (t, t) scores, with grouped-query
k/v of shape (b, h_kv, t, d) read through the head index, never
replicated. Its Pallas kernels become CUDA C++: the forward
``_flash_kernel`` is ``csrc/flash_fwd.cu`` (``flash_attention_fwd``;
bf16 and f16 on wgmma over TMA-staged tiles, launched as
``flash_fwd_plan`` says), the fused backward ``_flash_bwd_fused_kernel``
is ``csrc/flash_bwd.cu`` (``flash_attention_bwd``; bf16 and f16 on wgmma
over TMA-staged tiles, three
launches named in ``FLASH_BWD_KERNELS``, as ``flash_bwd_plan`` says), and
``flash_attention`` ties the two together as a ``torch.autograd.Function``,
as the custom VJP does in JAX.

The ring-attention steps keep JAX's (bh, t, d) layout:
``flash_attention_step`` (``_flash_step_kernel``, ``csrc/flash_step.cu``)
folds one k/v block into carried f32 (acc, m, l) state (the ring forward
takes it in place, through ``flash_attention_step_into``), and
``flash_attention_bwd_step`` computes what ``_flash_bwd_dq_step_kernel``
and ``_flash_bwd_dkv_step_kernel`` do, in one fused launch of
``csrc/flash_bwd_step.cu`` (bf16, f16). The ring backward takes that launch
through ``flash_attention_bwd_step_into``, which adds into the caller's
f32 carriers, with ``prepare_bwd_step`` before the ring and
``flash_bwd_step_finish`` after it. Their offsets place the tiles in the
global sequence; they may differ per query-head row, so one launch serves
every rank of a world.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain twin (``*_plain``), which repeats the kernel's arithmetic
step by step (same tiles, same rounding points) and is the version the
kernel is held against.

Dtypes: KERNEL_DTYPES (bf16, f16 and f32: each kernel has an instance of
each; bf16 and f16 share one template). Head dims: every d >= 1
(kernel_head_dim). The kernels have instances for KERNEL_HEAD_DIMS (64,
128 and 256); any other d up to 256 runs on the next instance up. Past
256 each source launches its wide kernel (csrc/flash_wide.cuh: FMA
products over column parts of the outputs, scores recomputed per part),
at d rounded up to a multiple of WIDE_UNIT. Where the kernel's
width exceeds d, the wrapper zero-pads q, k and v (and dO and out) along
d and slices the results back, with the scale of the unpadded d (the step
kernel reads and writes the d columns of the carried acc as it lies, at
any width, odd ones included). That is exact: padded q and k columns add
0 to every score, padded v and dO columns fill only output columns that
are cut off, and delta gains only 0 * 0 terms. The twins on the CPU run
unpadded. Any batch * heads (rows): past the grid's 65535 the kernels
spread the rows over its y and z axes. The card refuses, with an error
and no fallback, any other dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gloo_tpu_torch import _build

# Key and query tiles of csrc/flash_fwd.cu and csrc/flash_bwd.cu (kBlockK,
# kBlockQ); the plain versions walk the same tiles so that the forward's
# online-softmax rescaling and the backward's f32 sums happen at the same
# places.
BLOCK_K = 64
BLOCK_Q = 64
# The kernels' dtype codes (csrc/hopper.cuh's: ring.SUM_DTYPES' codes).
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# The kernels' head_dim instances; a smaller head_dim is zero-padded up to
# the next one.
KERNEL_HEAD_DIMS = (64, 128, 256)
# Past the last instance, the wide kernels (csrc/flash_wide.cuh) run at d
# rounded up to a multiple of WIDE_UNIT (16-byte rows in every dtype).
WIDE_UNIT = 8
# The three launches of one flash_attention_bwd call on the card, by dtype:
# delta and the lse rows with dq_acc = 0, the main kernel, dQ's scale and
# cast. Every name contains "flash_bwd".
FLASH_BWD_KERNELS = {
    torch.bfloat16: ("flash_bwd_prep_kernel", "flash_bwd_wgmma_kernel",
                     "flash_bwd_dq_kernel"),
    torch.float16: ("flash_bwd_prep_kernel", "flash_bwd_wgmma_kernel",
                    "flash_bwd_dq_kernel"),
    torch.float32: ("flash_bwd_prep_kernel", "flash_bwd_f32_kernel",
                    "flash_bwd_dq_kernel"),
}
# The same three launches at a head_dim past the instances, every dtype.
FLASH_BWD_WIDE_KERNELS = ("flash_bwd_prep_kernel", "flash_bwd_wide_kernel",
                          "flash_bwd_dq_kernel")

_libs: dict[str, ctypes.CDLL] = {}
# ctypes signature of each source's entry points: (pointers, ints, floats,
# strides); the stream comes last.
_SIGNATURES = {
    "flash_fwd": {"gtt_flash_fwd": (5, 7, 1, 9)},
    "flash_bwd": {"gtt_flash_bwd": (11, 7, 2, 15)},
    "flash_step": {"gtt_flash_step": (8, 8, 1, 6)},
    "flash_bwd_step": {"gtt_flash_bwd_step_prep": (6, 4, 0, 2),
                       "gtt_flash_bwd_step": (13, 9, 2, 8),
                       "gtt_flash_bwd_step_dq": (2, 1, 1, 1)},
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        for fname, (ptrs, ints, floats, strides) in _SIGNATURES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = (
                [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                + [ctypes.c_float] * floats + [ctypes.c_longlong] * strides
                + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [ctypes.c_int]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _raise_on(err: int, name: str, lib: ctypes.CDLL) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.gtt_error_string(err).decode()} (cudaError {err})")


def _check_heads(q, k, v):
    """The layout checks of the JAX wrapper, for every device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (batch, heads, seq, head_dim)")
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    if v.shape[1] != h_kv:
        raise ValueError(f"k has {h_kv} heads but v has {v.shape[1]}")
    if h % h_kv != 0:
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {h_kv}")
    if k.shape != (b, h_kv, t, d) or v.shape != k.shape:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"(batch={b}, kv_heads, seq={t}, head_dim={d})")


def kernel_head_dim(d: int) -> int:
    """The head_dim the kernels run head_dim d at: up to 256, the first of
    KERNEL_HEAD_DIMS that holds d (an instance); past it, d rounded up to a
    multiple of WIDE_UNIT (the wide kernels). Zero-padded from d where
    larger. Every d >= 1."""
    if d < 1:
        raise ValueError(f"a head_dim must be at least 1; got {d}")
    if d <= KERNEL_HEAD_DIMS[-1]:
        return next(D for D in KERNEL_HEAD_DIMS if d <= D)
    return -(-d // WIDE_UNIT) * WIDE_UNIT


def _pad_head_dim(dim: int, *xs: torch.Tensor):
    """Each x zero-padded along its last axis to `dim`: new contiguous
    tensors."""
    return tuple(F.pad(x, (0, dim - x.shape[-1])) for x in xs)


def _cut(dim: int, d: int, *xs: torch.Tensor):
    """Each x cut back to head_dim d from the kernel's `dim`."""
    return xs if dim == d else tuple(x[..., :d] for x in xs)


def _check_device(named: dict) -> None:
    devices = {x.device for x in named.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{', '.join(named)} must lie on one CUDA device (or all on the "
            f"CPU); got {', '.join(str(x.device) for x in named.values())}")


def _check_kernel_inputs(q, k, v, layout=True, **more) -> int:
    """What the CUDA kernels take: one CUDA device, one of KERNEL_DTYPES
    (bf16, f16, f32) throughout, any head_dim (kernel_head_dim), any
    batch * heads and, with `layout`, contiguous
    head_dim rows on 16-byte boundaries (the flash forward and backward
    check their own: flash_fwd_plan, flash_bwd_plan). `more` names further
    operands held to the same rules (the backward's dO and out). Returns
    the kernel's head_dim, kernel_head_dim(q's)."""
    named = {"q": q, "k": k, "v": v, **more}
    _check_device(named)
    if q.dtype not in KERNEL_DTYPES or any(x.dtype != q.dtype
                                           for x in named.values()):
        raise TypeError(
            f"the kernel takes bf16, f16 or f32 {', '.join(named)} of one "
            f"dtype; got {', '.join(str(x.dtype) for x in named.values())}")
    dim = kernel_head_dim(q.shape[-1])
    if not layout:
        return dim
    vec = 16 // q.element_size()
    for name, x in named.items():
        if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a contiguous last dim, strides that are "
                f"multiples of {vec} elements and a 16-byte aligned start; "
                f"got strides {x.stride()}")
    return dim


def _layout(x: torch.Tensor):
    """(x's (b, h, t) strides in elements, whether the kernels can read x
    (b, h, t, d) as it lies). A dimension of size 1 gets the stride it
    would have if x were contiguous from there on: any stride reads it the
    same, and TMA takes only positive multiples of 16 bytes. x can be read
    as it lies where d is contiguous, the three strides are positive
    multiples of 16 bytes and the start is 16-byte aligned: what a TMA
    tensor map describes, and what the f32 path's 16-byte row loads
    need."""
    b, h, t, d = x.shape
    sb, sh, st, sd = x.stride()
    if t == 1:
        st = d
    if h == 1:
        sh = st * t
    if b == 1:
        sb = sh * h
    vec = 16 // x.element_size()
    ready = (sd == 1 and sb > 0 and sh > 0 and st > 0 and sb % vec == 0
             and sh % vec == 0 and st % vec == 0 and x.data_ptr() % 16 == 0)
    return (sb, sh, st), ready


class FlashPlan(NamedTuple):
    """What the wrapper decides for one call of csrc/flash_fwd.cu or
    csrc/flash_bwd.cu, on operands already padded to the kernel's head_dim;
    the grid, the stages and the shared memory are the kernels' own."""
    copies: tuple    # operands made contiguous first
    strides: tuple   # (b, h, t) strides of each operand as passed (_layout)


def _plan(**named: torch.Tensor) -> FlashPlan:
    """An operand the kernels cannot read as it lies (_layout: e.g. a
    fused-qkv view whose strides are not 16-byte multiples) is made
    contiguous first, and its strides are then those of the copy."""
    copies, strides = (), ()
    for name, x in named.items():
        st, ready = _layout(x)
        if not ready:
            copies += (name,)
            st = (x.shape[1] * x.shape[2] * x.shape[3],
                  x.shape[2] * x.shape[3], x.shape[3])
        strides += st
    return FlashPlan(copies, strides)


def flash_fwd_plan(q, k, v) -> FlashPlan:
    """The launch of flash_attention_fwd for these operands."""
    return _plan(q=q, k=k, v=v)


def flash_bwd_plan(q, k, v, do, out) -> FlashPlan:
    """The three launches of flash_attention_bwd for these operands (the
    strides in the kernel's order: q, k, v, dO, out)."""
    return _plan(q=q, k=k, v=v, do=do, out=out)


def _contiguous(plan: FlashPlan, **named: torch.Tensor):
    return tuple(x.contiguous() if name in plan.copies else x
                 for name, x in named.items())


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """(out (b, h, t, d) in q's dtype, lse (b, h, t) f32).

    CUDA tensors go through the Hopper kernel, CPU tensors through
    flash_attention_plain; there is no fallback from one to the other."""
    _check_heads(q, k, v)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    dim = _check_kernel_inputs(q, k, v, layout=False)
    b, h, t, d = q.shape
    if dim != d:
        q, k, v = _pad_head_dim(dim, q, k, v)
    plan = flash_fwd_plan(q, k, v)
    if plan.copies:
        q, k, v = _contiguous(plan, q=q, k=k, v=v)
    lib = _kernel_lib("flash_fwd")
    out = torch.empty((b, h, t, dim), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.gtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, k.shape[1], t, dim,
            int(causal), _folded_scale(d, q.dtype), *plan.strides, _stream())
    _raise_on(err, "flash_fwd", lib)
    flash_attention_fwd.launches += 1
    return *_cut(dim, d, out), lse


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
flash_attention_fwd.launches = 0


def _check_grad_inputs(q, out, lse, do):
    b, h, t, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"out {tuple(out.shape)} and do {tuple(do.shape)} must have q's "
            f"shape {tuple(q.shape)}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(
            f"lse must be f32 of shape {(b, h, t)}; got {lse.dtype} "
            f"{tuple(lse.shape)}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True):
    """(dq, dk, dv) in the dtypes of q, k and v, from the forward's out and
    lse and the cotangent do of out (cast to q's dtype first, as the JAX
    VJP does). dk and dv have k's (b, h_kv, t, d): GQA partials are summed
    over each group in f32 before the one cast.

    CUDA tensors go through the Hopper kernels (FLASH_BWD_KERNELS: delta
    and dq_acc's zeros are made by the first of the three launches), CPU
    tensors through flash_attention_bwd_plain; there is no fallback from
    one to the other."""
    _check_heads(q, k, v)
    _check_grad_inputs(q, out, lse, do)
    do = do.to(q.dtype)
    if all(x.device.type == "cpu" for x in (q, k, v, out, lse, do)):
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    dim = _check_kernel_inputs(q, k, v, layout=False, do=do, out=out)
    if not (lse.device == q.device and lse.is_contiguous()):
        raise ValueError("lse must be contiguous on q's device")
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    if dim != d:
        q, k, v, do, out = _pad_head_dim(dim, q, k, v, do, out)
    plan = flash_bwd_plan(q, k, v, do, out)
    if plan.copies:
        q, k, v, do, out = _contiguous(plan, q=q, k=k, v=v, do=do, out=out)
    lib = _kernel_lib("flash_bwd")
    # Work buffers the first launch writes before anything reads them:
    # per query tile, its lse and delta rows; dq_acc, the f32 dQ sums.
    rows = torch.empty((b * h, -(-t // BLOCK_Q), 2 * BLOCK_Q),
                       dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((b, h, t, dim), dtype=torch.float32,
                         device=q.device)
    dq = torch.empty((b, h, t, dim), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((b, h_kv, t, dim), dtype=q.dtype, device=q.device)
              for _ in range(2))
    with torch.cuda.device(q.device):
        err = lib.gtt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(), rows.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            KERNEL_DTYPES[q.dtype], b, h, h_kv, t, dim, int(causal),
            _folded_scale(d, q.dtype), _dq_scale(d), *plan.strides,
            _stream())
    _raise_on(err, "flash_bwd", lib)
    flash_attention_bwd.launches += 1
    return _cut(dim, d, dq, dk, dv)


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The JAX custom VJP: the forward keeps (q, k, v, out, lse), the
    backward recomputes the softmax tiles from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.causal),
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over (batch, heads, seq, head_dim) without materializing
    the score matrix; k/v may carry h_kv heads with h % h_kv == 0.
    Differentiable when grad is on and an input requires it; otherwise
    (serving, under inference_mode or no_grad) it runs the forward alone
    and keeps nothing for a backward."""
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal)[0]


@functools.lru_cache(maxsize=None)
def _folded_scale(d: int, dtype: torch.dtype) -> float:
    # JAX multiplies q (dtype) by the weakly typed 1/sqrt(d), which first
    # rounds the scale to q's dtype; the kernel gets that rounded value.
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


def _dq_scale(d: int) -> float:
    # The TPU kernel's last step multiplies the f32 dQ by the Python float
    # 1/sqrt(d), i.e. by that value in f32, unrounded to q's dtype.
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True):
    """The kernel's arithmetic in plain PyTorch: (out, lse) as
    flash_attention_fwd returns them. Walks the same BLOCK_K kv tiles with
    the same online softmax; q * scale is rounded to q's dtype, scores are
    f32, p is rounded to v's dtype before p @ v."""
    _check_heads(q, k, v)
    b, h, t, d = q.shape
    kv_head = torch.arange(h, device=q.device) // (h // k.shape[1])
    k, v = k[:, kv_head], v[:, kv_head]
    qs = (q * torch.tensor(_folded_scale(d, q.dtype), dtype=q.dtype)).float()
    rows = torch.arange(t, device=q.device)
    m = torch.full((b, h, t, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, t, 1), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    for k0 in range(0, t, BLOCK_K):
        kt = k[:, :, k0:k0 + BLOCK_K].float()
        vt = v[:, :, k0:k0 + BLOCK_K]
        s = qs @ kt.transpose(-1, -2)
        if causal:
            cols = rows[k0:k0 + BLOCK_K]
            s = s.masked_fill(cols[None, :] > rows[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vt.float()
        m = m_new
    den = l.clamp_min(1e-30)
    return (acc / den).to(q.dtype), (m + torch.log(den))[..., 0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True):
    """The backward kernel's arithmetic in plain PyTorch: (dq, dk, dv) as
    flash_attention_bwd returns them. For each BLOCK_K key tile and each
    BLOCK_Q query tile that sees it: s = (q * scale in q's dtype) k^T in
    f32, p = exp(s - lse), dv += p (in do's dtype)^T do, dp = do v^T,
    ds = p (dp - delta), dk += ds (in q's dtype)^T (q * scale),
    dq += ds (in k's dtype) k, all sums in f32; then dk and dv are summed
    over each GQA group and dq is scaled by the unrounded 1/sqrt(d)."""
    _check_heads(q, k, v)
    _check_grad_inputs(q, out, lse, do)
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    do = do.to(q.dtype)
    kv_head = torch.arange(h, device=q.device) // (h // h_kv)
    k, v = k[:, kv_head], v[:, kv_head]
    qs = q * torch.tensor(_folded_scale(d, q.dtype), dtype=q.dtype)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    lse = lse[..., None]
    rows = torch.arange(t, device=q.device)
    dq = torch.zeros((b, h, t, d), device=q.device)
    dk = torch.zeros((b, h, t, d), device=q.device)
    dv = torch.zeros((b, h, t, d), device=q.device)
    for k0 in range(0, t, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        cols = rows[k0:k0 + BLOCK_K]
        first = (k0 // BLOCK_Q) * BLOCK_Q if causal else 0
        for q0 in range(first, t, BLOCK_Q):
            sl = slice(q0, q0 + BLOCK_Q)
            qt, dot = qs[:, :, sl], do[:, :, sl]
            s = qt.float() @ kt.float().transpose(-1, -2)
            if causal:
                s = s.masked_fill(cols[None, :] > rows[sl, None], -math.inf)
            p = torch.exp(s - lse[:, :, sl])
            dv[:, :, k0:k0 + BLOCK_K] += (
                p.to(do.dtype).float().transpose(-1, -2) @ dot.float())
            dp = dot.float() @ vt.float().transpose(-1, -2)
            ds = p * (dp - delta[:, :, sl])
            dk[:, :, k0:k0 + BLOCK_K] += (
                ds.to(q.dtype).float().transpose(-1, -2) @ qt.float())
            dq[:, :, sl] += ds.to(k.dtype).float() @ kt.float()
    group = h // h_kv
    dk = dk.view(b, h_kv, group, t, d).sum(2)
    dv = dv.view(b, h_kv, group, t, d).sum(2)
    return ((dq * _dq_scale(d)).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """Materialized-scores attention with equal q and kv heads: the
    counterpart of the JAX package's _reference_attention oracle."""
    d = q.shape[-1]
    s = q.float() @ k.float().transpose(-1, -2)
    s = s / math.sqrt(d)
    if causal:
        t = q.shape[2]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


# ---- the ring-attention steps (B6, B7a + B7b) ----

def _check_step(q, k, v, kv_group: int):
    """The layout checks of the JAX step wrappers, for every device:
    q (bh, t_q, d); k, v (bh / kv_group, t_kv, d)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v must be (rows, seq, head_dim)")
    bh, _, d = q.shape
    if bh % kv_group != 0 or k.shape[0] != bh // kv_group:
        raise ValueError(
            f"k head count {k.shape[0]} != bh {bh} / kv_group {kv_group}")
    if v.shape != k.shape or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(bh / kv_group, t_kv, head_dim={d})")


def _check_rows(name: str, x: torch.Tensor, shape) -> None:
    if tuple(x.shape) != tuple(shape) or x.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 of shape {tuple(shape)}; got "
                         f"{x.dtype} {tuple(x.shape)}")


def _offsets(off, bh: int, device: torch.device) -> torch.Tensor:
    """A global offset per query-head row: (bh,) int32 on `device`, from an
    int or a (bh,) tensor."""
    if isinstance(off, torch.Tensor):
        if tuple(off.shape) != (bh,):
            raise ValueError(f"an offset tensor must be ({bh},); got "
                             f"{tuple(off.shape)}")
        if off.device != device:
            raise ValueError(f"offsets lie on {off.device}, q on {device}")
        return off.to(torch.int32).contiguous()
    return torch.full((bh,), int(off), dtype=torch.int32, device=device)


def _check_step_kernel(q, k, v, **more):
    """What the step kernels take, on operands already padded to the
    kernel's head_dim: _check_kernel_inputs on (1, bh, t, d) views, and f32
    operands `more` contiguous on q's device."""
    _check_kernel_inputs(q[None], k[None], v[None])
    for name, x in more.items():
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _check_state(q, acc, m, l) -> None:
    bh, tq, d = q.shape
    for name, x, shape in (("acc", acc, (bh, tq, d)), ("m", m, (bh, tq, 1)),
                           ("l", l, (bh, tq, 1))):
        _check_rows(name, x, shape)


def _step_launch(q, k, v, acc, m, l, qo, ko, causal, kv_group) -> None:
    """One launch of csrc/flash_step.cu: k, v folded into the contiguous f32
    state acc (bh, t_q, d), m and l (bh, t_q, 1) in place. q, k and v run on
    the kernel's head_dim (zero-padded); acc stays d wide (the kernel reads
    and writes its first d columns)."""
    bh, tq, d = q.shape
    dim = kernel_head_dim(d)
    if dim != d:
        q, k, v = _pad_head_dim(dim, q, k, v)
    _check_step_kernel(q, k, v, acc=acc, m=m, l=l)
    lib = _kernel_lib("flash_step")
    with torch.cuda.device(q.device):
        err = lib.gtt_flash_step(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), qo.data_ptr(), ko.data_ptr(),
            KERNEL_DTYPES[q.dtype], bh, kv_group, tq, k.shape[1], dim, d,
            int(causal), _folded_scale(d, q.dtype), *_row_strides(q),
            *_row_strides(k), *_row_strides(v), _stream())
    _raise_on(err, "flash_step", lib)
    flash_attention_step.launches += 1


def flash_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         q_offset, k_offset, causal: bool = True,
                         kv_group: int = 1):
    """Fold one key/value block into carried flash state: the new (acc, m,
    l), as new tensors.

    q (bh, t_q, d); k, v (bh / kv_group, t_kv, d), query-head row i reading
    kv row i // kv_group; acc (bh, t_q, d) f32; m, l (bh, t_q, 1) f32.
    q_offset / k_offset are the global positions of the first query and
    key: ints, or int32 tensors of shape (bh,), one per row. The JAX
    version's block_q / block_k / interpret / vma_axes have no
    counterpart: the tiles are the kernel's (BLOCK_Q, BLOCK_K).

    CUDA tensors go through the Hopper kernel (csrc/flash_step.cu, on a
    copy of the state: flash_attention_step_into updates it in place), CPU
    tensors through flash_attention_step_plain; there is no fallback."""
    _check_step(q, k, v, kv_group)
    _check_state(q, acc, m, l)
    bh = q.shape[0]
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    if q.device.type == "cpu":
        return flash_attention_step_plain(q, k, v, acc, m, l, qo, ko, causal,
                                          kv_group)
    acc, m, l = (x.clone(memory_format=torch.contiguous_format)
                 for x in (acc, m, l))
    _step_launch(q, k, v, acc, m, l, qo, ko, causal, kv_group)
    return acc, m, l


# Launches of the CUDA kernel in this process, by both entries; counts
# nothing on the CPU.
flash_attention_step.launches = 0


def flash_attention_step_into(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, acc: torch.Tensor,
                              m: torch.Tensor, l: torch.Tensor, q_offset,
                              k_offset, causal: bool = True,
                              kv_group: int = 1) -> None:
    """flash_attention_step in place: folds the block into the caller's
    contiguous f32 state acc (bh, t_q, d), m and l (bh, t_q, 1), all on q's
    device, at any head_dim the kernels take (acc stays d wide). A query
    tile that sees no key of the block (each BLOCK_Q rows of a query-head
    row) is left untouched: on the card its block exits before any load
    or store.

    CUDA tensors go through csrc/flash_step.cu, CPU tensors through
    flash_attention_step_into_plain; there is no fallback."""
    _check_step(q, k, v, kv_group)
    _check_state(q, acc, m, l)
    for name, x in (("acc", acc), ("m", m), ("l", l)):
        if not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be contiguous on {q.device}; got "
                             f"strides {x.stride()} on {x.device}")
    bh = q.shape[0]
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    if q.device.type == "cpu":
        flash_attention_step_into_plain(q, k, v, acc, m, l, qo, ko, causal,
                                        kv_group)
        return
    _step_launch(q, k, v, acc, m, l, qo, ko, causal, kv_group)


def _positions(off: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """(rows, n) global positions off[i] + start .. off[i] + start + n - 1."""
    return off.long()[:, None] + torch.arange(start, start + n,
                                              device=off.device)


def flash_attention_step_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, acc: torch.Tensor,
                               m: torch.Tensor, l: torch.Tensor, q_offset,
                               k_offset, causal: bool = True,
                               kv_group: int = 1):
    """B6's arithmetic in plain PyTorch: the online softmax over the same
    BLOCK_K key tiles, scores s = (q * scale in q's dtype) k^T in f32,
    masked to -inf where the global key position passes the query's, the
    m_safe / corr guards, and p rounded to v's dtype before p v."""
    _check_step(q, k, v, kv_group)
    bh, tq, d = q.shape
    tkv = k.shape[1]
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    kv_row = torch.arange(bh, device=q.device) // kv_group
    k, v = k[kv_row], v[kv_row]
    qs = (q * torch.tensor(_folded_scale(d, q.dtype), dtype=q.dtype)).float()
    rows = _positions(qo, 0, tq)
    for k0 in range(0, tkv, BLOCK_K):
        kt = k[:, k0:k0 + BLOCK_K].float()
        vt = v[:, k0:k0 + BLOCK_K]
        s = qs @ kt.transpose(-1, -2)
        if causal:
            cols = _positions(ko, k0, kt.shape[1])
            s = s.masked_fill(cols[:, None, :] > rows[:, :, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vt.float()
        m = m_new
    return acc, m, l


def visible_tiles(q_offset: torch.Tensor, k_offset: torch.Tensor, tq: int,
                  causal: bool) -> torch.Tensor:
    """(bh, t_q, 1) bool: whether the BLOCK_Q query tile of each row's
    query sees a key of the block, under the causal mask: the key block's
    first global position is at most that of the tile's last query before
    t_q. These are csrc/flash_step.cu's blocks that run; the others exit
    before any load or store."""
    last = ((torch.arange(tq, device=q_offset.device) // BLOCK_Q + 1)
            * BLOCK_Q).clamp_max(tq) - 1
    seen = k_offset.long()[:, None] <= q_offset.long()[:, None] + last
    return (seen | (not causal))[..., None]


def flash_attention_step_into_plain(q, k, v, acc, m, l, q_offset, k_offset,
                                    causal: bool = True,
                                    kv_group: int = 1) -> None:
    """flash_attention_step_into's arithmetic in plain PyTorch, in place:
    flash_attention_step_plain's new state written into acc, m and l for
    the query tiles that see a key (visible_tiles), the others untouched as
    the kernel leaves them."""
    bh, tq, _ = q.shape
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    new = flash_attention_step_plain(q, k, v, acc, m, l, qo, ko, causal,
                                     kv_group)
    seen = visible_tiles(qo, ko, tq, causal)
    for buf, x in zip((acc, m, l), new):
        buf.copy_(torch.where(seen, x, buf))


def _check_bwd_step(q, do, delta, lse):
    bh, tq, d = q.shape
    if tuple(do.shape) != (bh, tq, d) or do.dtype not in (torch.float32,
                                                          q.dtype):
        raise ValueError(
            f"do must be f32 (the ring backward's cotangent) or q's dtype, of "
            f"q's shape {(bh, tq, d)}; got {do.dtype} {tuple(do.shape)}")
    _check_rows("delta", delta, (bh, tq, 1))
    _check_rows("lse", lse, (bh, tq, 1))


class StepCotangent(NamedTuple):
    """The cotangent side of one ring backward, the same at every step:
    made once by prepare_bwd_step and handed to each step. On the CPU the
    inputs as given; on the card what csrc/flash_bwd_step.cu reads."""
    do: torch.Tensor
    """(bh, t_q, d) as given on the CPU; on the card at the kernel's
    head_dim, contiguous: dO_hi in q's dtype (bf16 or f16 q), or f32 (f32
    q)."""
    do_lo: torch.Tensor | None
    """dO_lo = dO - dO_hi in q's dtype, of an f32 dO (card, bf16 or f16 q),
    else None: a dO in q's dtype has none."""
    delta: torch.Tensor  # (bh, t_q, 1) f32
    lse: torch.Tensor    # (bh, t_q, 1) f32
    rows: torch.Tensor | None
    """Card, bf16 or f16 q: (bh, ceil(t_q / 64), 2 BLOCK_Q) f32, lse (+inf
    past t_q) and delta per query tile."""
    head_dim: int        # q's d


def prepare_bwd_step(q: torch.Tensor, do: torch.Tensor, delta: torch.Tensor,
                     lse: torch.Tensor) -> StepCotangent:
    """The StepCotangent of q (bh, t_q, d) with the cotangent do (f32, or
    q's dtype), delta = rowsum(dO * O) and lse (both (bh, t_q, 1) f32).

    On the card with bf16 or f16 q, one launch of csrc/flash_bwd_step.cu's
    bwd_step_prep_kernel packs lse and delta per query tile and splits an
    f32 do into hi and lo halves in q's dtype; a do in q's dtype is taken
    as it is (hi, and no lo). f32 q launches nothing. CPU tensors launch
    nothing."""
    _check_bwd_step(q, do, delta, lse)
    bh, tq, d = q.shape
    if q.device.type == "cpu":
        return StepCotangent(do, None, delta, lse, None, d)
    dim = kernel_head_dim(d)
    if do.device != q.device:
        raise ValueError(f"do lies on {do.device}, q on {q.device}")
    do = _pad_head_dim(dim, do)[0] if dim != d else do.contiguous()
    if q.dtype == torch.float32:
        return StepCotangent(do, None, delta, lse, None, d)
    for name, x in (("delta", delta), ("lse", lse)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    rows = torch.empty((bh, -(-tq // BLOCK_Q), 2 * BLOCK_Q),
                       dtype=torch.float32, device=q.device)
    split = do.dtype == torch.float32
    hi, lo = ((torch.empty((bh, tq, dim), dtype=q.dtype, device=q.device)
               for _ in range(2))
              if split else (do, None))
    lib = _kernel_lib("flash_bwd_step")
    with torch.cuda.device(q.device):
        err = lib.gtt_flash_bwd_step_prep(
            lse.data_ptr(), delta.data_ptr(), rows.data_ptr(),
            do.data_ptr() if split else None, hi.data_ptr() if split
            else None, lo.data_ptr() if split else None, bh, tq, dim,
            KERNEL_DTYPES[q.dtype], *do.stride()[:2], _stream())
    _raise_on(err, "flash_bwd_step_prep", lib)
    prepare_bwd_step.launches += 1
    return StepCotangent(hi, lo, delta, lse, rows, d)


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
prepare_bwd_step.launches = 0


def _row_strides(x: torch.Tensor):
    """(row, t) strides of x (rows, t, d), as _layout gives them."""
    return _layout(x[None])[0][1:]


def _bwd_step_launch(q, k, v, cot: StepCotangent, qo, ko, dq, dk, dv,
                     causal, kv_group, accumulate):
    """One ring step on csrc/flash_bwd_step.cu into the f32 buffers dq, dk
    and dv at the kernel's head_dim: the fused launch (bf16, f16), or the
    two FMA launches (f32). A block serves kv_group query heads when
    accumulating (dk and dv per kv head), one otherwise (per query head)."""
    bh, tq, d = q.shape
    dim = kernel_head_dim(d)
    if dim != d:
        q, k, v = _pad_head_dim(dim, q, k, v)
    _check_step_kernel(q, k, v, delta=cot.delta, lse=cot.lse)
    # bf16 and f16 read dO_hi (and dO_lo) and the packed rows; f32 the f32
    # dO.
    half = q.dtype != torch.float32
    if cot.do.dtype != q.dtype or (cot.rows is not None) != half \
            or (cot.do_lo is not None and not half) \
            or cot.do.shape != (bh, tq, dim) or cot.do.device != q.device:
        raise ValueError("the cotangent was prepared for another q "
                         "(prepare_bwd_step)")
    lib = _kernel_lib("flash_bwd_step")
    with torch.cuda.device(q.device):
        err = lib.gtt_flash_bwd_step(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cot.do.data_ptr(),
            None if cot.do_lo is None else cot.do_lo.data_ptr(),
            None if cot.rows is None else cot.rows.data_ptr(),
            cot.lse.data_ptr(), cot.delta.data_ptr(), qo.data_ptr(),
            ko.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            KERNEL_DTYPES[q.dtype], bh, kv_group if accumulate else 1,
            kv_group, tq, k.shape[1], dim, int(causal), int(accumulate),
            _folded_scale(d, q.dtype), _dq_scale(d), *_row_strides(q),
            *_row_strides(k), *_row_strides(v), *cot.do.stride()[:2],
            _stream())
    _raise_on(err, "flash_bwd_step", lib)
    flash_attention_bwd_step.launches += 1


def flash_attention_bwd_step(q, k, v, do, delta, lse, q_offset, k_offset,
                             causal: bool = True, kv_group: int = 1):
    """Backward mirror of flash_attention_step: (dq_partial, dk, dv) of one
    key/value block at a global position, all f32; dq_partial sums across
    blocks to the full dQ, dk/dv are per-query-head partials against the
    local queries (sum them with group_sum_kv). q (bh, t_q, d); k, v
    (bh / kv_group, t_kv, d); do (bh, t_q, d) f32 (or in q's dtype);
    delta, lse (bh, t_q, 1) f32.

    CUDA tensors go through csrc/flash_bwd_step.cu (bf16, f16: one fused
    launch for B7a and B7b, after prepare_bwd_step's), CPU tensors through
    flash_attention_bwd_step_plain; there is no fallback."""
    _check_step(q, k, v, kv_group)
    _check_bwd_step(q, do, delta, lse)
    bh, tq, d = q.shape
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    if q.device.type == "cpu":
        return flash_attention_bwd_step_plain(q, k, v, do, delta, lse, qo, ko,
                                              causal, kv_group)
    cot = prepare_bwd_step(q, do, delta, lse)
    dim = kernel_head_dim(d)
    # The fused kernel adds dQ into zeros; dk and dv are written whole.
    dq = torch.zeros((bh, tq, dim), dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty((bh, k.shape[1], dim), dtype=torch.float32,
                          device=q.device) for _ in range(2))
    _bwd_step_launch(q, k, v, cot, qo, ko, dq, dk, dv, causal, kv_group,
                     accumulate=False)
    return _cut(dim, d, dq, dk, dv)


# Launches of the step (fused bf16 or f16, or f32's two FMA kernels as one)
# in this process, by both entries; counts nothing on the CPU.
flash_attention_bwd_step.launches = 0


def _check_into(q, k, dq, dk, dv, kv_group):
    bh, tq, d = q.shape
    width = kernel_head_dim(d)
    for name, x, shape in (("dq", dq, (bh, tq, width)),
                           ("dk", dk, (bh // kv_group, k.shape[1], width)),
                           ("dv", dv, (bh // kv_group, k.shape[1], width))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(
                f"{name} must be a contiguous f32 buffer {shape} on "
                f"{q.device} (the kernel's head_dim); got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def flash_attention_bwd_step_into(q, k, v, cot: StepCotangent, q_offset,
                                  k_offset, dq, dk, dv, causal: bool = True,
                                  kv_group: int = 1) -> None:
    """The ring backward's step, accumulating: adds this block's unscaled
    dQ piece into dq (bh, t_q, w) and its dK and dV, summed over each GQA
    group, into dk and dv (bh / kv_group, t_kv, w), all f32 buffers the
    caller owns, w = kernel_head_dim(d) (columns past d stay 0).
    flash_bwd_step_finish scales dq once at the end. cot is
    prepare_bwd_step's, made once per backward.

    CUDA tensors go through csrc/flash_bwd_step.cu (bf16, f16: one fused
    launch that adds into the buffers, dk and dv with no atomics), CPU tensors
    through flash_attention_bwd_step_into_plain; there is no fallback."""
    _check_step(q, k, v, kv_group)
    _check_into(q, k, dq, dk, dv, kv_group)
    bh = q.shape[0]
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    if q.device.type == "cpu":
        flash_attention_bwd_step_into_plain(
            q, k, v, cot.do, cot.delta, cot.lse, qo, ko, dq, dk, dv, causal,
            kv_group)
        return
    _bwd_step_launch(q, k, v, cot, qo, ko, dq, dk, dv, causal, kv_group,
                     accumulate=True)


def flash_bwd_step_finish(dq: torch.Tensor, head_dim: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """dQ from the unscaled f32 sums flash_attention_bwd_step_into left in
    dq (bh, t_q, w): dq * (unrounded f32 1/sqrt(head_dim)) in `dtype`, cut
    to head_dim. One launch of csrc/flash_bwd_step.cu's bwd_step_dq_kernel
    on the card; plain PyTorch on the CPU."""
    if dtype not in KERNEL_DTYPES or dq.dtype != torch.float32:
        raise TypeError(f"dq must be f32 and dtype one of the kernels'; got "
                        f"{dq.dtype}, {dtype}")
    if dq.device.type == "cpu":
        return (dq[..., :head_dim] * _dq_scale(head_dim)).to(dtype)
    if not dq.is_contiguous():
        raise ValueError("dq must be contiguous")
    out = torch.empty(dq.shape, dtype=dtype, device=dq.device)
    lib = _kernel_lib("flash_bwd_step")
    with torch.cuda.device(dq.device):
        err = lib.gtt_flash_bwd_step_dq(dq.data_ptr(), out.data_ptr(),
                                        KERNEL_DTYPES[dtype],
                                        _dq_scale(head_dim), dq.numel(),
                                        _stream())
    _raise_on(err, "flash_bwd_step_dq", lib)
    flash_bwd_step_finish.launches += 1
    return out[..., :head_dim]


flash_bwd_step_finish.launches = 0


def group_sum_kv(partials: torch.Tensor, kv_group: int) -> torch.Tensor:
    """Fold per-query-head f32 dK/dV partials (bh, t, d) down to kv heads:
    consecutive runs of kv_group rows share one kv head."""
    if kv_group == 1:
        return partials
    bh, tkv, d = partials.shape
    return partials.reshape(bh // kv_group, kv_group, tkv, d).sum(1)


def _step_scores(qs, kt, qo, ko, q0, k0, causal):
    """f32 scores of a (query tile, key tile) pair, masked to -inf where
    the global key position passes the query's."""
    s = qs.float() @ kt.float().transpose(-1, -2)
    if causal:
        rows = _positions(qo, q0, qs.shape[1])
        cols = _positions(ko, k0, kt.shape[1])
        s = s.masked_fill(cols[:, None, :] > rows[:, :, None], -math.inf)
    return s


def _dq_piece(q, k, v, do, delta, lse, q_offset, k_offset, causal,
              kv_group):
    """B7a's sums before the scale: for each BLOCK_K key tile, s = (q *
    scale in q's dtype) k^T and dp = do v^T in f32 (do in f32, so dp is an
    f32 product), p = exp(s - lse), ds = p (dp - delta), dq += ds (in k's
    dtype) k in f32."""
    _check_step(q, k, v, kv_group)
    bh, tq, d = q.shape
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    kv_row = torch.arange(bh, device=q.device) // kv_group
    k, v = k[kv_row], v[kv_row]
    qs = q * torch.tensor(_folded_scale(d, q.dtype), dtype=q.dtype)
    do = do.float()
    dq = torch.zeros((bh, tq, d), device=q.device)
    for k0 in range(0, k.shape[1], BLOCK_K):
        kt, vt = k[:, k0:k0 + BLOCK_K], v[:, k0:k0 + BLOCK_K]
        p = torch.exp(_step_scores(qs, kt, qo, ko, 0, k0, causal) - lse)
        dp = do @ vt.float().transpose(-1, -2)
        ds = p * (dp - delta)
        dq += ds.to(k.dtype).float() @ kt.float()
    return dq


def flash_attention_bwd_dq_step_plain(q, k, v, do, delta, lse, q_offset,
                                      k_offset, causal: bool = True,
                                      kv_group: int = 1):
    """B7a's arithmetic in plain PyTorch: _dq_piece, then dq times the
    unrounded f32 1/sqrt(d) (the TPU kernel's last grid step)."""
    return _dq_piece(q, k, v, do, delta, lse, q_offset, k_offset, causal,
                     kv_group) * _dq_scale(q.shape[2])


def flash_attention_bwd_dkv_step_plain(q, k, v, do, delta, lse, q_offset,
                                       k_offset, causal: bool = True,
                                       kv_group: int = 1):
    """B7b's arithmetic in plain PyTorch, per query head: for each BLOCK_Q
    query tile, p = exp(s - lse), dv += p^T do (p unrounded: do in f32),
    dp = do v^T, ds = p (dp - delta), dk += ds (in q's dtype)^T (q * scale
    in q's dtype), all in f32."""
    _check_step(q, k, v, kv_group)
    bh, tq, d = q.shape
    qo, ko = (_offsets(o, bh, q.device) for o in (q_offset, k_offset))
    kv_row = torch.arange(bh, device=q.device) // kv_group
    k, v = k[kv_row], v[kv_row]
    qs = q * torch.tensor(_folded_scale(d, q.dtype), dtype=q.dtype)
    do = do.float()
    dk = torch.zeros((bh, k.shape[1], d), device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, tq, BLOCK_Q):
        sl = slice(q0, q0 + BLOCK_Q)
        qt, dot = qs[:, sl], do[:, sl]
        p = torch.exp(_step_scores(qt, k, qo, ko, q0, 0, causal) - lse[:, sl])
        dv += p.transpose(-1, -2) @ dot
        dp = dot @ v.float().transpose(-1, -2)
        ds = p * (dp - delta[:, sl])
        dk += ds.to(q.dtype).float().transpose(-1, -2) @ qt.float()
    return dk, dv


def flash_attention_bwd_step_plain(q, k, v, do, delta, lse, q_offset,
                                   k_offset, causal: bool = True,
                                   kv_group: int = 1):
    """flash_attention_bwd_step's arithmetic in plain PyTorch, the JAX
    kernels' (B7a, then B7b): (dq_partial, dk, dv), dk/dv per query
    head."""
    dq = flash_attention_bwd_dq_step_plain(q, k, v, do, delta, lse, q_offset,
                                           k_offset, causal, kv_group)
    dk, dv = flash_attention_bwd_dkv_step_plain(q, k, v, do, delta, lse,
                                                q_offset, k_offset, causal,
                                                kv_group)
    return dq, dk, dv


def flash_attention_bwd_step_into_plain(q, k, v, do, delta, lse, q_offset,
                                        k_offset, dq, dk, dv,
                                        causal: bool = True,
                                        kv_group: int = 1) -> None:
    """flash_attention_bwd_step_into's arithmetic in plain PyTorch, in
    place: dq[..., :d] += the unscaled dQ piece (_dq_piece; the scale comes
    once, in flash_bwd_step_finish), and dk[..., :d], dv[..., :d] += B7b's
    per-query-head partials summed over each GQA group in head order, as
    the kernel's blocks walk their group's heads."""
    d = q.shape[2]
    dq[..., :d] += _dq_piece(q, k, v, do, delta, lse, q_offset, k_offset,
                             causal, kv_group)
    parts = flash_attention_bwd_dkv_step_plain(q, k, v, do, delta, lse,
                                               q_offset, k_offset, causal,
                                               kv_group)
    for buf, part in zip((dk, dv), parts):
        part = part.view(-1, kv_group, *part.shape[1:])
        total = part[:, 0]
        for j in range(1, kv_group):
            total = total + part[:, j]
        buf[..., :d] += total
