"""Flash attention on hand-written Hopper kernels, forward and backward.

Counterpart of gloo_tpu/ops/attention.py::flash_attention: attention over
(b, h, t, d) without materializing the (t, t) scores, with grouped-query
k/v of shape (b, h_kv, t, d) read through the head index, never
replicated. Its Pallas kernels become CUDA C++: the forward
``_flash_kernel`` is ``csrc/flash_fwd.cu`` (``flash_attention_fwd``), the
fused backward ``_flash_bwd_fused_kernel`` is ``csrc/flash_bwd.cu``
(``flash_attention_bwd``), and ``flash_attention`` ties the two together
as a ``torch.autograd.Function``, as the custom VJP does in JAX.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain twin (``flash_attention_plain``,
``flash_attention_bwd_plain``), which repeats the kernel's arithmetic step
by step (same tiles, same rounding points) and is the version the kernel
is held against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gloo_tpu_torch import _build

# Key and query tiles of csrc/flash_fwd.cu and csrc/flash_bwd.cu (kBlockK,
# kBlockQ); the plain versions walk the same tiles so that the forward's
# online-softmax rescaling and the backward's f32 sums happen at the same
# places.
BLOCK_K = 64
BLOCK_Q = 64
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (64, 128)

_libs: dict[str, ctypes.CDLL] = {}
# ctypes signature of each source's entry point: (pointers, ints, floats,
# strides); the stream comes last.
_SIGNATURES = {"flash_fwd": (5, 7, 1, 9), "flash_bwd": (10, 7, 2, 12)}


def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        ptrs, ints, floats, strides = _SIGNATURES[name]
        fn = getattr(lib, f"gtt_{name}")
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


def _check_kernel_inputs(q, k, v, **more):
    """What the CUDA kernels take: one CUDA device, bf16 or f32 throughout,
    head_dim 64 or 128, contiguous head_dim rows on 16-byte boundaries.
    `more` names further (b, h, t, d) operands held to the same rules (the
    backward's dO)."""
    named = {"q": q, "k": k, "v": v, **more}
    devices = {x.device for x in named.values()}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            f"{', '.join(named)} must lie on one CUDA device (or all on the "
            f"CPU); got {', '.join(str(x.device) for x in named.values())}")
    if q.dtype not in KERNEL_DTYPES or any(x.dtype != q.dtype
                                           for x in named.values()):
        raise TypeError(
            f"the kernel takes bf16 or f32 {', '.join(named)} of one dtype; "
            f"got {', '.join(str(x.dtype) for x in named.values())}")
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    b, h = q.shape[:2]
    if b * h > 65535:
        raise ValueError(f"batch * heads {b * h} exceeds the grid's 65535")
    vec = 16 // q.element_size()
    for name, x in named.items():
        if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a contiguous last dim, strides that are "
                f"multiples of {vec} elements and a 16-byte aligned start; "
                f"got strides {x.stride()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """(out (b, h, t, d) in q's dtype, lse (b, h, t) f32).

    CUDA tensors go through the Hopper kernel, CPU tensors through
    flash_attention_plain; there is no fallback from one to the other."""
    _check_heads(q, k, v)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check_kernel_inputs(q, k, v)
    b, h, t, d = q.shape
    lib = _kernel_lib("flash_fwd")
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, k.shape[1], t, d,
            int(causal), _folded_scale(d, q.dtype), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], stream)
    _raise_on(err, "flash_fwd", lib)
    flash_attention_fwd.launches += 1
    return out, lse


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

    CUDA tensors go through the Hopper kernel, CPU tensors through
    flash_attention_bwd_plain; there is no fallback from one to the
    other."""
    _check_heads(q, k, v)
    _check_grad_inputs(q, out, lse, do)
    do = do.to(q.dtype)
    if all(x.device.type == "cpu" for x in (q, k, v, out, lse, do)):
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    _check_kernel_inputs(q, k, v, do=do)
    if not (lse.device == q.device and lse.is_contiguous()):
        raise ValueError("lse must be contiguous on q's device")
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    lib = _kernel_lib("flash_bwd")
    delta = (do.float() * out.float()).sum(-1)
    dq_acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h_kv, t, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h_kv, t, d), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gtt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            KERNEL_DTYPES[q.dtype], b, h, h_kv, t, d, int(causal),
            _folded_scale(d, q.dtype), _dq_scale(d), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], stream)
    _raise_on(err, "flash_bwd", lib)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


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
        if do.stride(-1) != 1:
            # E.g. the expanded gradient of out.sum(): the kernel reads dO
            # rows as 16-byte vectors, so such a dO is copied once. The
            # transformer's dO (a transposed view) goes as it is.
            do = do.contiguous()
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
