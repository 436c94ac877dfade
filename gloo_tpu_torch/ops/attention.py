"""Flash attention forward on a hand-written Hopper kernel.

Counterpart of gloo_tpu/ops/attention.py::flash_attention, whose Pallas
kernel ``_flash_kernel`` becomes ``csrc/flash_fwd.cu``: attention over
(b, h, t, d) without materializing the (t, t) scores, with grouped-query
k/v of shape (b, h_kv, t, d) read through the head index, never
replicated.

On a CUDA tensor ``flash_attention_fwd`` launches the kernel or raises; on
a CPU tensor it runs ``flash_attention_plain``, which repeats the kernel's
arithmetic step by step (same kv tile size, same rounding points) and is
the version the kernel is held against. The kernel is forward only: its
backward comes with training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gloo_tpu_torch import _build

# kv tile of csrc/flash_fwd.cu (kBlockK); the plain version walks the same
# tiles so that its online-softmax rescaling happens at the same places.
BLOCK_K = 64
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (64, 128)

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        lib.gtt_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
        lib.gtt_flash_fwd.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [ctypes.c_int]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def _check_kernel_inputs(q, k, v):
    """What the CUDA kernel takes: one CUDA device, bf16 or f32 throughout,
    head_dim 64 or 128, contiguous head_dim rows on 16-byte boundaries."""
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(
            f"q, k and v must lie on one CUDA device (or all on the CPU); "
            f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(
            f"the kernel takes bf16 or f32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    b, h = q.shape[:2]
    if b * h > 65535:
        raise ValueError(f"batch * heads {b * h} exceeds the grid's 65535")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
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
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention on CUDA is forward only; its backward kernel "
            "comes with the training slice (run under torch.no_grad() or "
            "torch.inference_mode())")
    b, h, t, d = q.shape
    lib = _kernel_lib()
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, k.shape[1], t, d,
            int(causal), _folded_scale(d, q.dtype), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: "
            f"{lib.gtt_error_string(err).decode()} (cudaError {err})")
    flash_attention_fwd.launches += 1
    return out, lse


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over (batch, heads, seq, head_dim) without materializing
    the score matrix; k/v may carry h_kv heads with h % h_kv == 0."""
    return flash_attention_fwd(q, k, v, causal)[0]


def _folded_scale(d: int, dtype: torch.dtype) -> float:
    # JAX multiplies q (dtype) by the weakly typed 1/sqrt(d), which first
    # rounds the scale to q's dtype; the kernel gets that rounded value.
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


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
