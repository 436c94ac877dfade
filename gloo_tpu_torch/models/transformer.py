"""The flagship causal-LM transformer, for training and serving on one GPU.

Counterpart of gloo_tpu/models/transformer.py with the same configuration,
parameter shapes and numerics: bf16 activations over f32 parameters,
weights stored (fan_in, fan_out) and applied as ``x @ W``, RMSNorm with
its variance in f32, tanh-approximated GELU, tied f32 logits. Parameter
names follow the JAX tree (``embed``, ``pos``, ``ln_f.scale``,
``layers.<i>.wqkv`` ...), so gloo_tpu_torch.weights converts one into the
other. ``forward`` is the counterpart of the JAX ``apply`` (nn.Module
already has an ``apply``) and ``loss`` of the JAX ``loss``; autograd
takes the attention's gradient through the flash backward kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from gloo_tpu_torch.device import resolve_device
from gloo_tpu_torch.ops.attention import flash_attention
from gloo_tpu_torch.ops.rope import apply_rope, rope_positions


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 512
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 1024
    max_seq_len: int = 128
    dtype: torch.dtype = torch.bfloat16
    # Attention through the flash kernel (gloo_tpu_torch.ops) when the
    # sequence length is a multiple of 8, as in the JAX model; otherwise
    # the materialized-scores path.
    use_flash_attention: bool = False
    # Grouped-query attention: shared k/v heads (None = n_heads).
    n_kv_heads: int | None = None
    # Rotary position embeddings instead of the learned position table.
    use_rope: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class _Scale(nn.Module):
    """An RMSNorm's gain, named ``scale`` as in the JAX tree."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, kv_dim = cfg.d_model, cfg.head_dim * cfg.kv_heads

        def dense(fan_in, fan_out):
            return nn.Parameter(torch.empty(fan_in, fan_out, device=device))

        self.ln1 = _Scale(d, device)
        self.ln2 = _Scale(d, device)
        self.wqkv = dense(d, d + 2 * kv_dim)
        self.wo = dense(d, d)
        self.w_up = dense(d, cfg.d_ff)
        self.w_down = dense(cfg.d_ff, d)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _softmax_attention(q, k, v, valid, dtype):
    """Materialized-scores attention: f32 scores / sqrt(hd), -1e30 where
    `valid` is false, probabilities in `dtype`, f32 result. GQA k/v are
    repeated per query head (jnp.repeat along heads)."""
    group = q.shape[1] // k.shape[1]
    if group != 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return probs.float() @ v.float()


class Transformer(nn.Module):
    def __init__(self, config: TransformerConfig, device="cuda"):
        super().__init__()
        cfg = self.cfg = config
        h_kv = cfg.kv_heads
        if h_kv < 1 or cfg.n_heads % h_kv != 0:
            raise ValueError(
                f"n_heads {cfg.n_heads} must be a positive multiple of "
                f"n_kv_heads {h_kv}")
        dev = resolve_device(device)
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=dev))
        if not cfg.use_rope:
            # The learned table exists only when it is consumed.
            self.pos = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model, device=dev))
        self.layers = nn.ModuleList(
            _Layer(cfg, dev) for _ in range(cfg.n_layers))
        self.ln_f = _Scale(cfg.d_model, dev)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Random weights with the JAX init's shapes and scales: normal
        embeddings and positions * 0.02, dense normal * sqrt(1 / fan_in),
        norm gains 1. Drawn on the generator's device, then copied, so one
        seed gives the same weights on every device."""

        def normal(param, std):
            x = torch.randn(param.shape, generator=generator,
                            device=generator.device)
            param.copy_(x * std)

        normal(self.embed, 0.02)
        if not self.cfg.use_rope:
            normal(self.pos, 0.02)
        for layer in self.layers:
            for w in (layer.wqkv, layer.wo, layer.w_up, layer.w_down):
                normal(w, math.sqrt(1.0 / w.shape[0]))
            layer.ln1.scale.fill_(1.0)
            layer.ln2.scale.fill_(1.0)
        self.ln_f.scale.fill_(1.0)
        return self

    # ---- forward ----

    def _project_qkv(self, layer, x, positions):
        """The fused projection layout (slices, head split, GQA width,
        RoPE), shared by the full forward and the cached decode step."""
        cfg = self.cfg
        b, t, d = x.shape
        h, h_kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        kv_dim = hd * h_kv
        qkv = x @ layer.wqkv.to(x.dtype)
        q = qkv[..., :d].view(b, t, h, hd).transpose(1, 2)
        k = qkv[..., d:d + kv_dim].view(b, t, h_kv, hd).transpose(1, 2)
        v = qkv[..., d + kv_dim:].view(b, t, h_kv, hd).transpose(1, 2)
        if cfg.use_rope:
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        return q, k, v

    def _attention(self, layer, x):
        cfg = self.cfg
        b, t, d = x.shape
        q, k, v = self._project_qkv(layer, x,
                                    rope_positions(t, device=x.device))
        if cfg.use_flash_attention and t % 8 == 0:
            out = flash_attention(q, k, v, causal=True)
        else:
            valid = torch.ones((t, t), dtype=torch.bool,
                               device=x.device).tril()
            out = _softmax_attention(q, k, v, valid, x.dtype)
        out = out.transpose(1, 2).reshape(b, t, d).to(x.dtype)
        return out @ layer.wo.to(x.dtype)

    @staticmethod
    def _mlp(layer, x):
        up = x @ layer.w_up.to(x.dtype)
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf.
        return F.gelu(up, approximate="tanh") @ layer.w_down.to(x.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (batch, seq) int -> logits (batch, seq, vocab) f32."""
        t = tokens.shape[1]
        x = self.embed[tokens]
        if not self.cfg.use_rope:
            x = x + self.pos[:t]
        x = x.to(self.cfg.dtype)
        for layer in self.layers:
            x = x + self._attention(layer, _rmsnorm(x, layer.ln1.scale))
            x = x + self._mlp(layer, _rmsnorm(x, layer.ln2.scale))
        x = _rmsnorm(x, self.ln_f.scale)
        return x.float() @ self.embed.T

    def loss(self, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        """Mean next-token NLL of log_softmax over the f32 logits; tokens
        and targets (batch, seq) int, int32 as in JAX."""
        logits = self(tokens)
        return F.cross_entropy(logits.flatten(0, 1),
                               targets.flatten().long())

    # ---- incremental decoding (KV cache) ----

    def init_cache(self, batch: int, max_len: int | None = None) -> dict:
        """Per-layer key/value cache; GQA models cache only n_kv_heads.
        decode_step writes into these tensors in place, so each layer gets
        its own."""
        cfg = self.cfg
        max_len = max_len or cfg.max_seq_len
        if not cfg.use_rope and max_len > cfg.max_seq_len:
            raise ValueError(
                f"cache length {max_len} exceeds max_seq_len "
                f"{cfg.max_seq_len} (learned positions)")
        shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=cfg.dtype,
                               device=self.embed.device)

        return {"k": [zeros() for _ in range(cfg.n_layers)],
                "v": [zeros() for _ in range(cfg.n_layers)], "len": 0}

    def _decode_attention(self, layer, x, k_cache, v_cache, pos):
        """One-token attention against the cache. x: (b, 1, d) at position
        pos; writes this position's k/v into the cache in place."""
        b, _, d = x.shape
        q, k, v = self._project_qkv(
            layer, x, rope_positions(1, pos, device=x.device))
        k_cache[:, :, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[:, :, pos:pos + 1] = v.to(v_cache.dtype)
        valid = torch.arange(k_cache.shape[2], device=x.device) <= pos
        out = _softmax_attention(q, k_cache, v_cache, valid, x.dtype)
        out = out.transpose(1, 2).reshape(b, 1, d).to(x.dtype)
        return out @ layer.wo.to(x.dtype)

    def _step_hidden(self, cache, token):
        """One cached step without the unembedding: the final hidden row
        (b, 1, d). Updates the cache in place, cache['len'] included."""
        cfg = self.cfg
        pos = cache["len"]
        if pos >= cache["k"][0].shape[2]:
            raise ValueError(
                f"cache of length {cache['k'][0].shape[2]} is full")
        x = self.embed[token][:, None, :]
        if not cfg.use_rope:
            x = x + self.pos[pos:pos + 1]
        x = x.to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = x + self._decode_attention(
                layer, _rmsnorm(x, layer.ln1.scale), cache["k"][i],
                cache["v"][i], pos)
            x = x + self._mlp(layer, _rmsnorm(x, layer.ln2.scale))
        cache["len"] = pos + 1
        return _rmsnorm(x, self.ln_f.scale)

    @torch.inference_mode()
    def decode_step(self, cache: dict, token: torch.Tensor):
        """Feed one token (b,) at cache['len']; returns (logits (b, vocab)
        f32, cache), the cache updated in place."""
        x = self._step_hidden(cache, token)
        return (x.float() @ self.embed.T)[:, 0], cache

    @torch.inference_mode()
    def generate(self, prompt: torch.Tensor, max_new: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompt (b, t_p) -> (b, t_p + max_new). temperature 0 is greedy;
        above 0 samples from the softmax at that temperature, optionally
        cut to the top_k logits, with `generator` (on the model's device).
        The prompt streams through the cached step, the path new tokens
        take, without the unembedding until its last token."""
        if max_new == 0:
            return prompt
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) requires a "
                             "generator")

        def pick(logits):
            if temperature == 0.0:
                return logits.argmax(-1)
            logits = logits / temperature
            if top_k is not None:
                kth = logits.topk(top_k, dim=-1).values[:, -1:]
                logits = logits.masked_fill(logits < kth, -math.inf)
            probs = torch.softmax(logits, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]

        b, t_p = prompt.shape
        cache = self.init_cache(b, t_p + max_new)
        for i in range(t_p - 1):
            self._step_hidden(cache, prompt[:, i])
        logits, cache = self.decode_step(cache, prompt[:, -1])
        toks = [pick(logits)]
        for _ in range(max_new - 1):
            logits, cache = self.decode_step(cache, toks[-1])
            toks.append(pick(logits))
        return torch.cat([prompt, torch.stack(toks, 1).to(prompt.dtype)], 1)


def world_block(cfg: TransformerConfig, params: dict,
                x: torch.Tensor) -> torch.Tensor:
    """One pre-norm block of Transformer.forward (attention, then MLP, each
    on the RMS-normed residual) over world tensors: rank r applies its own
    weights to its own activations. params {"ln1.scale" (P, d),
    "ln2.scale" (P, d), "wqkv" (P, d, d + 2 kv_dim), "wo" (P, d, d),
    "w_up" (P, d, d_ff), "w_down" (P, d_ff, d)}, x (P, b, t, d) -> (P, b,
    t, d) in x's dtype. The attention runs once over the world's P b
    sequences (one flash launch)."""
    ranks, b, t, d = x.shape
    h, h_kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    kv_dim = hd * h_kv

    def dense(y, name):
        return torch.matmul(y, params[name].to(x.dtype))

    y = _rmsnorm(x, params["ln1.scale"][:, None, None]).view(ranks, b * t, d)
    qkv = dense(y, "wqkv").view(ranks * b, t, -1)
    q = qkv[..., :d].view(ranks * b, t, h, hd).transpose(1, 2)
    k = qkv[..., d:d + kv_dim].view(ranks * b, t, h_kv, hd).transpose(1, 2)
    v = qkv[..., d + kv_dim:].view(ranks * b, t, h_kv, hd).transpose(1, 2)
    if cfg.use_rope:
        positions = rope_positions(t, device=x.device)
        q, k = apply_rope(q, positions), apply_rope(k, positions)
    if cfg.use_flash_attention and t % 8 == 0:
        out = flash_attention(q, k, v, causal=True)
    else:
        valid = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        out = _softmax_attention(q, k, v, valid, x.dtype)
    out = out.transpose(1, 2).reshape(ranks, b * t, d).to(x.dtype)
    x = x + dense(out, "wo").view(x.shape)
    y = _rmsnorm(x, params["ln2.scale"][:, None, None]).view(ranks, b * t, d)
    up = F.gelu(dense(y, "w_up"), approximate="tanh")
    return x + dense(up, "w_down").view(x.shape)
