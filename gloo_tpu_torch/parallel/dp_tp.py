"""Data x tensor parallel training of the flagship transformer on world
parameters.

Counterpart of the dp x tp training step of ``__graft_entry__.
dryrun_multichip`` (GSPMD there, per ``layer_spec``): on a mesh with a
data axis of size D and a model axis of size M, the batch is split over
"data" and the weights over "model" - wqkv and w_up column-parallel, wo and
w_down row-parallel, embed, pos and the norm gains replicated. wqkv is
split by whole heads: model rank i holds the q, k and v columns of heads
[i h / M, (i + 1) h / M). (GSPMD's contiguous column split is a layout
XLA reshards; the arithmetic is the same.)

Every parameter is a world tensor (P, ...), row r rank r's copy or shard,
so one torch.matmul over the world and one flash launch per layer serve
every rank: the attention runs on (P b, h / M, t, d_head) views of the
world qkv projection. Each row-parallel sum is ``tp.row_parallel_dense``,
the ring allreduce (B3) along "model", whose VJP is B3 of the cotangent.

The loss weighting that makes the world backward exact (no separate
Megatron f/g operators): rank r computes l_r, the mean loss of its data
shard d, and the M ranks of a data group compute the same l_r, bitwise
(the allreduce leaves every rank of a ring the same sum). The step
differentiates sum_r l_r / (M D). Then
  - a row-parallel partial p_r receives, through B3's VJP, the sum over
    its model ring of the cotangents of the allreduced output, M copies
    of (1 / (M D)) dL_d/dy: exactly dL_d/dy / D. So every shard's gradient
    is its share of dL_d / D, and the sum over "data" makes it the
    gradient of the global mean L = (1 / D) sum_d L_d;
  - below a sum, the residual stream of rank r carries the rank's own
    cotangent, its copy of the downstream part plus its own heads' part;
    these pieces sum over the model ring to the true cotangent (the sum
    is linear and every rank's Jacobian is taken at the same activations).
    So a replicated parameter's gradient on rank r is its own heads' share
    (and 1 / M of the rest), and the sum over "model" and then over
    "data" makes the gradient of L.
The step puts every gradient into one flat f32 world buffer, replicated
gradients and l_r / (M D) first, shards after it; one B3 along "data"
sums the whole buffer, one B3 along "model" sums the replicated part,
and each parameter's .grad becomes a view. Per step: 2 B3 per layer in
the forward, 2 per layer in the backward, 2 for the gradients; one B1 and
one B2 per layer.

After each step the replicated copies are bitwise equal on every rank and
the shards bitwise equal across data ranks: B3 leaves every rank of a ring
bitwise the same sum, both data rings add the same values in the same
ring order, and Adam is elementwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gloo_tpu_torch.models.transformer import (Transformer,
                                               TransformerConfig, _rmsnorm,
                                               _softmax_attention)
from gloo_tpu_torch.ops.attention import flash_attention
from gloo_tpu_torch.ops.ring import ring_allreduce
from gloo_tpu_torch.ops.rope import apply_rope, rope_positions
from gloo_tpu_torch.parallel import tp
from gloo_tpu_torch.tpu.mesh import Mesh

# Parameters split over the model axis; every other one is replicated.
SHARDED = ("wqkv", "wo", "w_up", "w_down")
# f32 per 16-byte unit of the ring kernel.
_ALIGN = 4


class _WorldScale(nn.Module):
    """An RMSNorm's gain per rank, (P, d), named ``scale`` as in the JAX
    tree."""

    def __init__(self, ranks: int, dim: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ranks, dim, device=device))


class _TPLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, ranks: int, m: int, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        qkv = (cfg.n_heads + 2 * cfg.kv_heads) // m * hd

        def world(*shape):
            return nn.Parameter(torch.empty(ranks, *shape, device=device))

        self.ln1 = _WorldScale(ranks, d, device)
        self.ln2 = _WorldScale(ranks, d, device)
        self.wqkv = world(d, qkv)
        self.wo = world(cfg.n_heads // m * hd, d)
        self.w_up = world(d, cfg.d_ff // m)
        self.w_down = world(cfg.d_ff // m, d)


class TPTransformer(nn.Module):
    """The flagship transformer with world parameters, tensor parallel
    along `axis` of `mesh`: the forward and loss of models/transformer.py
    with the TP layers in place of the dense ones. Parameter names follow
    the one-card Transformer (``embed``, ``layers.<i>.wqkv`` ...)."""

    def __init__(self, config: TransformerConfig, mesh: Mesh,
                 axis: str = "model"):
        super().__init__()
        cfg = self.cfg = config
        m = mesh.shape[axis]
        for what, count in (("n_heads", cfg.n_heads),
                            ("kv heads", cfg.kv_heads), ("d_ff", cfg.d_ff)):
            if count % m:
                raise ValueError(f"{what} {count} is not divisible by the "
                                 f"{axis!r} axis size {m}")
        self.mesh, self.axis = mesh, axis
        ranks, dev = mesh.size, mesh.device
        self.embed = nn.Parameter(
            torch.empty(ranks, cfg.vocab_size, cfg.d_model, device=dev))
        if not cfg.use_rope:
            self.pos = nn.Parameter(
                torch.empty(ranks, cfg.max_seq_len, cfg.d_model, device=dev))
        self.layers = nn.ModuleList(
            _TPLayer(cfg, ranks, m, dev) for _ in range(cfg.n_layers))
        self.ln_f = _WorldScale(ranks, cfg.d_model, dev)

    def _attention(self, layer, x, b, t):
        """x (P, b t, d) -> the allreduced attention output (P, b t, d)."""
        cfg, ranks = self.cfg, self.mesh.size
        m = self.mesh.shape[self.axis]
        hd, h, h_kv = cfg.head_dim, cfg.n_heads // m, cfg.kv_heads // m
        qkv = tp.column_parallel_dense(x, layer.wqkv.to(x.dtype), self.axis)
        qkv = qkv.view(ranks * b, t, -1)
        q = qkv[..., :h * hd].view(ranks * b, t, h, hd).transpose(1, 2)
        k = qkv[..., h * hd:(h + h_kv) * hd].view(ranks * b, t, h_kv, hd)
        v = qkv[..., (h + h_kv) * hd:].view(ranks * b, t, h_kv, hd)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if cfg.use_rope:
            positions = rope_positions(t, device=x.device)
            q, k = apply_rope(q, positions), apply_rope(k, positions)
        if cfg.use_flash_attention and t % 8 == 0:
            out = flash_attention(q, k, v, causal=True)
        else:
            valid = torch.ones((t, t), dtype=torch.bool,
                               device=x.device).tril()
            out = _softmax_attention(q, k, v, valid, x.dtype)
        out = out.transpose(1, 2).reshape(ranks, b * t, h * hd).to(x.dtype)
        return tp.row_parallel_dense(out, layer.wo.to(x.dtype), self.axis,
                                     mesh=self.mesh)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (P, batch, seq) int, each rank's micro-batch -> logits
        (P, batch, seq, vocab) f32."""
        ranks, b, t = tokens.shape
        ar = torch.arange(ranks, device=tokens.device)[:, None, None]
        x = self.embed[ar, tokens.long()]
        if not self.cfg.use_rope:
            x = x + self.pos[:, None, :t]
        x = x.to(self.cfg.dtype).reshape(ranks, b * t, -1)
        for layer in self.layers:
            x = x + self._attention(
                layer, _rmsnorm(x, layer.ln1.scale[:, None]), b, t)
            h = _rmsnorm(x, layer.ln2.scale[:, None])
            x = x + tp.tp_mlp_block(h, layer.w_up.to(x.dtype),
                                    layer.w_down.to(x.dtype), self.axis,
                                    mesh=self.mesh)
        x = _rmsnorm(x, self.ln_f.scale[:, None])
        logits = x.float() @ self.embed.transpose(1, 2)
        return logits.view(ranks, b, t, -1)

    def loss(self, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        """(P,) f32: each rank's mean next-token NLL over its micro-batch,
        as Transformer.loss."""
        logits = self(tokens)
        nll = F.cross_entropy(logits.flatten(0, 2), targets.flatten().long(),
                              reduction="none")
        return nll.view(tokens.shape[0], -1).mean(1)


def _sharders(cfg: TransformerConfig, m: int):
    """name -> (split(full, i) -> shard i of m, join(shards) -> full) for
    the sharded parameters of one layer."""
    hd, d = cfg.head_dim, cfg.d_model
    kv_dim = hd * cfg.kv_heads
    hq, hkv = cfg.n_heads // m * hd, cfg.kv_heads // m * hd
    f = cfg.d_ff // m

    def qkv_split(w, i):
        return torch.cat([w[:, i * hq:(i + 1) * hq],
                          w[:, d + i * hkv:d + (i + 1) * hkv],
                          w[:, d + kv_dim + i * hkv:d + kv_dim + (i + 1) * hkv]],
                         dim=1)

    def qkv_join(shards):
        return torch.cat([s[:, :hq] for s in shards]
                         + [s[:, hq:hq + hkv] for s in shards]
                         + [s[:, hq + hkv:] for s in shards], dim=1)

    return {
        "wqkv": (qkv_split, qkv_join),
        "wo": (lambda w, i: w[i * hq:(i + 1) * hq],
               lambda s: torch.cat(s, 0)),
        "w_up": (lambda w, i: w[:, i * f:(i + 1) * f],
                 lambda s: torch.cat(s, 1)),
        "w_down": (lambda w, i: w[i * f:(i + 1) * f],
                   lambda s: torch.cat(s, 0)),
    }


def shard_state(state: dict, cfg: TransformerConfig, mesh: Mesh,
                axis: str = "model") -> dict:
    """One-card Transformer state -> world tensors: rank r's row is the
    replicated parameter or its shard along `axis`."""
    sharders = _sharders(cfg, mesh.shape[axis])
    index = mesh.ring_index(axis)
    world = {}
    for name, full in state.items():
        split = sharders.get(name.split(".")[-1])
        rows = [full if split is None else split[0](full, index[r])
                for r in range(mesh.size)]
        world[name] = torch.stack(rows).to(mesh.device)
    return world


def unshard_state(world: dict, cfg: TransformerConfig, mesh: Mesh,
                  axis: str = "model") -> dict:
    """The reverse, from flat rank 0's model ring: replicated tensors from
    rank 0, each sharded one joined from the ring's shards in ring
    order. Takes parameters or their gradients."""
    sharders = _sharders(cfg, mesh.shape[axis])
    ring = mesh.ring_members(axis)[0]
    state = {}
    for name, x in world.items():
        join = sharders.get(name.split(".")[-1])
        state[name] = x[0].clone() if join is None \
            else join[1]([x[r] for r in ring])
    return state


def shard_transformer(model: Transformer, mesh: Mesh,
                      axis: str = "model") -> TPTransformer:
    """The TP transformer on `mesh` holding `model`'s weights."""
    tp_model = TPTransformer(model.cfg, mesh, axis)
    world = shard_state(model.state_dict(), model.cfg, mesh, axis)
    with torch.no_grad():
        for name, p in tp_model.named_parameters():
            p.copy_(world[name])
    return tp_model


def unshard_transformer(tp_model: TPTransformer) -> dict:
    """The one-card Transformer state of `tp_model`'s weights
    (``Transformer(cfg).load_state_dict``)."""
    world = {n: p.detach() for n, p in tp_model.named_parameters()}
    return unshard_state(world, tp_model.cfg, tp_model.mesh, tp_model.axis)


def _round_up(n: int, unit: int) -> int:
    return -(-n // unit) * unit


def make_dp_tp_train_step(mesh: Mesh, data_axis: str = "data",
                          model_axis: str = "model"):
    """Build step(model, optimizer, tokens, targets) -> loss: the dp x tp
    step of a TPTransformer on `mesh` (its `model_axis` the TP axis).
    tokens and targets are the global batch (B, seq), B divisible by the
    data axis size D; rank r takes part (its position along `data_axis`).
    The optimizer runs over the world parameters (elementwise, so it is
    every rank's optimizer at once). Returns the global mean loss, a 0-d
    f32 tensor computed before the update."""
    d_size, m_size = mesh.shape[data_axis], mesh.shape[model_axis]

    def step(model: TPTransformer, optimizer: torch.optim.Optimizer,
             tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if model.mesh is not mesh or model.axis != model_axis:
            raise ValueError(f"the model is tensor parallel along "
                             f"{model.axis!r} of another mesh; the step "
                             f"takes {model_axis!r} of {mesh}")
        if tokens.shape[0] % d_size:
            raise ValueError(f"batch dim {tokens.shape[0]} is not divisible "
                             f"by the axis size {d_size}")
        ranks, weight = mesh.size, 1.0 / (m_size * d_size)
        optimizer.zero_grad(set_to_none=True)
        losses = model.loss(world_batch(tokens, mesh, data_axis),
                            world_batch(targets, mesh, data_axis))
        (losses.sum() * weight).backward()

        named = list(model.named_parameters())
        rep = [p for n, p in named if n.split(".")[-1] not in SHARDED]
        shard = [p for n, p in named if n.split(".")[-1] in SHARDED]
        n_rep = sum(p[0].numel() for p in rep)
        n_shard = sum(p[0].numel() for p in shard)
        w_rep = _round_up(n_rep + 1, _ALIGN * m_size * d_size)
        width = w_rep + _round_up(n_shard, _ALIGN * d_size)
        buf = torch.zeros((ranks, width), dtype=torch.float32,
                          device=mesh.device)
        for params, offset in ((rep, 0), (shard, w_rep)):
            for p in params:
                size = p[0].numel()
                buf[:, offset:offset + size] = p.grad.reshape(ranks, -1)
                offset += size
        buf[:, n_rep] = losses.detach() * weight
        summed = ring_allreduce(buf.view(ranks, d_size, -1), data_axis, mesh)
        summed = summed.view(ranks, width)
        rep_sum = ring_allreduce(
            summed[:, :w_rep].reshape(ranks, m_size, -1), model_axis, mesh)
        rep_sum = rep_sum.view(ranks, w_rep)
        for params, flat, offset in ((rep, rep_sum, 0),
                                     (shard, summed, w_rep)):
            for p in params:
                size = p[0].numel()
                p.grad = flat[:, offset:offset + size].view_as(p)
                offset += size
        optimizer.step()
        return rep_sum[0, n_rep].clone()

    return step


def world_batch(x: torch.Tensor, mesh: Mesh,
                data_axis: str = "data") -> torch.Tensor:
    """The global batch (B, ...) as a world tensor (P, B / D, ...): rank r
    holds the part of its position along `data_axis`."""
    d_size = mesh.shape[data_axis]
    idx = torch.tensor(mesh.ring_index(data_axis), device=x.device)
    return x.view(d_size, -1, *x.shape[1:])[idx]
