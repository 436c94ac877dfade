"""Entry points: the flagship transformer's forward and training step on
one GPU, its data-parallel and data x tensor parallel training steps over
a world of ranks, the long-context (sequence-parallel) and MoE
(expert-parallel) paths at the flagship's width, and the ring allreduce
variants at the flagship's gradient size.

``entry()`` is the counterpart of ``__graft_entry__.entry()``: the same
configuration (vocab 512, d_model 256, 4 heads, 2 layers, d_ff 1024, seq
128, batch 8, bf16 activations, flash attention) and the same tokens from
``np.random.RandomState(0)``; the weights come from a ``torch.Generator``
seeded with 0. ``d256_f16_entry()`` and ``d256_f16_train_entry()`` are
``entry()`` and ``train_entry()`` at D256_F16_CONFIG: the same flagship with
one head of 256 in f16, whose serving and training path runs the flash kernels'
d 256 and f16 instances. ``train_entry()`` is the one-device counterpart of the
training step of ``__graft_entry__.dryrun_multichip``: the same model and
tokens, next-token targets, and Adam at optax.adam(1e-3)'s settings.
``ddp_train_entry()`` is the data-parallel counterpart of that training
step: DDP_WORLD ranks on one card, each with a replica of the same model,
train_entry()'s tokens and targets as the global batch, and the gradient
mean on the ring allreduce kernel. ``dp_tp_train_entry()`` is the dp x tp
training step of dryrun_multichip: a mesh DP_TP_MESH of ranks on one card,
the weights split over "model" as its layer_spec splits them, the same
global batch split over "data". ``sp_entry()`` is the counterpart of the
dry run's sequence-parallel sections (ring_attention, ulysses_attention,
__graft_entry__.py:182-248) at the flagship's attention width: its 4 heads
of head_dim 64, bf16, causal, over a global sequence of SP_SEQ split over
SP_MESH ranks on one card. ``ep_entry()`` is its dispatch_combine section
(:227-233): EP_TOKENS tokens per rank of width d_model routed over a mesh
EP_MESH of experts on one card, each the flagship's MLP at full width.
``ring_variants_entry()`` is the dry run's last section (the HBM-streaming,
int8-wire and bidirectional ring allreduces, __graft_entry__.py:340-373)
over DDP_WORLD ranks on one card, on the flagship's gradient buffer.
``fsdp_train_entry()`` is its FSDP section (:250-271) at the flagship's
full width: train_entry()'s weights sharded over FSDP_MESH ranks on one
card, SGD on the shards (the reference's FSDP step). ``pp_entry()`` is its
pipeline section (:202-225): the flagship's width at a depth of PP_STAGES
layers, one block per stage over PP_MESH ranks on one card, GPipe forward
and the 1F1B training step over PP_MICROBATCHES microbatches.
``hier_ddp_entry()`` and ``host_ddp_entry()`` are the host plane's
counterparts of ddp_train_entry(), one OS process per "host" over a
FileStore: the two-level DDP of gloo_tpu/tpu/hierarchical.py
(make_hierarchical_ddp, HIER_LOCAL ranks of the card in each process) and
HostGradSync over one replica's CUDA gradients (gloo_tpu/parallel/ddp.py).
``elastic_train_entry()`` is the acceptance run's process
(tests/test_e2e_acceptance.py at the flagship's width): it joins through
init_from_env, trains hier_ddp_entry()'s two-level step on batches drawn
per process and step, checkpoints, and rebuilds and resumes after a peer
dies. ``elastic_step_fn()`` is one flagship replica's step for
elastic.run_elastic, its gradients averaged with the epoch's bucketer.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import os
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gloo_tpu_torch.bootstrap import init_from_env
from gloo_tpu_torch.checkpoint import StepCheckpointer
from gloo_tpu_torch.core import (Aborted, Context, Device, FileStore,
                                 IoError, TcpStore, TcpStoreServer)
from gloo_tpu_torch.device import resolve_device
from gloo_tpu_torch.models.transformer import (Transformer,
                                               TransformerConfig, _rmsnorm,
                                               world_block)
from gloo_tpu_torch.ops.ring import (ring_allreduce_bidir,
                                     ring_allreduce_hbm, ring_allreduce_q8)
from gloo_tpu_torch.parallel.ddp import (HostGradSync, buffer_width,
                                         make_ddp_train_step)
from gloo_tpu_torch.parallel.dp_tp import (make_dp_tp_train_step,
                                           shard_transformer, world_batch)
from gloo_tpu_torch.parallel.ep import dispatch_combine
from gloo_tpu_torch.parallel.fsdp import make_fsdp_train_step, shard_params
from gloo_tpu_torch.parallel.pp import pipeline_apply, pipeline_train_1f1b
from gloo_tpu_torch.parallel.sp import (ring_attention, ring_flash_attention,
                                        ulysses_attention)
from gloo_tpu_torch.tpu.hierarchical import (HierarchicalGroup,
                                             make_hierarchical_ddp)
from gloo_tpu_torch.tpu.mesh import make_mesh
from gloo_tpu_torch.weights import (pipeline_stages_from_numpy,
                                    transformer_params_to_numpy)

ENTRY_CONFIG = TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                                 n_layers=2, d_ff=1024, max_seq_len=128,
                                 use_flash_attention=True)
ENTRY_BATCH = 8
# The flagship at its width with one head of 256 (the head width the Gemma
# family publishes) in f16: the configuration whose serving and training
# path runs the flash kernels' d 256 and f16 instances. Same vocab, widths,
# depth, sequence, batch, tokens and weight seed as ENTRY_CONFIG.
D256_F16_CONFIG = dataclasses.replace(ENTRY_CONFIG, n_heads=1,
                                      dtype=torch.float16)
# optax.adam(1e-3): its defaults, eps outside the square root, no decay.
ADAM_SETTINGS = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
# Ranks of ddp_train_entry's world, all on one card: ENTRY_BATCH / DDP_WORLD
# sequences each.
DDP_WORLD = 4
# dp_tp_train_entry's mesh, all on one card: ENTRY_BATCH / 2 sequences per
# data rank, two heads and d_ff / 2 per model rank.
DP_TP_MESH = {"data": 2, "model": 2}
# sp_entry's mesh, all on one card, and its global sequence and batch:
# t_local = SP_SEQ / 4 = 1024 rows per rank, 16 of the kernels' 64-row
# tiles (the flagship's seq of 128 would leave 32 rows per rank).
SP_MESH = {"seq": 4}
SP_SEQ = 4096
SP_BATCH = 2
# ep_entry's mesh of experts, all on one card, its tokens per rank, and the
# slots each rank reserves per expert: EP_TOKENS / 4, the uniform mean, so
# some tokens overflow and are dropped.
EP_MESH = {"expert": 4}
EP_TOKENS = 256
EP_CAPACITY = 64
# ring_variants_entry lays each rank's gradient buffer out as rows of
# RING_VARIANT_COLS f32, rows a multiple of 32 DDP_WORLD: the smallest
# layout that all three variants take (the bidirectional split needs
# cols % 256 == 0, the int8 ring chunks of a multiple of 32 rows).
RING_VARIANT_COLS = 256
# fsdp_train_entry's mesh, all on one card: ENTRY_BATCH / 4 sequences per
# rank, 1/4 of every parameter.
FSDP_MESH = {"data": 4}
# make_fsdp_train_step's SGD rate, the reference's default.
FSDP_LR = 1e-2
# pp_entry's mesh of stages, all on one card, its depth (one block per
# stage) and its microbatches: one sequence of the entry batch each, so
# M = 2 S (11 GPipe ticks, 22 1F1B ticks).
PP_MESH = {"pipe": 4}
PP_STAGES = PP_MESH["pipe"]
PP_MICROBATCHES = ENTRY_BATCH
# hier_ddp_entry's local ranks per process, all on its card, and the
# sequences each process of hier_ddp_entry and host_ddp_entry takes from the
# entry batch: process r takes [HOST_SEQS r, HOST_SEQS (r + 1)), so two
# processes split the batch 4 + 4, and two local ranks each take 2.
HIER_LOCAL = 2
HOST_SEQS = 4
# Seconds the host plane's rendezvous and collectives wait for a peer.
HOST_TIMEOUT = 120.0
# elastic_train_entry's checkpoints: one every ELASTIC_CKPT_EVERY steps,
# the newest ELASTIC_KEEP kept; and the seed of its batches, 1234 + the
# process's launch rank as in the reference's acceptance run.
ELASTIC_CKPT_EVERY = 2
ELASTIC_KEEP = 2
ELASTIC_SEED = 1234


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The served forward: logits (batch, seq, vocab) f32."""
    with torch.inference_mode():
        return model(tokens)


def _entry_tokens() -> np.ndarray:
    cfg = ENTRY_CONFIG
    return np.random.RandomState(0).randint(
        0, cfg.vocab_size, (ENTRY_BATCH, cfg.max_seq_len))


def entry(device="cuda"):
    """Returns (fn, (model, tokens)) with both on `device`; fn(model,
    tokens) is the transformer forward."""
    return _config_entry(ENTRY_CONFIG, device)


def d256_f16_entry(device="cuda"):
    """entry() at D256_F16_CONFIG: one head of 256, f16."""
    return _config_entry(D256_F16_CONFIG, device)


def _config_entry(cfg: TransformerConfig, device):
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev).init(
        torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(_entry_tokens(), dtype=torch.int32, device=dev)
    return forward, (model, tokens)


def train_step(model: Transformer, optimizer: torch.optim.Optimizer,
               tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """One step: loss, gradients, Adam update. Returns the loss (a 0-d f32
    tensor on the model's device, computed before the update); the
    gradients stay in the parameters' .grad until the next step."""
    optimizer.zero_grad(set_to_none=True)
    loss = model.loss(tokens, targets)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_entry(device="cuda"):
    """Returns (train_step, (model, optimizer, tokens, targets)) on
    `device`: entry()'s model and tokens, targets the tokens shifted left
    by one (np.roll, as the JAX step), and torch.optim.Adam at
    ADAM_SETTINGS."""
    return _config_train_entry(ENTRY_CONFIG, device)


def d256_f16_train_entry(device="cuda"):
    """train_entry() at D256_F16_CONFIG: one head of 256, f16."""
    return _config_train_entry(D256_F16_CONFIG, device)


def _config_train_entry(cfg: TransformerConfig, device):
    _, (model, tokens) = _config_entry(cfg, device)
    optimizer = torch.optim.Adam(model.parameters(), **ADAM_SETTINGS)
    return train_step, (model, optimizer, tokens, _entry_targets(tokens))


def _entry_targets(tokens: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.roll(_entry_tokens(), -1, axis=1),
                           dtype=torch.int32, device=tokens.device)


def _lm_loss(model: Transformer, batch) -> torch.Tensor:
    tokens, targets = batch
    return model.loss(tokens, targets)


def _replicas(model: Transformer, count: int) -> List[Transformer]:
    """model and count - 1 copies of it on its device."""
    dev = next(model.parameters()).device
    replicas = [model]
    for _ in range(count - 1):
        replica = Transformer(ENTRY_CONFIG, device=dev)
        replica.load_state_dict(model.state_dict())
        replicas.append(replica)
    return replicas


def _adam(models) -> list:
    """An Adam at ADAM_SETTINGS for each model."""
    return [torch.optim.Adam(m.parameters(), **ADAM_SETTINGS)
            for m in models]


def ddp_train_entry(device="cuda"):
    """Returns (step, (replicas, optimizers, (tokens, targets))) on
    `device`: a mesh {"data": DDP_WORLD} of ranks on that one device, one
    replica per rank loaded from train_entry()'s weights, one Adam at
    ADAM_SETTINGS each, and train_entry()'s tokens and targets as the
    global batch. step(replicas, optimizers, (tokens, targets)) is
    make_ddp_train_step's: it returns the mean of the rank losses."""
    _, (model, tokens) = entry(device)
    dev = tokens.device
    mesh = make_mesh({"data": DDP_WORLD}, devices=[dev] * DDP_WORLD)
    replicas = _replicas(model, DDP_WORLD)
    optimizers = _adam(replicas)
    step = make_ddp_train_step(_lm_loss, mesh, "data")
    return step, (replicas, optimizers, (tokens, _entry_targets(tokens)))


def dp_tp_train_entry(device="cuda"):
    """Returns (step, (tp_model, optimizer, tokens, targets)) on `device`:
    a mesh DP_TP_MESH of ranks on that one device, train_entry()'s weights
    sharded along "model" (shard_transformer), one Adam at ADAM_SETTINGS
    over the world parameters, and train_entry()'s tokens and targets as
    the global batch. step(tp_model, optimizer, tokens, targets) is
    make_dp_tp_train_step's: it returns the global mean loss."""
    _, (model, tokens) = entry(device)
    dev = tokens.device
    ranks = DP_TP_MESH["data"] * DP_TP_MESH["model"]
    mesh = make_mesh(DP_TP_MESH, devices=[dev] * ranks)
    tp_model = shard_transformer(model, mesh, "model")
    optimizer = torch.optim.Adam(tp_model.parameters(), **ADAM_SETTINGS)
    step = make_dp_tp_train_step(mesh, "data", "model")
    return step, (tp_model, optimizer, tokens, _entry_targets(tokens))


def sp_step(attn, q, k, v, mesh):
    """Forward and backward of one sequence-parallel attention `attn`
    (ring_flash_attention or ulysses_attention) over the world tensors q,
    k, v along "seq": (out, (dq, dk, dv)), the gradients those of
    sum(sin(out)), the loss of the JAX package's sequence-parallel tests."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out = attn(*leaves, "seq", mesh=mesh)
        grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    return out.detach(), grads


def sp_forward(attn, q, k, v, mesh):
    """The forward of `attn` alone (ring_attention has no kernel)."""
    with torch.no_grad():
        return attn(q, k, v, "seq", mesh=mesh)


def sp_entry(device="cuda", seq: int = SP_SEQ):
    """The long-context path: {"ring_flash": (sp_step, args), "ulysses":
    (sp_step, args), "ring_attention": (sp_forward, args)}, each fn(*args).
    args = (the attention, q, k, v, mesh): a mesh SP_MESH of ranks on
    `device`, and q, k, v world tensors (4, SP_BATCH, 4 heads, seq / 4,
    64) in bf16 drawn in that order from np.random.RandomState(0)."""
    dev = resolve_device(device)
    n = SP_MESH["seq"]
    mesh = make_mesh(SP_MESH, devices=[dev] * n)
    cfg = ENTRY_CONFIG
    shape = (n, SP_BATCH, cfg.n_heads, seq // n, cfg.d_model // cfg.n_heads)
    rng = np.random.RandomState(0)
    q, k, v = (torch.as_tensor(rng.randn(*shape).astype(np.float32))
               .to(dev, torch.bfloat16) for _ in range(3))
    return {"ring_flash": (sp_step, (ring_flash_attention, q, k, v, mesh)),
            "ulysses": (sp_step, (ulysses_attention, q, k, v, mesh)),
            "ring_attention": (sp_forward, (ring_attention, q, k, v, mesh))}


def expert_mlp(x: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """Each rank's expert, the flagship's MLP: gelu(x @ w_up) @ w_down with
    the tanh GELU, over world tensors x (P, rows, d), w_up (P, d, d_ff),
    w_down (P, d_ff, d) (cuBLAS products, as XLA's outside any kernel)."""
    return torch.bmm(F.gelu(torch.bmm(x, w_up), approximate="tanh"), w_down)


def ep_step(tokens, expert_idx, w_up, w_down, mesh):
    """Forward and backward of dispatch_combine with expert_mlp along
    "expert": (out, (d tokens, d w_up, d w_down)), the gradients those of
    sum(sin(out))."""
    leaves = [x.detach().requires_grad_() for x in (tokens, w_up, w_down)]
    with torch.enable_grad():
        out = dispatch_combine(
            lambda x: expert_mlp(x, leaves[1], leaves[2]), leaves[0],
            expert_idx, EP_CAPACITY, "expert", mesh=mesh)
        grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    return out.detach(), grads


def ep_entry(device="cuda"):
    """The MoE path: (ep_step, (tokens, expert_idx, w_up, w_down, mesh)) on
    `device`: a mesh EP_MESH of ranks on that device; tokens (4, EP_TOKENS,
    d_model) bf16, expert_idx (4, EP_TOKENS) from randint(0, 4), w_up (4,
    d_model, d_ff) / sqrt(d_model) and w_down (4, d_ff, d_model) /
    sqrt(d_ff) bf16, drawn in that order from np.random.RandomState(0)."""
    dev = resolve_device(device)
    n = EP_MESH["expert"]
    mesh = make_mesh(EP_MESH, devices=[dev] * n)
    d, f = ENTRY_CONFIG.d_model, ENTRY_CONFIG.d_ff
    rng = np.random.RandomState(0)
    tokens = rng.randn(n, EP_TOKENS, d)
    expert_idx = rng.randint(0, n, (n, EP_TOKENS))
    w_up = rng.randn(n, d, f) / math.sqrt(d)
    w_down = rng.randn(n, f, d) / math.sqrt(f)

    def bf16(x):
        return torch.as_tensor(x.astype(np.float32)).to(dev, torch.bfloat16)

    return ep_step, (bf16(tokens), torch.as_tensor(expert_idx, device=dev),
                     bf16(w_up), bf16(w_down), mesh)


def ring_variant_step(variant, x, mesh):
    """Forward and backward of one allreduce variant (ring_allreduce_hbm,
    _q8 or _bidir) of the world tensor x along "data": (y, dL/dx) for
    L = sum(y ** 2), the loss of the JAX package's ring gradient test
    (tests/test_pallas_ring.py:124). Two launches: the forward and its
    VJP."""
    leaf = x.detach().requires_grad_()
    with torch.enable_grad():
        y = variant(leaf, "data", mesh)
        (grad,) = torch.autograd.grad((y ** 2).sum(), leaf)
    return y.detach(), grad


def ring_variants_entry(device="cuda"):
    """The ring-variant path: {"hbm": (ring_variant_step, args), "q8": ...,
    "bidir": ...}, each fn(*args), args = (the variant, x, mesh): a mesh
    {"data": DDP_WORLD} of ranks on `device` and x the flagship's gradient
    buffer on each rank (buffer_width f32: every parameter's gradient and
    the loss, here np.random.RandomState(7).randn, the dry run's ring_rng),
    zero-padded to (DDP_WORLD, rows, RING_VARIANT_COLS): (4, 6912, 256)
    f32, 7.08 MB per rank."""
    dev = resolve_device(device)
    mesh = make_mesh({"data": DDP_WORLD}, devices=[dev] * DDP_WORLD)
    numel = sum(p.numel() for p in
                Transformer(ENTRY_CONFIG, device="meta").parameters())
    width = buffer_width(numel, DDP_WORLD)
    quantum = 32 * DDP_WORLD
    rows = -(-width // (quantum * RING_VARIANT_COLS)) * quantum
    buf = np.zeros((DDP_WORLD, rows * RING_VARIANT_COLS), np.float32)
    buf[:, :width] = np.random.RandomState(7).randn(DDP_WORLD, width)
    x = torch.as_tensor(buf.reshape(DDP_WORLD, rows, RING_VARIANT_COLS))
    x = x.to(dev)
    return {name: (ring_variant_step, (variant, x, mesh))
            for name, variant in (("hbm", ring_allreduce_hbm),
                                  ("q8", ring_allreduce_q8),
                                  ("bidir", ring_allreduce_bidir))}


def fsdp_train_entry(device="cuda"):
    """Returns (step, (sharded, (tokens, targets))) on `device`: a mesh
    FSDP_MESH of ranks on that one device, train_entry()'s weights sharded
    over "data" (shard_params: 15 leaves, (4, chunk) world tensors), and
    train_entry()'s tokens and targets as world tensors (4, 2, seq), 2
    sequences per rank. step(sharded, batch) is make_fsdp_train_step's at
    FSDP_LR (SGD, as the reference's FSDP step): it returns the new
    shards and the (4,) global mean loss. Each step launches B4b and B4a
    once per leaf, B3 once, and B1/B2 once per layer and rank."""
    _, (model, tokens) = entry(device)
    dev = tokens.device
    n = FSDP_MESH["data"]
    mesh = make_mesh(FSDP_MESH, devices=[dev] * n)
    params = {name: p.detach() for name, p in model.named_parameters()}
    shell = Transformer(ENTRY_CONFIG, device="meta")

    def loss_fn(rank_params, batch):
        rank_tokens, rank_targets = batch
        logits = torch.func.functional_call(shell, rank_params,
                                            (rank_tokens,))
        return F.cross_entropy(logits.flatten(0, 1),
                               rank_targets.flatten().long())

    step = make_fsdp_train_step(loss_fn, params, "data", lr=FSDP_LR,
                                mesh=mesh)
    batch = (world_batch(tokens, mesh), world_batch(_entry_targets(tokens),
                                                    mesh))
    return step, (shard_params(params, "data", mesh=mesh), batch)


def pp_forward(stage_fn, stages, xs, mesh):
    """The GPipe forward (pipeline_apply along "pipe"): (P, M, ...) outputs,
    the last stage's rows meaningful."""
    with torch.no_grad():
        return pipeline_apply(stage_fn, stages, xs, "pipe", mesh=mesh)


def pp_train(stage_fn, loss_fn, stages, xs, ys, mesh):
    """The 1F1B training step (pipeline_train_1f1b along "pipe"): (grads,
    loss_sum), grads summed over the microbatches."""
    return pipeline_train_1f1b(stage_fn, loss_fn, stages, xs, ys, "pipe",
                               mesh=mesh)


def pp_entry(device="cuda"):
    """The pipeline path: {"gpipe": (pp_forward, (stage_fn, stages, xs,
    mesh)), "1f1b": (pp_train, (stage_fn, loss_fn, stages, xs, ys, mesh))},
    each fn(*args), on `device`.

    The model is the flagship at full width (ENTRY_CONFIG) at a depth of
    PP_STAGES layers in place of 2, its weights from Transformer.init with
    a generator seeded with 0; only the depth differs. A mesh PP_MESH of
    ranks on that one device; stage s is layer s (pipeline_stages_from_
    numpy), stage_fn models.transformer.world_block, one pre-norm block.
    xs (P, M, 1, seq, d_model) bf16: stage 0's input, embed[tokens] + pos
    of train_entry()'s tokens, one sequence per microbatch; ys (P, M, 1,
    seq) its next-token targets (both views of one copy, every rank's row
    the same). loss_fn(y, target) -> (P,) is next-token cross-entropy
    through the fixed ln_f and the tied embedding, closed over (the
    reference's loss takes no parameters)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(ENTRY_CONFIG, n_layers=PP_STAGES)
    n = PP_MESH["pipe"]
    mesh = make_mesh(PP_MESH, devices=[dev] * n)
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tree = transformer_params_to_numpy(model.state_dict(), cfg)
    stages = pipeline_stages_from_numpy(tree, cfg, mesh)
    embed = torch.as_tensor(tree["embed"], device=dev)
    ln_f = torch.as_tensor(tree["ln_f"]["scale"], device=dev)
    tokens = torch.as_tensor(_entry_tokens(), device=dev)
    x = embed[tokens] + torch.as_tensor(tree["pos"], device=dev)
    xs = x.to(cfg.dtype)[:, None].expand(n, *x.shape[:1], 1, *x.shape[1:])
    ys = torch.as_tensor(np.roll(_entry_tokens(), -1, axis=1), device=dev)
    ys = ys[:, None].expand(n, *ys.shape[:1], 1, *ys.shape[1:])

    def loss_fn(y, target):
        logits = _rmsnorm(y, ln_f).float() @ embed.T
        nll = F.cross_entropy(logits.flatten(0, -2), target.flatten(),
                              reduction="none")
        return nll.view(y.shape[0], -1).mean(1)

    stage_fn = functools.partial(world_block, cfg)
    return {"gpipe": (pp_forward, (stage_fn, stages, xs, mesh)),
            "1f1b": (pp_train, (stage_fn, loss_fn, stages, xs, ys, mesh))}


def _host_part(rank: int, size: int, tokens: torch.Tensor):
    if not 0 <= rank < size or size * HOST_SEQS > ENTRY_BATCH:
        raise ValueError(f"rank {rank} of {size}: the entry batch of "
                         f"{ENTRY_BATCH} sequences holds {HOST_SEQS} per "
                         f"process for at most "
                         f"{ENTRY_BATCH // HOST_SEQS} processes")
    lo = HOST_SEQS * rank
    targets = _entry_targets(tokens)
    return tokens[lo:lo + HOST_SEQS], targets[lo:lo + HOST_SEQS]


def _host_context(rank: int, size: int, store_dir: str) -> Context:
    ctx = Context(rank, size, timeout=HOST_TIMEOUT)
    ctx.connect_full_mesh(FileStore(store_dir), Device())
    return ctx


def hier_ddp_entry(rank: int, size: int, store_dir: str, device="cuda",
                   context: Optional[Context] = None):
    """The two-level DDP path of one process ("host") `rank` of `size`:
    returns (step, (replicas, optimizers, (tokens, targets))) on `device`.

    The process's host-plane Context rendezvouses with the others over a
    FileStore in `store_dir` (a directory every process sees), or is
    `context`, a Context of `size` ranks the caller connected (over a
    Device with a key and encryption, say). It holds a
    mesh {"local": HIER_LOCAL} of ranks on `device`, each with a replica
    of train_entry()'s model and an Adam at ADAM_SETTINGS, and takes
    sequences [HOST_SEQS rank, HOST_SEQS (rank + 1)) of the entry batch,
    HOST_SEQS / HIER_LOCAL per local rank. step is make_hierarchical_ddp's
    (its group, and the group's ctx to close, are step.group and
    step.group.ctx); it returns the local mean loss. Each step launches
    B1 and B2 once per layer and local rank, and B3 once. With size 2 this
    is ddp_train_entry()'s split of the batch, 4 ranks of 2 sequences,
    done as 2 hosts x 2 local ranks."""
    dev = resolve_device(device)
    _, (model, tokens) = entry(dev)
    batch = _host_part(rank, size, tokens)
    replicas = _replicas(model, HIER_LOCAL)
    optimizers = _adam(replicas)
    if context is None:
        context = _host_context(rank, size, store_dir)
    group = HierarchicalGroup(context, devices=[dev] * HIER_LOCAL)
    step = make_hierarchical_ddp(_lm_loss, group)
    return step, (replicas, optimizers, batch)


def host_ddp_entry(rank: int, size: int, store_dir: str, device="cuda",
                   bucketed: bool = True):
    """The host-plane DDP path of one process `rank` of `size`: returns
    (step, (model, optimizer, (tokens, targets))) on `device`.

    One replica of train_entry()'s model per process, an Adam at
    ADAM_SETTINGS, and sequences [HOST_SEQS rank, HOST_SEQS (rank + 1))
    of the entry batch; the Context rendezvouses over a FileStore in
    `store_dir`. step(model, optimizer, batch) runs the forward and
    backward, averages the gradients over the processes with HostGradSync
    (bucketed or sequential; a CUDA gradient is staged through pinned
    memory), makes them the parameters' .grad, steps the optimizer, and
    returns the local loss. step.sync is the HostGradSync (step.sync.
    context to close). Its construction is a collective when bucketed."""
    dev = resolve_device(device)
    _, (model, tokens) = entry(dev)
    batch = _host_part(rank, size, tokens)
    optimizer = torch.optim.Adam(model.parameters(), **ADAM_SETTINGS)
    sync = HostGradSync(_host_context(rank, size, store_dir),
                        bucketed=bucketed)

    def step(model, optimizer, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = _lm_loss(model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        mean = sync.average({name: p.grad for name, p in params.items()})
        for name, p in params.items():
            p.grad = mean[name]
        optimizer.step()
        return loss.detach()

    step.sync = sync
    return step, (model, optimizer, batch)


def elastic_batch(launch_rank: int, step: int, device="cuda"):
    """(tokens, targets) of one process at one step: HOST_SEQS sequences
    of ENTRY_CONFIG.max_seq_len tokens (targets the next tokens), drawn on
    the CPU from a torch.Generator seeded by (ELASTIC_SEED + launch_rank,
    step), so that a step replayed after a resume sees the same batch.
    Token k comes with probability proportional to 1 / (k + 1), a Zipf
    law as in text, so that a few steps visibly lower the loss on batches
    that are new at every step."""
    cfg = ENTRY_CONFIG
    # The CPU generator keeps 32 bits of its seed.
    gen = torch.Generator().manual_seed(
        (ELASTIC_SEED + launch_rank) * 1_000_003 + step)
    zipf = 1.0 / torch.arange(1, cfg.vocab_size + 1, dtype=torch.float64)
    seq = torch.multinomial(zipf, HOST_SEQS * (cfg.max_seq_len + 1),
                            replacement=True, generator=gen)
    seq = seq.view(HOST_SEQS, -1).to(torch.int32)
    return (seq[:, :-1].contiguous().to(device),
            seq[:, 1:].contiguous().to(device))


@dataclasses.dataclass
class ElasticTrainer:
    """One process of the acceptance run (elastic_train_entry's result).

    ctx: the host-plane Context (rank 0's process also holds the TcpStore
    server, `server`); replicas and optimizers: HIER_LOCAL flagship
    replicas on the card with an Adam each; step_fn: make_hierarchical_ddp
    over ctx; checkpointer: the StepCheckpointer that rank 0 writes."""

    ctx: Context
    server: Optional[TcpStoreServer]
    launch_rank: int
    device: torch.device
    replicas: List[Transformer]
    optimizers: list
    checkpointer: StepCheckpointer
    step_fn: Callable

    def batch(self, step: int):
        return elastic_batch(self.launch_rank, step, self.device)

    def step(self, step: int) -> torch.Tensor:
        """The two-level step on this process's batch at `step`: the local
        mean loss. An IoError means a peer died (rebuild, then restore)."""
        return self.step_fn(self.replicas, self.optimizers, self.batch(step))

    def state(self, step: int, local: int = 0) -> dict:
        """What a checkpoint holds: local replica `local`'s and its
        Adam's state_dicts (the live tensors) and the step; rank 0 saves
        replica 0's."""
        return {"model": self.replicas[local].state_dict(),
                "adam": self.optimizers[local].state_dict(), "step": step}

    def save(self, step: int) -> bool:
        """Rank 0 saves state(step) every ELASTIC_CKPT_EVERY steps (a
        replayed step replaces its checkpoint); True where it saved."""
        if self.ctx.rank != 0 or step % ELASTIC_CKPT_EVERY:
            return False
        self.checkpointer.save(step, self.state(step), force=True)
        return True

    def store(self) -> TcpStore:
        """A client of the launch's TcpStore (rank 0's server)."""
        return TcpStore(os.environ.get("MASTER_ADDR", "127.0.0.1"),
                        int(os.environ["MASTER_PORT"]))

    def rebuild(self, generation: int, min_size: int = 2,
                settle: float = 3.0) -> bool:
        """After a failed step: close the poisoned context and form the
        survivors' group with resilience.rebuild_after_failure through the
        same store; the step then runs over the new context. False when
        fewer than min_size processes are left."""
        from gloo_tpu_torch.resilience import rebuild_after_failure

        failed = self.ctx
        failed.close()
        ctx, _, _ = rebuild_after_failure(
            self.store(), Device(), old_rank=failed.rank,
            old_size=failed.size, generation=generation, settle=settle,
            timeout=HOST_TIMEOUT, min_size=min_size, failed_context=failed)
        if ctx is None:
            return False
        self.ctx = ctx
        group = HierarchicalGroup(ctx, devices=self.step_fn.group.devices)
        self.step_fn = make_hierarchical_ddp(_lm_loss, group)
        return True

    def restore(self):
        """load_latest with the live state as the template (so the tensors
        come back on the card), loaded into every replica and optimizer.
        Returns (checkpoint step, loaded state), or (None, None)."""
        at, state = self.checkpointer.load_latest(self.state(0))
        if at is not None:
            for model, opt in zip(self.replicas, self.optimizers):
                model.load_state_dict(state["model"])
                # load_state_dict adopts the tensors that need no cast:
                # each optimizer gets its own copy of the moments.
                opt.load_state_dict(copy.deepcopy(state["adam"]))
        return at, state


def elastic_train_entry(rank: int, size: int, ckpt_dir: str,
                        device="cuda") -> ElasticTrainer:
    """One process of the acceptance run at the flagship's width: process
    `rank` of `size` joins through init_from_env (RANK and WORLD_SIZE are
    these; MASTER_ADDR and MASTER_PORT come from the environment, and
    rank 0 serves the TcpStore), holds HIER_LOCAL replicas of
    train_entry()'s seed-0 model on `device`, each with an Adam at
    ADAM_SETTINGS, and trains them with make_hierarchical_ddp on
    elastic_batch(rank, step). Rank 0 checkpoints into `ckpt_dir` (a
    directory every process sees) with StepCheckpointer(keep=
    ELASTIC_KEEP). Each step launches B1 and B2 once per layer and local
    rank, and B3 once."""
    dev = resolve_device(device)
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(size))
    ctx, server = init_from_env(timeout=HOST_TIMEOUT, env=env)
    _, (model, _) = entry(dev)
    replicas = _replicas(model, HIER_LOCAL)
    group = HierarchicalGroup(ctx, devices=[dev] * HIER_LOCAL)
    return ElasticTrainer(
        ctx=ctx, server=server, launch_rank=rank, device=dev,
        replicas=replicas, optimizers=_adam(replicas),
        checkpointer=StepCheckpointer(ckpt_dir, keep=ELASTIC_KEEP),
        step_fn=make_hierarchical_ddp(_lm_loss, group))


def elastic_step_fn(launch_rank: int, checkpointer: StepCheckpointer,
                    device="cuda"):
    """(step_fn, template) for elastic.run_elastic over one flagship
    replica per process on `device` (train_entry()'s seed-0 model, Adam at
    ADAM_SETTINGS).

    step_fn(ectx, step, state) runs the forward and backward on
    elastic_batch(launch_rank, step), averages the gradients over the
    epoch's processes with ectx.bucketer(), steps the optimizer, and has the
    epoch's rank 0 save {"model", "adam"} every ELASTIC_CKPT_EVERY steps;
    it returns None. A state that run_elastic hands back after a rebuild
    (a loaded checkpoint) is loaded into the model and the optimizer
    first. template keeps the model's tensors on the card (Adam's state
    is loaded as saved, then placed by load_state_dict). step_fn.model is
    the replica."""
    dev = resolve_device(device)
    _, (model, _) = entry(dev)
    optimizer = torch.optim.Adam(model.parameters(), **ADAM_SETTINGS)
    params = list(model.parameters())

    def step_fn(ectx, step, state):
        if state is not None:
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["adam"])
        optimizer.zero_grad(set_to_none=True)
        _lm_loss(model, elastic_batch(launch_rank, step, dev)).backward()
        bucketer = ectx.bucketer()
        for p in params:
            bucketer.add(p.grad)
        try:
            bucketer.finish()
        except (IoError, Aborted) as exc:
            ectx.translate_failure(exc)  # EpochChanged, or exc again
        optimizer.step()
        if ectx.rank == 0 and step % ELASTIC_CKPT_EVERY == 0:
            checkpointer.save(step, {"model": model.state_dict(),
                                     "adam": optimizer.state_dict()},
                              force=True)
        return None

    step_fn.model = model
    return step_fn, {"model": model.state_dict(), "adam": None}
