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
d 256 and f16 instances; ``d36_entry()``, ``d36_train_entry()``,
``d512_entry()`` and ``d512_train_entry()`` are the same at D36_CONFIG (8
heads of 36: the zero-padded d 64 instances) and D512_CONFIG (one head of
512: the wide kernels past 256). ``train_entry()`` is the one-device
counterpart of the training step of ``__graft_entry__.dryrun_multichip``:
the same model and
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
``multihost_ddp_entry()`` is ddp_train_entry() at one process per rank:
init_multihost's process mesh, one replica in each process, and the
gradient mean on the cross-process ring allreduce over peer-mapped memory.
``fused_mlp_entry()`` is the dry run's fused Megatron-SP pair (:286-338)
at the flagship's full MLP width: FUSED_MLP_ROWS token rows over a ring
of FUSED_MLP_MESH ranks on one card, forward and backward.
``multihost_dp_tp_entry()``, ``multihost_fused_mlp_entry()``,
``multihost_ep_entry()``, ``multihost_ring_variants_entry()``,
``multihost_fsdp_entry()``, ``multihost_sp_entry()`` and
``multihost_pp_entry()`` are dp_tp_train_entry(), fused_mlp_entry(),
ep_entry(), ring_variants_entry(), fsdp_train_entry(), sp_entry() and
pp_entry() split over processes
(one rank each at their world's size): each process holds its local
ranks' rows, the collectives are the kernels' cross-process instances,
and spmd's shift is the transport over the peer workspace.
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
from gloo_tpu_torch.parallel.dp_tp import (data_share,
                                           make_dp_tp_train_step,
                                           shard_transformer, world_batch)
from gloo_tpu_torch.parallel.ep import dispatch_combine
from gloo_tpu_torch.parallel.fsdp import make_fsdp_train_step, shard_params
from gloo_tpu_torch.parallel.pp import pipeline_apply, pipeline_train_1f1b
from gloo_tpu_torch.parallel.sp import (ring_attention, ring_flash_attention,
                                        ulysses_attention)
from gloo_tpu_torch.parallel.tp import (allgather_matmul_dense,
                                        allgather_matmul_dense_auto,
                                        row_parallel_dense_scattered,
                                        row_parallel_dense_scattered_auto)
from gloo_tpu_torch.tpu.hierarchical import (HierarchicalGroup,
                                             make_hierarchical_ddp)
from gloo_tpu_torch.tpu.mesh import make_mesh
from gloo_tpu_torch.tpu.multihost import init_multihost
from gloo_tpu_torch.weights import (pipeline_stages_from_numpy,
                                    tp_transformer_from_numpy,
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
# The flagship at head widths the flash kernels have no instance of, in
# bf16, with the same vocab, d_ff, depth, sequence, batch, tokens and
# weight seed as ENTRY_CONFIG. D36_CONFIG: d_model 288 over 8 heads of 36,
# a width 8 does not divide (the kernels zero-pad it to their d 64
# instance); no model the repo names uses it, it stands for such widths.
# D512_CONFIG: d_model 512 as one head of 512, past every instance (the
# wide kernels); no reference model has a head wider than 256 (Gemma's
# 256 is D256_F16_CONFIG's), and the reference's Transformer runs both.
D36_CONFIG = dataclasses.replace(ENTRY_CONFIG, d_model=288, n_heads=8)
D512_CONFIG = dataclasses.replace(ENTRY_CONFIG, d_model=512, n_heads=1)
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
# fused_mlp_entry's ring, all on one card, and its token rows: the entry
# batch's ENTRY_BATCH x max_seq_len rows, 256 per rank, through the
# flagship's MLP (d_model 256, d_ff 1024: 256 columns per rank).
FUSED_MLP_MESH = {"model": 4}
FUSED_MLP_ROWS = ENTRY_BATCH * ENTRY_CONFIG.max_seq_len
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


def d36_entry(device="cuda"):
    """entry() at D36_CONFIG: 8 heads of 36, bf16."""
    return _config_entry(D36_CONFIG, device)


def d512_entry(device="cuda"):
    """entry() at D512_CONFIG: one head of 512, bf16."""
    return _config_entry(D512_CONFIG, device)


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


def d36_train_entry(device="cuda"):
    """train_entry() at D36_CONFIG: 8 heads of 36, bf16."""
    return _config_train_entry(D36_CONFIG, device)


def d512_train_entry(device="cuda"):
    """train_entry() at D512_CONFIG: one head of 512, bf16."""
    return _config_train_entry(D512_CONFIG, device)


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


def multihost_ddp_entry(rank: int, size: int, store_address: str,
                        device="cuda", device_hostname: Optional[str] = None):
    """ddp_train_entry() at one process per rank: process `rank` of `size`
    returns (step, (replicas, optimizers, (tokens, targets))) on `device`.

    init_multihost(rank, size, store_address) wires the host plane (rank
    0 serves the TcpStore at store_address) and a process mesh {"data":
    size}, one rank per process: on cuda:(rank % device_count) for
    device="cuda", else on `device`. The process holds one replica of
    train_entry()'s model with an Adam at ADAM_SETTINGS, and takes
    sequences [ENTRY_BATCH / size rank, ENTRY_BATCH / size (rank + 1)) of
    the entry batch. step is make_ddp_train_step's over the process mesh:
    one cross-process B3 per step averages the gradients and the loss, and
    it returns the loss mean (its context to close: step.context). At
    size DDP_WORLD each step is ddp_train_entry()'s, split over
    processes."""
    if size < 1 or ENTRY_BATCH % size or not 0 <= rank < size:
        raise ValueError(f"rank {rank} of {size}: the entry batch of "
                         f"{ENTRY_BATCH} sequences splits evenly over 1, "
                         f"2, 4 or 8 processes")
    ctx, mesh = _process_mesh(rank, size, store_address, {"data": size},
                              device, device_hostname)
    _, (model, tokens) = entry(mesh.device)
    per = ENTRY_BATCH // size
    batch = (tokens[rank * per:(rank + 1) * per],
             _entry_targets(tokens)[rank * per:(rank + 1) * per])
    replicas = _replicas(model, len(mesh.local_ranks))
    step = make_ddp_train_step(_lm_loss, mesh, "data")
    step.context, step.mesh = ctx, mesh
    return step, (replicas, _adam(replicas), batch)


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


def _process_mesh(rank: int, size: int, store_address: str, axes: dict,
                  device, device_hostname: Optional[str]):
    """init_multihost for process `rank` of `size` over the mesh `axes`,
    its ranks split evenly over the processes: (ctx, mesh), this
    process's ranks on cuda:(rank % device_count) for device="cuda", else
    on `device`."""
    ranks = math.prod(axes.values())
    if size < 1 or ranks % size or not 0 <= rank < size:
        raise ValueError(f"rank {rank} of {size}: the mesh {axes} splits "
                         f"its {ranks} ranks evenly over a number of "
                         f"processes that divides {ranks}")
    dev = resolve_device(device)
    if dev == torch.device("cuda"):
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return init_multihost(rank, size, store_address, axes,
                          timeout=HOST_TIMEOUT,
                          device_hostname=device_hostname,
                          devices=[dev] * (ranks // size))


def multihost_dp_tp_entry(rank: int, size: int, store_address: str,
                          device="cuda",
                          device_hostname: Optional[str] = None):
    """dp_tp_train_entry() split over processes: process `rank` of `size`
    returns (step, (tp_model, optimizer, tokens, targets)) for its ranks
    of a process mesh DP_TP_MESH (one rank per process at size 4; see
    _process_mesh). tp_model holds train_entry()'s weights sharded along
    "model" (shard_transformer) for the local ranks, the optimizer is an
    Adam at ADAM_SETTINGS over them, and tokens and targets are the
    process's share of the entry batch (data_share: its data ranks'
    parts). step is make_dp_tp_train_step's over the process mesh: the
    row-parallel and gradient sums are the cross-process B3. It returns
    the global mean loss; its context to close is step.context."""
    ctx, mesh = _process_mesh(rank, size, store_address, DP_TP_MESH, device,
                              device_hostname)
    _, (model, tokens) = entry(mesh.device)
    tp_model = shard_transformer(model, mesh, "model")
    optimizer = torch.optim.Adam(tp_model.parameters(), **ADAM_SETTINGS)
    step = make_dp_tp_train_step(mesh, "data", "model")
    step.context, step.mesh = ctx, mesh
    return step, (tp_model, optimizer, data_share(tokens, mesh),
                  data_share(_entry_targets(tokens), mesh))


def fused_mlp_step(x, w_up, w_down, dy, mesh):
    """Forward and backward of the fused Megatron-SP MLP along "model":
    allgather_matmul_dense (B5b) up, the tanh GELU, row_parallel_dense_
    scattered (B5a) down; (y, (dx, dw_up, dw_down)), the gradients those
    of sum(y * dy) (B5a's VJP is B4b and two dots, B5b's is B5a with w
    transposed and one dot)."""
    leaves = [t.detach().requires_grad_() for t in (x, w_up, w_down)]
    with torch.enable_grad():
        h = allgather_matmul_dense(leaves[0], leaves[1], "model", mesh=mesh)
        y = row_parallel_dense_scattered(F.gelu(h, approximate="tanh"),
                                         leaves[2], "model", mesh=mesh)
        grads = torch.autograd.grad(y, leaves, dy)
    return y.detach(), grads


def _fused_mlp_draws(dev: torch.device, ranks):
    """fused_mlp_entry's x, w_up, w_down and dy for flat `ranks`: x (1024,
    d_model), w_up (d_model, d_ff) / sqrt(d_model), w_down (d_ff, d_model) /
    sqrt(d_ff) and dy (1024, d_model) drawn in that order from
    np.random.RandomState(0); x and dy split by rows, w_up by columns and
    w_down by rows over the ring; bf16."""
    n = FUSED_MLP_MESH["model"]
    d, f = ENTRY_CONFIG.d_model, ENTRY_CONFIG.d_ff
    rng = np.random.RandomState(0)
    x = rng.randn(FUSED_MLP_ROWS, d)
    w_up = rng.randn(d, f) / math.sqrt(d)
    w_down = rng.randn(f, d) / math.sqrt(f)
    dy = rng.randn(FUSED_MLP_ROWS, d)
    shards = (x.reshape(n, -1, d), w_up.reshape(d, n, -1).transpose(1, 0, 2),
              w_down.reshape(n, -1, d), dy.reshape(n, -1, d))
    return tuple(torch.as_tensor(np.ascontiguousarray(
        t[list(ranks)]).astype(np.float32)).to(dev, torch.bfloat16)
        for t in shards)


def fused_mlp_entry(device="cuda"):
    """The fused MLP path: (fused_mlp_step, (x, w_up, w_down, dy, mesh)) on
    `device`, a mesh FUSED_MLP_MESH of ranks on that device and the world
    tensors of _fused_mlp_draws: x and dy (4, 256, 256), w_up and w_down
    shards (4, 256, 256), bf16."""
    dev = resolve_device(device)
    n = FUSED_MLP_MESH["model"]
    mesh = make_mesh(FUSED_MLP_MESH, devices=[dev] * n)
    return fused_mlp_step, (*_fused_mlp_draws(dev, range(n)), mesh)


def multihost_fused_mlp_entry(rank: int, size: int, store_address: str,
                              device="cuda",
                              device_hostname: Optional[str] = None):
    """fused_mlp_entry() split over processes: (step, (x, w_up, w_down, dy,
    mesh)) for process `rank` of `size`, the tensors the rows of its ranks
    of a process mesh FUSED_MLP_MESH; step is fused_mlp_step (B5b, B5a and
    B4b across processes), its context to close step.context."""
    ctx, mesh = _process_mesh(rank, size, store_address, FUSED_MLP_MESH,
                              device, device_hostname)

    def step(*args):
        return fused_mlp_step(*args)

    step.context, step.mesh = ctx, mesh
    return step, (*_fused_mlp_draws(mesh.device, mesh.local_ranks), mesh)


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


def _sp_draws(dev: torch.device, ranks, seq: int):
    """sp_entry's q, k and v at the rows of flat `ranks`."""
    n = SP_MESH["seq"]
    cfg = ENTRY_CONFIG
    shape = (n, SP_BATCH, cfg.n_heads, seq // n, cfg.d_model // cfg.n_heads)
    rng = np.random.RandomState(0)
    rows = list(ranks)
    return tuple(torch.as_tensor(rng.randn(*shape).astype(np.float32)[rows])
                 .to(dev, torch.bfloat16) for _ in range(3))


def _sp_paths(step, forward, q, k, v, mesh):
    return {"ring_flash": (step, (ring_flash_attention, q, k, v, mesh)),
            "ulysses": (step, (ulysses_attention, q, k, v, mesh)),
            "ring_attention": (forward, (ring_attention, q, k, v, mesh))}


def sp_entry(device="cuda", seq: int = SP_SEQ):
    """The long-context path: {"ring_flash": (sp_step, args), "ulysses":
    (sp_step, args), "ring_attention": (sp_forward, args)}, each fn(*args).
    args = (the attention, q, k, v, mesh): a mesh SP_MESH of ranks on
    `device`, and q, k, v world tensors (4, SP_BATCH, 4 heads, seq / 4,
    64) in bf16 drawn in that order from np.random.RandomState(0)."""
    dev = resolve_device(device)
    n = SP_MESH["seq"]
    mesh = make_mesh(SP_MESH, devices=[dev] * n)
    return _sp_paths(sp_step, sp_forward, *_sp_draws(dev, range(n), seq),
                     mesh)


def multihost_sp_entry(rank: int, size: int, store_address: str,
                       device="cuda", device_hostname: Optional[str] = None,
                       seq: int = SP_SEQ):
    """sp_entry() split over processes: the same three paths for process
    `rank` of `size`, q, k and v the rows of its ranks of a process mesh
    SP_MESH (one rank per process at size 4; see _process_mesh). The
    kernels (B6, B7; B8, B1, B2) run on the local rows, K/V move between
    processes by spmd.shift (the transport) and Ulysses' exchanges by the
    cross-process B8. The steps' context to close: step.context, the same
    for the three paths."""
    ctx, mesh = _process_mesh(rank, size, store_address, SP_MESH, device,
                              device_hostname)

    def step(*args):
        return sp_step(*args)

    def forward(*args):
        return sp_forward(*args)

    for fn in (step, forward):
        fn.context, fn.mesh = ctx, mesh
    return _sp_paths(step, forward,
                     *_sp_draws(mesh.device, mesh.local_ranks, seq), mesh)


def expert_mlp(x: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """Each rank's expert, the flagship's MLP: gelu(x @ w_up) @ w_down with
    the tanh GELU, over world tensors x (P, rows, d), w_up (P, d, d_ff),
    w_down (P, d_ff, d) (cuBLAS products, as XLA's outside any kernel):
    one 2D product per rank, so a process that holds some of the ranks
    computes their rows bit for bit as the world does."""
    return torch.stack([
        F.gelu(x[r] @ w_up[r], approximate="tanh") @ w_down[r]
        for r in range(x.shape[0])])


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
    return ep_step, (*_ep_draws(dev, range(n)), mesh)


def _ep_draws(dev: torch.device, ranks):
    """ep_entry's tokens, expert_idx, w_up and w_down, the rows of flat
    `ranks`."""
    n = EP_MESH["expert"]
    d, f = ENTRY_CONFIG.d_model, ENTRY_CONFIG.d_ff
    rng = np.random.RandomState(0)
    tokens = rng.randn(n, EP_TOKENS, d)
    expert_idx = rng.randint(0, n, (n, EP_TOKENS))
    w_up = rng.randn(n, d, f) / math.sqrt(d)
    w_down = rng.randn(n, f, d) / math.sqrt(f)
    rows = list(ranks)

    def bf16(x):
        return torch.as_tensor(x[rows].astype(np.float32)).to(
            dev, torch.bfloat16)

    return (bf16(tokens), torch.as_tensor(expert_idx[rows], device=dev),
            bf16(w_up), bf16(w_down))


def multihost_ep_entry(rank: int, size: int, store_address: str,
                       device="cuda", device_hostname: Optional[str] = None):
    """ep_entry() split over processes: (step, (tokens, expert_idx, w_up,
    w_down, mesh)) for process `rank` of `size`, the tensors ep_entry()'s
    draws at the rows of its ranks of a process mesh EP_MESH; step is
    ep_step (its dispatch and combine, and their VJPs, the cross-process
    B8), its context to close step.context."""
    ctx, mesh = _process_mesh(rank, size, store_address, EP_MESH, device,
                              device_hostname)

    def step(*args):
        return ep_step(*args)

    step.context, step.mesh = ctx, mesh
    return step, (*_ep_draws(mesh.device, mesh.local_ranks), mesh)


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


def _variant_paths(step, x, mesh):
    return {name: (step, (variant, x, mesh))
            for name, variant in (("hbm", ring_allreduce_hbm),
                                  ("q8", ring_allreduce_q8),
                                  ("bidir", ring_allreduce_bidir))}


def _variant_buffer(dev: torch.device, ranks,
                    world: int = DDP_WORLD) -> torch.Tensor:
    """ring_variants_entry's x over a world of `world` ranks, at the rows
    of flat `ranks`: each rank's buffer_width(numel, world) values drawn
    in rank order from one np.random.RandomState(7) (row by row, the
    stream of randn(world, width)), rows zero-padded to a multiple of
    32 x world."""
    numel = sum(p.numel() for p in
                Transformer(ENTRY_CONFIG, device="meta").parameters())
    width = buffer_width(numel, world)
    quantum = 32 * world
    rows = -(-width // (quantum * RING_VARIANT_COLS)) * quantum
    rng = np.random.RandomState(7)
    buf = np.zeros((world, rows * RING_VARIANT_COLS), np.float32)
    for r in range(world):
        buf[r, :width] = rng.randn(width)
    x = torch.as_tensor(buf.reshape(world, rows, RING_VARIANT_COLS))
    return x[list(ranks)].to(dev)


def ring_variants_entry(device="cuda", ranks: int = DDP_WORLD):
    """The ring-variant path: {"hbm": (ring_variant_step, args), "q8": ...,
    "bidir": ...}, each fn(*args), args = (the variant, x, mesh): a mesh
    {"data": ranks} of ranks on `device` and x the flagship's gradient
    buffer on each rank (buffer_width f32: every parameter's gradient and
    the loss, here np.random.RandomState(7).randn, the dry run's ring_rng),
    zero-padded to (ranks, rows, RING_VARIANT_COLS), rows a multiple of
    32 x ranks: (4, 6912, 256) f32, 7.08 MB per rank, at DDP_WORLD; (64,
    8192, 256), 8.39 MB per rank and 537 MB per world tensor, at 64."""
    dev = resolve_device(device)
    mesh = make_mesh({"data": ranks}, devices=[dev] * ranks)
    return _variant_paths(ring_variant_step,
                          _variant_buffer(dev, range(ranks), ranks), mesh)


def multihost_ring_variants_entry(rank: int, size: int, store_address: str,
                                  device="cuda",
                                  device_hostname: Optional[str] = None):
    """ring_variants_entry() split over processes: the same three paths
    for process `rank` of `size`, x the rows of its ranks of a process
    mesh {"data": DDP_WORLD} (one rank per process at size 4; see
    _process_mesh), each step ring_variant_step with the variants'
    cross-process instances (its context to close: step.context, the same
    for the three paths)."""
    ctx, mesh = _process_mesh(rank, size, store_address,
                              {"data": DDP_WORLD}, device, device_hostname)

    def step(*args):
        return ring_variant_step(*args)

    step.context, step.mesh = ctx, mesh
    return _variant_paths(step, _variant_buffer(mesh.device,
                                                mesh.local_ranks), mesh)


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
    return _fsdp_step(model, tokens, mesh)


def _fsdp_step(model: Transformer, tokens: torch.Tensor, mesh):
    """make_fsdp_train_step over `mesh` for `model`'s weights, with their
    shards and this process's share of `tokens` (the entry batch) and its
    targets as world tensors of the local ranks' rows."""
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
    batch = tuple(world_batch(data_share(x, mesh), mesh)
                  for x in (tokens, _entry_targets(tokens)))
    return step, (shard_params(params, "data", mesh=mesh), batch)


def multihost_fsdp_entry(rank: int, size: int, store_address: str,
                         device="cuda",
                         device_hostname: Optional[str] = None):
    """fsdp_train_entry() split over processes: process `rank` of `size`
    returns (step, (sharded, (tokens, targets))) for its ranks of a
    process mesh FSDP_MESH (one rank per process at size 4; see
    _process_mesh). sharded holds train_entry()'s weights sharded over
    "data" for the local ranks ((len(local_ranks), chunk) per leaf), and
    tokens and targets are the process's share of the entry batch (2
    sequences per rank) as world tensors of its rows. step is
    make_fsdp_train_step's over the process mesh: each leaf's gather is
    the cross-process B4b, its VJP the cross-process B4a, and the loss
    mean the cross-process B3. Its context to close: step.context. At
    size 4 each step is fsdp_train_entry()'s, split over processes."""
    ctx, mesh = _process_mesh(rank, size, store_address, FSDP_MESH,
                              device, device_hostname)
    _, (model, tokens) = entry(mesh.device)
    step, args = _fsdp_step(model, tokens, mesh)
    step.context, step.mesh = ctx, mesh
    return step, args


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
    n = PP_MESH["pipe"]
    mesh = make_mesh(PP_MESH, devices=[dev] * n)
    return _pp_paths(pp_forward, pp_train, mesh)


def _pp_paths(forward, train, mesh):
    """pp_entry's two paths over `mesh` (a world, or a process mesh whose
    tensors are its local ranks' rows)."""
    dev = mesh.device
    cfg = dataclasses.replace(ENTRY_CONFIG, n_layers=PP_STAGES)
    rows = len(mesh.local_ranks)
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tree = transformer_params_to_numpy(model.state_dict(), cfg)
    stages = pipeline_stages_from_numpy(tree, cfg, mesh)
    embed = torch.as_tensor(tree["embed"], device=dev)
    ln_f = torch.as_tensor(tree["ln_f"]["scale"], device=dev)
    tokens = torch.as_tensor(_entry_tokens(), device=dev)
    x = embed[tokens] + torch.as_tensor(tree["pos"], device=dev)
    xs = x.to(cfg.dtype)[:, None].expand(rows, *x.shape[:1], 1,
                                         *x.shape[1:])
    ys = torch.as_tensor(np.roll(_entry_tokens(), -1, axis=1), device=dev)
    ys = ys[:, None].expand(rows, *ys.shape[:1], 1, *ys.shape[1:])

    def loss_fn(y, target):
        logits = _rmsnorm(y, ln_f).float() @ embed.T
        nll = F.cross_entropy(logits.flatten(0, -2), target.flatten(),
                              reduction="none")
        return nll.view(y.shape[0], -1).mean(1)

    stage_fn = functools.partial(world_block, cfg)
    return {"gpipe": (forward, (stage_fn, stages, xs, mesh)),
            "1f1b": (train, (stage_fn, loss_fn, stages, xs, ys, mesh))}


def multihost_pp_entry(rank: int, size: int, store_address: str,
                       device="cuda", device_hostname: Optional[str] = None):
    """pp_entry() split over processes: the same two paths for process
    `rank` of `size`, over a process mesh PP_MESH (one stage per process
    at size 4; see _process_mesh): its stages' weights, inputs and targets
    at its ranks' rows, the activations and cotangents moving between
    processes by spmd.shift (the transport). The paths' context to close:
    the steps' .context."""
    ctx, mesh = _process_mesh(rank, size, store_address, PP_MESH, device,
                              device_hostname)

    def forward(*args):
        return pp_forward(*args)

    def train(*args):
        return pp_train(*args)

    for fn in (forward, train):
        fn.context, fn.mesh = ctx, mesh
    return _pp_paths(forward, train, mesh)


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


# ---- the dry run at any n_devices ----

def dryrun_config(n_devices: int):
    """The dp x tp step's mesh axes and model at n_devices, scaled as
    __graft_entry__.dryrun_multichip scales them (:125-135): "data" 2 where
    n is even (else 1), "model" the rest, heads doubled from 4 until they
    reach the model axis, d_model 8 and d_ff 16 x max(model, 4), 2 layers,
    vocab 128, 16 tokens a sequence, bf16 (the JAX config's default)."""
    dp = 2 if n_devices % 2 == 0 else 1
    tp = n_devices // dp
    n_heads = 4
    while tp > n_heads:
        n_heads *= 2
    cfg = TransformerConfig(vocab_size=128, d_model=8 * max(tp, 4),
                            n_heads=n_heads, n_layers=2,
                            d_ff=16 * max(tp, 4), max_seq_len=16)
    return {"data": dp, "model": tp}, cfg


def dryrun_dp_tp(n_devices: int, device="cuda", params=None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The dry run's dp x tp step (:118-180) at n_devices ranks on one
    device: dryrun_config's mesh and model, its weights split over "model"
    (wqkv and w_up by columns, wo and w_down by rows), one Adam step at
    ADAM_SETTINGS (optax.adam(1e-3)) on 2 x data sequences from
    np.random.RandomState(0) and their next-token targets. The weights are
    `params` (the JAX tree as numpy arrays) where given, else
    Transformer.init with a generator seeded 0; `dtype` overrides the
    config's. Returns the global mean loss (0-d f32), asserted finite. The
    gradients cross the ranks on B3, along "data" and along "model"."""
    axes, cfg = dryrun_config(n_devices)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = resolve_device(device)
    mesh = make_mesh(axes, devices=[dev] * n_devices)
    if params is None:
        model = Transformer(cfg, device=dev).init(
            torch.Generator().manual_seed(0))
        tp_model = shard_transformer(model, mesh, "model")
    else:
        tp_model = tp_transformer_from_numpy(params, cfg, mesh)
    optimizer = torch.optim.Adam(tp_model.parameters(), **ADAM_SETTINGS)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2 * axes["data"], cfg.max_seq_len)).astype(
            np.int32)
    targets = np.roll(tokens, -1, axis=1)
    loss = make_dp_tp_train_step(mesh, "data", "model")(
        tp_model, optimizer, torch.as_tensor(tokens, device=dev),
        torch.as_tensor(targets, device=dev))
    assert torch.isfinite(loss).item(), \
        "training step produced non-finite loss"
    return loss


def _tanh_stage(p: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.tanh(h @ p)


def _mse(o: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Each rank's mean squared error: (P,) over world tensors."""
    return ((o - t) ** 2).flatten(1).mean(1)


def _fsdp_dryrun_loss(p: dict, batch) -> torch.Tensor:
    x, y = batch
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def _fused_pair(x, wu, wd, mesh, auto: bool = False) -> torch.Tensor:
    up = allgather_matmul_dense_auto if auto else allgather_matmul_dense
    down = row_parallel_dense_scattered_auto if auto \
        else row_parallel_dense_scattered
    return down(up(x, wu, "x", mesh=mesh), wd, "x", mesh=mesh)


def _ring_variant(variant, rng, mesh, per_rows: int, cols: int,
                  lossy: bool = False) -> torch.Tensor:
    """The dry run's _ring_variant (:350-370): (n, per_rows, cols) f32 from
    rng, one call along "x", held to the sum over the ranks: q8 (lossy)
    within 5% of its largest value and bitwise the same on every rank,
    the others within rtol 1e-5 of it on every rank. The reference holds
    those with an elementwise rtol and no atol, which its own kernels miss
    on its own draws (sums near zero keep no relative precision in any
    add order: 45 of 16384 elements of B11's at n 8); here the rtol is
    relative to the sum's largest value."""
    n = mesh.size
    xs = rng.randn(n, per_rows, cols).astype(np.float32)
    out = variant(torch.as_tensor(xs, device=mesh.device), "x", mesh).cpu()
    expected = torch.as_tensor(xs.sum(axis=0))
    if lossy:
        rel = float((out[0] - expected).abs().max() / expected.abs().max())
        assert rel < 0.05, f"{variant.__name__}: rel err {rel}"
        for i in range(1, n):
            # Consensus: the quantized stream decodes identically on every
            # rank.
            assert torch.equal(out[i], out[0]), variant.__name__
    else:
        atol = 1e-5 * float(expected.abs().max())
        for i in range(n):
            torch.testing.assert_close(out[i], expected, rtol=0, atol=atol)
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The counterpart of __graft_entry__.dryrun_multichip(n_devices): a
    world of n_devices ranks on one device, each section of the reference
    at its own scaling, shapes, inputs and asserts, on the port's modules.
    Returns each section's result by name (tensors on the device):

      "dp_tp": dryrun_dp_tp's loss (B3 along "data" and "model");
      "ring_attention": ring_attention of q = k = v = ones (1, 1, 8 n, 4)
        split over the sequence, causal;
      "gpipe": pipeline_apply of tanh(h @ w), w = 0.1 ones (4, 4) a stage,
        over 3 microbatches of ones (2, 4);
      "1f1b": pipeline_train_1f1b's (grads, loss) of the same stages, mean
        squared error to zeros, n + 2 microbatches;
      "dispatch_combine": 4 tokens of ones (8) a rank, all to expert 0,
        capacity 8, each expert doubling (B8);
      "ulysses": ulysses_attention of ones (1, n, 8 n, 4) split over the
        sequence (B8 around B1);
      "fsdp": one FSDP step's loss of x @ w + b against ones, w = 0.1 ones
        (8, 4), b zeros (4), 2 rows of ones (8) a rank (B4b, B4a, B3),
        asserted finite;
      "fused": the Megatron-SP pair, allgather_matmul_dense (B5b) then
        row_parallel_dense_scattered (B5a), of x = 0.01 ones (8 n, 16),
        w_up = 0.02 ones (16, 16 n) by columns, w_down = 0.03 ones
        (16 n, 128) by rows; "fused_auto" and "unfused_auto" the *_auto
        pair with TPUCOLL_TP_OVERLAP forced to each arm, within rtol 1e-5
        of it (the variable restored after);
      "q8", "bidir", "hbm": the ring variants (B10, B11, B9) at (n, 32 n,
        128), (n, 8 n, 256) and (n, 8 n, 128) from one
        np.random.RandomState(7), held as _ring_variant holds them.

    The reference skips the fused and ring-variant sections where its JAX
    has no distributed Pallas interpreter; the port has its kernels (or
    their plain versions on CPU tensors) and runs them always."""
    dev = resolve_device(device)
    n = n_devices
    out = {"dp_tp": dryrun_dp_tp(n, dev)}
    flat = make_mesh({"x": n}, devices=[dev] * n)

    q = torch.ones((n, 1, 1, 8, 4), device=dev)
    out["ring_attention"] = ring_attention(q, q, q, "x", mesh=flat)

    ws = torch.full((n, 4, 4), 0.1, device=dev)
    xs = torch.ones((3, 2, 4), device=dev).expand(n, -1, -1, -1)
    out["gpipe"] = pipeline_apply(_tanh_stage, ws, xs, "x", mesh=flat)
    xs_t = torch.ones((n + 2, 2, 4), device=dev).expand(n, -1, -1, -1)
    ys_t = torch.zeros((n + 2, 2, 4), device=dev).expand(n, -1, -1, -1)
    out["1f1b"] = pipeline_train_1f1b(_tanh_stage, _mse, ws, xs_t, ys_t,
                                      "x", mesh=flat)

    toks = torch.ones((n, 4, 8), device=dev)
    idx = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    out["dispatch_combine"] = dispatch_combine(lambda x: x * 2.0, toks, idx,
                                               8, "x", mesh=flat)

    qh = torch.ones((n, 1, n, 8, 4), device=dev)
    out["ulysses"] = ulysses_attention(qh, qh, qh, "x", mesh=flat)

    params = {"w": torch.full((8, 4), 0.1, device=dev),
              "b": torch.zeros((4,), device=dev)}
    step = make_fsdp_train_step(_fsdp_dryrun_loss, params, "x", mesh=flat)
    batch = (torch.ones((n, 2, 8), device=dev),
             torch.ones((n, 2, 4), device=dev))
    _, out["fsdp"] = step(shard_params(params, "x", mesh=flat), batch)
    assert torch.isfinite(out["fsdp"]).all().item()

    ov_x = torch.full((n, 8, 16), 0.01, device=dev)
    ov_wu = torch.full((n, 16, 16), 0.02, device=dev)
    ov_wd = torch.full((n, 16, 128), 0.03, device=dev)
    out["fused"] = _fused_pair(ov_x, ov_wu, ov_wd, flat)
    saved = os.environ.get("TPUCOLL_TP_OVERLAP")
    try:
        for arm in ("fused", "unfused"):
            os.environ["TPUCOLL_TP_OVERLAP"] = arm
            got = _fused_pair(ov_x, ov_wu, ov_wd, flat, auto=True)
            torch.testing.assert_close(got.cpu(), out["fused"].cpu(),
                                       rtol=1e-5, atol=0)
            out[f"{arm}_auto"] = got
    finally:
        # An operator's forced dispatch mode survives the dry run.
        if saved is None:
            os.environ.pop("TPUCOLL_TP_OVERLAP", None)
        else:
            os.environ["TPUCOLL_TP_OVERLAP"] = saved

    rng = np.random.RandomState(7)
    out["q8"] = _ring_variant(ring_allreduce_q8, rng, flat, n * 32, 128,
                              lossy=True)
    out["bidir"] = _ring_variant(ring_allreduce_bidir, rng, flat, n * 8, 256)
    out["hbm"] = _ring_variant(ring_allreduce_hbm, rng, flat, n * 8, 128)
    return out
