"""FSDP across processes: gloo_tpu_torch.parallel.fsdp's shard_params,
unshard_params and make_fsdp_train_step on a process mesh, and
entry.multihost_fsdp_entry, against the port's one-process world and
against gloo_tpu's FSDP step.

Processes are simulated with threads, each with its own
init_multihost(devices=["cpu"]) (tests/test_torch_multihost.py's
_processes): a process holds its local ranks' rows of every shard and of
the batch, and on CPU tensors each leaf's gather (B4b), its VJP (B4a) and
the loss mean (B3) gather the world through the host plane and run the
kernel's twin, then keep the local rows.

Tolerance: none where the port is held against itself. The twins run on
the same world as on a one-process mesh, and each rank's loss and
backward is the same computation on the same rows, so shards, losses and
parameters are bitwise equal (one intra-op thread per test, as
tests/test_torch_multihost_sp.py sets it, keeps every CPU sum in the
world's order). Against gloo_tpu (flash attention on both sides, the JAX
side in shard_map with check_vma=False as tests/test_torch_fsdp.py runs
it): that file's tolerance, losses to rtol 1e-5 and parameters after 3
SGD steps to rtol 1e-5 / atol 1e-6.

The test marked `cuda` drives multihost_fsdp_entry in real processes on
the card and skips without one; it imports no JAX.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gloo_tpu_torch import _lib
from gloo_tpu_torch import entry as entry_mod
from gloo_tpu_torch.models import MLP, Transformer, TransformerConfig
from gloo_tpu_torch.parallel import (make_fsdp_train_step, shard_params,
                                     unshard_params)
from gloo_tpu_torch.parallel.dp_tp import world_batch
from gloo_tpu_torch.tpu import make_mesh
from test_torch_multihost import NARROW, _cpus, _free_port, _processes
from test_torch_multihost_tp import _entries

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

REPO = Path(__file__).resolve().parent.parent
# Processes' rank counts: 2 processes of one rank (a ring of 2), 4 of one,
# the uneven 1 + 3 and 2 x 2 (rings of 4).
COUNTS = [(1, 1), (1, 1, 1, 1), (1, 3), (2, 2)]
COUNT_IDS = ["2x1", "4x1", "1+3", "2+2"]
# The odd hidden width gives leaves of 17 and 68 elements, which no ring of
# 2 or 4 divides: their shards are padded.
SIZES = (8, 17, 4)
LR = 0.1
STEPS = 3
ROWS = 16  # rows of the MLP's batch, sequences of the transformer's


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while the thread "processes" run: they share
    torch's pool, and a CPU reduction splits its sum by the threads a
    call gets, which concurrent callers change; with one each, every sum
    keeps the world's order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mlp_case(dtype):
    """(state, loss_fn, (xs, ys)): a seeded MLP over SIZES with leaves of
    `dtype`, its mean squared error, and a batch of ROWS rows."""
    model = MLP(SIZES, device="cpu").init(torch.Generator().manual_seed(3))
    state = {k: p.detach().to(dtype) for k, p in model.named_parameters()}
    shell = MLP(SIZES, device="meta")

    def loss_fn(params, batch):
        x, y = batch
        pred = torch.func.functional_call(shell, params, (x,))
        return ((pred.float() - y.float()) ** 2).mean()

    rng = np.random.RandomState(4)
    xs = torch.from_numpy(rng.randn(ROWS, SIZES[0]).astype(np.float32))
    ys = torch.from_numpy(rng.randn(ROWS, SIZES[-1]).astype(np.float32))
    return state, loss_fn, (xs.to(dtype), ys.to(dtype))


def _lm_loss(shell):
    def loss_fn(params, batch):
        tokens, targets = batch
        logits = torch.func.functional_call(shell, params, (tokens,))
        return F.cross_entropy(logits.flatten(0, 1),
                               targets.flatten().long())

    return loss_fn


def _narrow_case(dtype):
    """The narrow flagship (f32 parameters) at activations of `dtype`, its
    language-model loss, and ROWS sequences of 16 tokens."""
    cfg = TransformerConfig(dtype=dtype, use_flash_attention=True, **NARROW)
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    state = {k: p.detach() for k, p in model.named_parameters()}
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (ROWS, 16)), dtype=torch.int32)
    return state, _lm_loss(Transformer(cfg, device="meta")), (
        tokens, torch.roll(tokens, -1, 1))


CASES = {"mlp-f32": lambda: _mlp_case(torch.float32),
         "mlp-bf16": lambda: _mlp_case(torch.bfloat16),
         "narrow-f32": lambda: _narrow_case(torch.float32),
         "narrow-bf16act": lambda: _narrow_case(torch.bfloat16)}


def _run(state, loss_fn, batch, mesh, world_rows=None):
    """shard_params, unshard_params and STEPS steps of
    make_fsdp_train_step on `mesh`: (sharded, full, [(shards, loss)] per
    step). `batch` is the global batch, which world_batch splits over a
    one-process mesh, or, given world_rows, world tensors whose rows
    world_rows this process takes."""
    if world_rows is None:
        batch = tuple(world_batch(b, mesh) for b in batch)
    else:
        batch = tuple(b[world_rows] for b in batch)
    sharded = shard_params(state, "data", mesh=mesh)
    full = unshard_params(sharded, state, "data", mesh=mesh)
    step = make_fsdp_train_step(loss_fn, state, "data", lr=LR, mesh=mesh)
    steps, current = [], sharded
    for _ in range(STEPS):
        current, loss = step(current, batch)
        steps.append((current, loss))
    return sharded, full, steps


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("counts", COUNTS, ids=COUNT_IDS)
def test_fsdp_across_processes_is_the_world(counts, case):
    """shard_params, unshard_params and 3 SGD steps of
    make_fsdp_train_step on each process's local ranks: every shard (of
    len(local_ranks) x chunk elements), gathered leaf, loss and updated
    shard bitwise the one-process world's rows."""
    n = sum(counts)
    state, loss_fn, batch = CASES[case]()
    flat = make_mesh({"data": n}, devices=["cpu"] * n)
    want = _run(state, loss_fn, batch, flat)
    world = tuple(world_batch(b, flat) for b in batch)

    def fn(ctx, mesh, rank):
        # A loss of its own: functional_call swaps a shell's parameters
        # in place, which threads sharing one shell would race on.
        _, own_loss, _ = CASES[case]()
        return mesh.local_ranks, _run(state, own_loss, world, mesh,
                                      mesh.local_ranks)

    for local, (sharded, full, steps) in _processes(_cpus(counts), fn,
                                                    {"data": n}):
        for name, piece in sharded.items():
            chunk = want[0][name].shape[1]
            assert piece.numel() == len(local) * chunk, name
            assert piece.dtype == state[name].dtype, name
            assert torch.equal(piece, want[0][name][local]), name
            assert torch.equal(full[name], want[1][name][local]), name
        for (got, loss), (ref, ref_loss) in zip(steps, want[2]):
            assert torch.equal(loss, ref_loss[local])
            for name in got:
                assert torch.equal(got[name], ref[name][local]), name
    losses = [float(loss[0]) for _, loss in want[2]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def _jax_mlp():
    """gloo_tpu's MLP at SIZES, its loss, the JAX init and a batch."""
    import jax
    import jax.numpy as jnp

    from gloo_tpu.models import MLP as JaxMLP

    jm = JaxMLP(SIZES)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    xs = rng.randn(ROWS, SIZES[0]).astype(np.float32)
    ys = rng.randn(ROWS, SIZES[-1]).astype(np.float32)

    def jloss(p, batch):
        x, y = batch
        return jnp.mean((jm.apply(p, x) - y) ** 2)

    named = {f"layers.{i}.{k}": np.array(layer[k])
             for i, layer in enumerate(jparams) for k in ("w", "b")}
    state = {k: torch.from_numpy(v) for k, v in named.items()}

    def port_names(jtree):
        return {f"layers.{i}.{k}": torch.from_numpy(np.array(layer[k]))
                for i, layer in enumerate(jtree) for k in ("w", "b")}

    def loss_fn(params, batch):
        x, y = batch
        pred = torch.func.functional_call(MLP(SIZES, device="meta"),
                                          params, (x,))
        return ((pred - y) ** 2).mean()

    return (jparams, jloss, (xs, ys)), (state, lambda: loss_fn, port_names)


def _jax_transformer():
    """gloo_tpu's transformer at tests/test_torch_fsdp.py's SMALL width in
    f32, flash attention on."""
    import jax
    import jax.numpy as jnp

    from gloo_tpu.models import Transformer as JaxTransformer
    from gloo_tpu.models import TransformerConfig as JaxConfig
    from gloo_tpu_torch import weights

    small = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                 max_seq_len=16, use_flash_attention=True)
    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, **small))
    jparams = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(0).randint(
        0, small["vocab_size"], (8, small["max_seq_len"])).astype(np.int32)
    cfg = TransformerConfig(dtype=torch.float32, **small)

    def port_names(jtree):
        return weights.transformer_params_from_numpy(
            jax.tree.map(np.asarray, jtree), cfg, "cpu")

    return ((jparams, jm.loss, (tokens, np.roll(tokens, -1, axis=1))),
            (port_names(jparams),
             lambda: _lm_loss(Transformer(cfg, device="meta")), port_names))


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_fsdp_across_processes_matches_the_reference(model):
    """3 SGD steps of make_fsdp_train_step at n = 4 over 4 "processes"
    against gloo_tpu's make_fsdp_train_step over a 4-device mesh in
    shard_map: losses to rtol 1e-5, the gathered parameters after the
    steps to rtol 1e-5 / atol 1e-6 on every process."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.parallel import make_fsdp_train_step as jax_step
    from gloo_tpu.parallel import shard_params as jax_shard
    from gloo_tpu.parallel import unshard_params as jax_unshard
    from gloo_tpu.tpu import make_mesh as jax_make_mesh

    n = 4
    (jparams, jloss, jbatch), (state, make_loss, port_names) = \
        (_jax_mlp if model == "mlp" else _jax_transformer)()
    jstep = jax_step(jloss, jparams, "data", lr=LR)

    def run(params, *batch):
        sharded = jax_shard(params, "data")
        losses = []
        for _ in range(STEPS):
            sharded, loss = jstep(sharded, batch)
            losses.append(loss)
        return jax_unshard(sharded, params, "data"), jnp.stack(losses)

    jfinal, jlosses = jax.jit(jax.shard_map(
        run, mesh=jax_make_mesh({"data": n}, devices=jax.devices()[:n]),
        in_specs=(P(), P("data"), P("data")), out_specs=(P(), P()),
        check_vma=False))(jparams, *jbatch)
    want = port_names(jfinal)
    flat = make_mesh({"data": n}, devices=["cpu"] * n)
    world = tuple(world_batch(torch.from_numpy(b), flat) for b in jbatch)

    def fn(ctx, mesh, rank):
        _, _, steps = _run(state, make_loss(), world, mesh,
                           mesh.local_ranks)
        return ([float(loss[0]) for _, loss in steps],
                unshard_params(steps[-1][0], state, "data", mesh=mesh))

    for losses, final in _processes(_cpus((1,) * n), fn, {"data": n}):
        np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
        assert set(final) == set(want)
        for name, got in final.items():
            np.testing.assert_allclose(got[0].numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


# ---- the entry ----

@functools.lru_cache(maxsize=1)
def _world_entry_step():
    """fsdp_train_entry("cpu")'s shards and batch, and its first step's new
    shards and loss."""
    step, (sharded, batch) = entry_mod.fsdp_train_entry("cpu")
    new, loss = step(sharded, batch)
    return sharded, batch, new, loss


@pytest.mark.parametrize("size", [1, 2, 4])
def test_multihost_fsdp_entry_is_fsdp_train_entry(size):
    """multihost_fsdp_entry over `size` "processes" at full width: each
    holds fsdp_train_entry()'s 15 shards and its batch at its ranks' rows
    (2 sequences of 128 per rank), and its first step's new shards and
    loss are the world step's rows, bitwise."""
    sharded, batch, new, loss = _world_entry_step()

    def fn(rank, step, args):
        local = step.mesh.local_ranks
        assert len(local) == 4 // size and step.context.size == size
        msharded, mbatch = args
        assert len(msharded) == 15
        for name, piece in msharded.items():
            assert piece.numel() == len(local) * sharded[name].shape[1]
            assert torch.equal(piece, sharded[name][local]), name
        for got, ref in zip(mbatch, batch):
            assert got.shape == (len(local), 2, 128)
            assert torch.equal(got, ref[local])
        mnew, mloss = step(msharded, mbatch)
        return (torch.equal(mloss, loss[local])
                and all(torch.equal(mnew[k], new[k][local]) for k in new))

    assert _entries("multihost_fsdp_entry", fn, size=size) == [True] * size


def test_multihost_fsdp_entry_refuses_a_size_that_does_not_split_the_mesh():
    with pytest.raises(ValueError, match="splits its 4 ranks"):
        entry_mod.multihost_fsdp_entry(0, 3, f"127.0.0.1:{_free_port()}",
                                       "cpu")


# ---- on the card ----

_CARD_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    from gloo_tpu_torch import entry as entry_mod
    from gloo_tpu_torch.checkpoint import state_digest
    from gloo_tpu_torch.models import Transformer
    from gloo_tpu_torch.ops import attention as attn
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.parallel import unshard_params

    rank, size, address = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    world = torch.load(sys.argv[4])
    step, (sharded, batch) = entry_mod.multihost_fsdp_entry(
        rank, size, address, device_hostname="127.0.0.1")
    counters = (ring.ring_allgather, ring.ring_reduce_scatter,
                ring.ring_allreduce, attn.flash_attention_fwd,
                attn.flash_attention_bwd)
    template = Transformer(entry_mod.ENTRY_CONFIG, device="meta").state_dict()

    def gathered():
        full = unshard_params(sharded, template, "data", mesh=step.mesh)
        return {k: v[0].cpu() for k, v in full.items()}

    old = gathered()
    out = {"losses": [], "digests": [], "world_digests": [],
           "grad_rel": [], "launches": [0] * len(counters),
           "start": state_digest(old) == state_digest(world[0])}
    for i in range(len(world) - 1):
        before = [c.launches for c in counters]
        sharded, loss = step(sharded, batch)
        torch.cuda.synchronize()
        out["launches"] = [a + c.launches - b for a, c, b
                           in zip(out["launches"], counters, before)]
        out["losses"].append(float(loss[0]))
        new = gathered()
        out["digests"].append(state_digest(new))
        out["world_digests"].append(state_digest(world[i + 1]))
        rel = 0.0
        for k in new:
            g = (old[k] - new[k]) / entry_mod.FSDP_LR
            gw = (world[i][k] - world[i + 1][k]) / entry_mod.FSDP_LR
            rel = max(rel, float((g - gw).norm()
                                 / gw.norm().clamp_min(1e-30)))
        out["grad_rel"].append(rel)
        old = new
    step.context.close()
    print(json.dumps(out))
""")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cross-process kernels map "
                    "device memory between processes with CUDA IPC")
    return torch.device("cuda")


@pytest.mark.cuda
def test_multihost_fsdp_entry_on_card(cuda_device, tmp_path):
    """multihost_fsdp_entry in 2 processes on the card, 3 steps: per step
    and process 15 B4b, 15 B4a, one B3 and 4 B1 and 4 B2 (2 layers on
    each of 2 ranks); losses equal on both processes and within 1e-6 rel
    of fsdp_train_entry()'s world steps on the card, which is well under
    one step's change (~1.6e-3 rel); the gathered parameters' state_digest
    equal across the processes, and each process's gathered parameters
    held against the world's after each step: the step's implied gradient
    (old - new) / lr within 1e-3 of the world's in each leaf (bitwise
    expected; B2's dQ reduce-add lands in no fixed order), which a lost
    or doubled partial of the reduce-scatter (~1/4 of a leaf's gradient
    or more) exceeds."""
    step, (sharded, batch) = entry_mod.fsdp_train_entry(cuda_device)
    template = Transformer(entry_mod.ENTRY_CONFIG, device="meta").state_dict()
    mesh = make_mesh(entry_mod.FSDP_MESH, devices=[cuda_device] * 4)

    def gathered(shards):
        full = unshard_params(shards, template, "data", mesh=mesh)
        return {k: v[0].cpu() for k, v in full.items()}

    want, world = [], [gathered(sharded)]
    for _ in range(3):
        sharded, loss = step(sharded, batch)
        want.append(float(loss[0]))
        world.append(gathered(sharded))
    torch.save(world, tmp_path / "world.pt")
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CARD_WORKER, str(r), "2", address,
         str(tmp_path / "world.pt")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)}) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        res.append(json.loads(out.strip().splitlines()[-1]))
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["digests"] == res[1]["digests"]
    np.testing.assert_allclose(res[0]["losses"], want, rtol=1e-6)
    for r in res:
        assert r["start"]
        assert max(r["grad_rel"]) <= 1e-3, r
        assert r["launches"] == [45, 45, 3, 12, 12]
