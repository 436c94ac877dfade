"""gloo_tpu_torch.parallel.sp against gloo_tpu.parallel.sp.

The port's q, k, v are world tensors (P, b, h, t_local, d), rank r holding
sequence block r; the JAX functions run inside jax.shard_map over P CPU
devices with the sequence axis sharded, on the same numpy inputs. The
ring-flash path takes the step twins (B6, B7a, B7b on the card), Ulysses
the all-to-all twin (B8) and the flash twins (B1, B2); JAX runs its Pallas
kernels in interpret mode (check_vma=False, as its own tests do) with
block_q = block_k = t_local, so the online softmax rescales at the same
places as the twins' 64-row tiles.

Tolerances: f32 rtol 1e-4 / atol 1e-5, JAX's own for these paths (the
same arithmetic, products summed in another order). bf16:
outputs rtol 1.6e-2 / atol 1e-2 and gradients rtol 1.6e-2 / atol 8e-3 of
the largest |JAX value| (p and ds are rounded to bf16 inside the sums, and
a last-bit difference before a rounding flips one bf16 ulp, 2**-8
relative), as tests/test_torch_attention.py holds the flash kernels.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.parallel import sp as jsp  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch.entry import SP_MESH, sp_entry  # noqa: E402
from gloo_tpu_torch.ops import attention as attn  # noqa: E402
from gloo_tpu_torch.parallel import sp  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

N = 4
TOL = {"float32": {"out": (1e-4, 1e-5), "grad": (1e-4, 1e-5)},
       "bfloat16": {"out": (1.6e-2, 1e-2), "grad": (1.6e-2, 8e-3)}}


def _world(x):
    """Global (b, h, t, d) -> world (N, b, h, t / N, d) torch tensor."""
    b, h, t, d = x.shape
    a = np.array(jnp.asarray(x, jnp.float32)).reshape(b, h, N, t // N, d)
    out = torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1, 3, 4)))
    return out.to(getattr(torch, str(jnp.dtype(x.dtype))))


def _global(w):
    """World (N, b, h, t_local, d) -> global (b, h, t, d) numpy f32."""
    n, b, h, t, d = w.shape
    return w.float().permute(1, 2, 0, 3, 4).reshape(b, h, n * t, d).numpy()


def _inputs(b, h, h_kv, t, d, dtype, seed):
    rng = np.random.RandomState(seed)
    jd = jnp.dtype(dtype)
    return [jnp.asarray(rng.randn(b, n, t, d).astype(np.float32), jd)
            for n in (h, h_kv, h_kv)]


def _shard(fn):
    mesh = jax_make_mesh({"seq": N}, devices=jax.devices()[:N])
    return jax.shard_map(fn, mesh=mesh, in_specs=(P(None, None, "seq"),) * 3,
                         out_specs=P(None, None, "seq"), check_vma=False)


def _mesh():
    return make_mesh({"seq": N}, devices=["cpu"] * N)


def _close(ours, ref, dtype, kind):
    rtol, atol = TOL[dtype][kind]
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "bfloat16":
        atol *= float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(causal):
    js = _inputs(1, 2, 2, 8 * N, 16, "float32", 3)
    ref = jax.jit(_shard(lambda q, k, v: jsp.ring_attention(
        q, k, v, "seq", causal=causal)))(*js)
    out = sp.ring_attention(*map(_world, js), "seq", causal, mesh=_mesh())
    _close(_global(out), ref, "float32", "out")


def _jax_out_and_grads(f, js):
    """JAX's output of shard_map(f) and the grads of sum(sin(out)), from
    one compiled program."""
    def loss_j(q, k, v):
        out = _shard(f)(q, k, v)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(*js)
    return out, grads


def _ring_flash_both(js, causal):
    t_local = js[0].shape[2] // N

    def f(q, k, v):
        return jsp.ring_flash_attention(q, k, v, "seq", causal=causal,
                                        block_q=t_local, block_k=t_local,
                                        interpret=True)

    ref_out, ref_grads = _jax_out_and_grads(f, js)
    leaves = [_world(x).requires_grad_() for x in js]
    out = sp.ring_flash_attention(*leaves, "seq", causal, mesh=_mesh())
    torch.sin(out).sum().backward()
    return (out, ref_out), [(x.grad, g) for x, g in zip(leaves, ref_grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_ring_flash_attention_matches_jax(dtype, causal, heads):
    """Forward and the grads of sum(sin(out)), JAX's custom VJP against the
    port's autograd Function (tests/test_parallel.py:231-294, :455-487)."""
    h, h_kv = heads
    js = _inputs(1, h, h_kv, 16 * N, 32, dtype, 5)
    (out, ref_out), grads = _ring_flash_both(js, causal)
    assert out.dtype == getattr(torch, dtype)
    _close(_global(out.detach()), ref_out, dtype, "out")
    for ours, ref in grads:
        assert ours.dtype == getattr(torch, dtype)
        _close(_global(ours), ref, dtype, "grad")


def test_ring_flash_attention_two_tiles_per_rank():
    """t_local = 128 (two of the twins' 64-row tiles per rank, JAX at block
    64): the online softmax rescales inside a rank's block too."""
    js = _inputs(1, 2, 1, 128 * N, 16, "float32", 6)

    def f(q, k, v):
        return jsp.ring_flash_attention(q, k, v, "seq", block_q=64,
                                        block_k=64, interpret=True)

    ref = jax.jit(_shard(f))(*js)
    out = sp.ring_flash_attention(*map(_world, js), "seq", mesh=_mesh())
    _close(_global(out), ref, "float32", "out")


def test_ring_flash_forward_folds_into_one_state(monkeypatch):
    """The forward ring loop takes every step in place
    (flash_attention_step_into) on one f32 state allocated once, and the
    output is still JAX's (bf16, GQA, causal)."""
    calls = []
    real = sp.flash_attention_step_into

    def spy(q, k, v, acc, m, l, *args, **kwargs):
        calls.append(tuple(x.data_ptr() for x in (acc, m, l)))
        return real(q, k, v, acc, m, l, *args, **kwargs)

    monkeypatch.setattr(sp, "flash_attention_step_into", spy)
    js = _inputs(1, 4, 2, 16 * N, 32, "bfloat16", 8)
    t_local = js[0].shape[2] // N

    def f(q, k, v):
        return jsp.ring_flash_attention(q, k, v, "seq", block_q=t_local,
                                        block_k=t_local, interpret=True)

    ref = jax.jit(_shard(f))(*js)
    out = sp.ring_flash_attention(*map(_world, js), "seq", mesh=_mesh())
    assert len(calls) == N and len(set(calls)) == 1
    _close(_global(out), ref, "bfloat16", "out")


def _ulysses_jax(js, causal):
    return _jax_out_and_grads(
        lambda q, k, v: jsp.ulysses_attention(q, k, v, "seq", causal=causal),
        js)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_default_path_matches_jax(causal):
    """The default (flash) path, forward and grads of sum(sin(out)),
    against JAX's default path (tests/test_parallel.py:298-383)."""
    js = _inputs(1, N, N, 8 * N, 16, "float32", 7)
    ref_out, ref_grads = _ulysses_jax(js, causal)
    leaves = [_world(x).requires_grad_() for x in js]
    out = sp.ulysses_attention(*leaves, "seq", causal, mesh=_mesh())
    torch.sin(out).sum().backward()
    _close(_global(out.detach()), ref_out, "float32", "out")
    for x, g in zip(leaves, ref_grads):
        _close(_global(x.grad), g, "float32", "grad")


def test_ulysses_bf16_two_heads_per_rank_matches_jax():
    js = _inputs(2, 2 * N, 2 * N, 8 * N, 32, "bfloat16", 8)
    ref_out, ref_grads = _ulysses_jax(js, True)
    leaves = [_world(x).requires_grad_() for x in js]
    out = sp.ulysses_attention(*leaves, "seq", mesh=_mesh())
    torch.sin(out).sum().backward()
    _close(_global(out.detach()), ref_out, "bfloat16", "out")
    for x, g in zip(leaves, ref_grads):
        _close(_global(x.grad), g, "bfloat16", "grad")


def test_ulysses_attn_fn_path():
    """attn_fn replaces the default attention, as gloo_tpu's docstring
    says. Its JAX counterpart fails before it runs
    (test_parallel.py::test_ulysses_attention_vma_checked, an
    UnboundLocalError at gloo_tpu/parallel/sp.py:249; ROADMAP.md queue C),
    so this path is held against a numpy closed form and against the
    port's default path, not against JAX."""
    b, h, t, d = 1, N, 8 * N, 16
    q = np.random.RandomState(11).randn(b, h, t, d).astype(np.float32)
    qw = _world(jnp.asarray(q))
    seen = []

    def oracle(q, k, v, causal):
        seen.append(tuple(q.shape))
        return attn.reference_attention(q, k, v, causal)

    out = sp.ulysses_attention(qw, qw, qw, "seq", attn_fn=oracle,
                               mesh=_mesh())
    assert seen == [(N * b, h // N, t, d)]
    s = np.einsum("bhqd,bhkd->bhqk", q, q) / np.sqrt(d)
    s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    pr = np.exp(s - s.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    expected = np.einsum("bhqk,bhkd->bhqd", pr, q)
    np.testing.assert_allclose(_global(out), expected, rtol=1e-4, atol=1e-5)
    default = sp.ulysses_attention(qw, qw, qw, "seq", mesh=_mesh())
    np.testing.assert_allclose(out.numpy(), default.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_ulysses_bad_heads():
    q = torch.zeros((N, 1, N + 1, 8, 16))
    with pytest.raises(ValueError, match="not divisible"):
        sp.ulysses_attention(q, q, q, "seq", mesh=_mesh())
    with pytest.raises(ValueError, match="world tensors"):
        sp.ring_flash_attention(q[0], q[0], q[0], "seq", mesh=_mesh())


def test_sp_entry_on_cpu():
    """sp_entry at a sequence of 256 (64 per rank): the three paths agree
    with each other, and ring-flash and Ulysses give the same grads."""
    paths = sp_entry("cpu", seq=256)
    fn, args = paths["ring_flash"]
    q = args[1]
    assert tuple(q.shape) == (SP_MESH["seq"], 2, 4, 64, 64)
    assert q.dtype == torch.bfloat16 and q.device.type == "cpu"
    ring_out, ring_grads = fn(*args)
    fn, args = paths["ulysses"]
    uly_out, uly_grads = fn(*args)
    fn, args = paths["ring_attention"]
    plain_out = fn(*args)
    for a in (ring_out, uly_out, plain_out):
        assert a.shape == q.shape and bool(torch.isfinite(a.float()).all())
    peak = float(plain_out.float().abs().max())
    for a in (ring_out, uly_out):
        torch.testing.assert_close(a.float(), plain_out.float(), rtol=1.6e-2,
                                   atol=1e-2 * peak)
    for a, b in zip(ring_grads, uly_grads):
        torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2,
                                   atol=8e-3 * float(b.float().abs().max()))
