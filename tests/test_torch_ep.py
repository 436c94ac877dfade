"""gloo_tpu_torch.parallel.ep.dispatch_combine against
gloo_tpu.parallel.ep.dispatch_combine.

The port's tokens are a world tensor (P, T, D) and its expert indices
(P, T); the JAX function runs inside jax.shard_map over P CPU devices with
the token axis sharded along "expert", on the same numpy inputs. Both
exchanges are spmd.alltoall (B8; its twin on the CPU).

Tolerances: the routing moves tokens without arithmetic, so with an
expert that scales its slots the results are bitwise equal. With a tanh
expert and its gradients: f32 rtol 1e-5 / atol 1e-6 (the same products,
summed in another order). ep_entry's bf16 MLP against a per-expert dense
reference: relative norm 2e-2 (bf16 products rounded at other places).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.parallel import dispatch_combine as jax_dispatch  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch.entry import (EP_CAPACITY, EP_MESH, EP_TOKENS,  # noqa
                                  ep_entry, expert_mlp)
from gloo_tpu_torch.ops import ring  # noqa: E402
from gloo_tpu_torch.parallel import dispatch_combine  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

N, T, D = 4, 16, 8


def _jax(fn, *arrays):
    mesh = jax_make_mesh({"expert": N}, devices=jax.devices()[:N])
    f = jax.jit(jax.shard_map(fn, mesh=mesh,
                              in_specs=(P("expert"),) * len(arrays),
                              out_specs=P("expert")))
    return np.asarray(f(*arrays))


def _mesh():
    return make_mesh({"expert": N}, devices=["cpu"] * N)


def _scaled(capacity, idx, seed):
    """JAX and the port with an expert that scales its slots by 1 + its
    rank, so an expert's identity shows in its output."""
    tokens = np.random.RandomState(seed).randn(N * T, D).astype(np.float32)
    scales = (1.0 + np.arange(N)).astype(np.float32)

    def shard_fn(tok, i, scale):
        return jax_dispatch(lambda x: x * scale[0], tok, i, capacity,
                            "expert")

    want = _jax(shard_fn, tokens, idx.reshape(-1).astype(np.int32), scales)
    ws = torch.from_numpy(scales)[:, None, None]
    got = dispatch_combine(lambda x: x * ws, torch.from_numpy(tokens).view(
        N, T, D), torch.from_numpy(idx.reshape(N, T)), capacity, "expert",
        mesh=_mesh())
    return got.reshape(N * T, D).numpy(), want, tokens, scales


def test_ample_capacity_matches_jax():
    """tests/test_parallel.py::test_expert_parallel_dispatch_combine: every
    token processed by its assigned expert."""
    idx = np.random.RandomState(9).randint(0, N, (N, T))
    got, want, tokens, scales = _scaled(T, idx, 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tokens * scales[idx.reshape(-1)][:,
                                                                         None])


def test_overflow_matches_jax():
    """Capacity 2 of buckets of ~4 tokens per (rank, expert): the first two
    tokens of each bucket are kept, the rest are zero."""
    idx = np.random.RandomState(3).randint(0, N, (N, T))
    got, want, tokens, scales = _scaled(2, idx, 3)
    np.testing.assert_array_equal(got, want)
    dropped = ~got.any(-1)
    assert 0 < dropped.sum() < N * T


def test_out_of_range_and_negative_assignments_are_dropped():
    """tests/test_parallel.py:212-227 (all >= n_experts), here mixed with
    negative indices and valid ones: the invalid ones yield zeros, not
    another expert's output, and the gather index never leaves the
    buffer."""
    idx = np.random.RandomState(4).randint(0, N, (N, T))
    idx[:, ::3] = N + 3
    idx[:, 1::5] = -1
    got, want, tokens, scales = _scaled(T, idx, 4)
    np.testing.assert_array_equal(got, want)
    bad = (idx.reshape(-1) < 0) | (idx.reshape(-1) >= N)
    assert not got[bad].any()
    np.testing.assert_array_equal(
        got[~bad], (tokens * scales[np.clip(idx.reshape(-1), 0, N - 1)][
            :, None])[~bad])
    all_bad = np.full((N, T), N + 3)
    got, want, _, _ = _scaled(8, all_bad, 5)
    np.testing.assert_array_equal(got, np.zeros_like(got))
    np.testing.assert_array_equal(want, np.zeros_like(want))


def test_grads_match_jax_grad():
    """A tanh expert with its own weight per rank; the grads of
    sum(sin(out)) in the tokens and the weights against jax.grad of the
    JAX shard_map, with overflow (capacity 3) so dropped tokens get none."""
    rng = np.random.RandomState(12)
    tokens = rng.randn(N * T, D).astype(np.float32)
    idx = rng.randint(0, N, N * T).astype(np.int32)
    w = (rng.randn(N, D, D) / np.sqrt(D)).astype(np.float32)
    mesh = jax_make_mesh({"expert": N}, devices=jax.devices()[:N])

    def loss_j(tok, ww):
        f = jax.shard_map(
            lambda t, i, wr: jax_dispatch(lambda x: jnp.tanh(x @ wr[0]), t,
                                          i, 3, "expert"),
            mesh=mesh, in_specs=(P("expert"),) * 3, out_specs=P("expert"))
        out = f(tok, jnp.asarray(idx), ww)
        return jnp.sum(jnp.sin(out)), out

    (_, want), (g_tok, g_w) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(tokens, w)
    tok = torch.from_numpy(tokens).view(N, T, D).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = dispatch_combine(lambda x: torch.tanh(torch.bmm(x, wt)), tok,
                           torch.from_numpy(idx).view(N, T), 3, "expert",
                           mesh=_mesh())
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().reshape(N * T, D).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tok.grad.reshape(N * T, D).numpy(),
                               np.asarray(g_tok), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(g_w), rtol=1e-5,
                               atol=1e-6)


def test_rejects_a_misshapen_index():
    with pytest.raises(ValueError, match="expert_idx"):
        dispatch_combine(lambda x: x, torch.zeros((N, T, D)),
                         torch.zeros((N, T + 1), dtype=torch.long), 4,
                         "expert", mesh=_mesh())


def _dense_reference(tokens, idx, w_up, w_down):
    """Each kept token through its expert's MLP directly, in f32 from the
    bf16 inputs; dropped tokens zero. Differentiable."""
    n, t, _ = tokens.shape
    one_hot = idx[..., None] == torch.arange(n)
    pos = ((torch.cumsum(one_hot.long(), 1) - 1) * one_hot).sum(-1)
    keep = pos < EP_CAPACITY
    out = torch.zeros(tokens.shape)
    for e in range(n):
        sel = keep & (idx == e)
        x = tokens[sel].float()
        y = expert_mlp(x[None], w_up[e:e + 1].float(),
                       w_down[e:e + 1].float())[0]
        out = out.index_put(torch.nonzero(sel, as_tuple=True), y)
    return out, keep


def test_ep_entry_on_cpu():
    """ep_entry at full size on the CPU: each kept token is its expert's
    MLP applied to it, each dropped token exactly zero, and the grads of
    sum(sin(out)) agree with the dense reference's."""
    fn, (tokens, idx, w_up, w_down, mesh) = ep_entry("cpu")
    assert tuple(tokens.shape) == (EP_MESH["expert"], EP_TOKENS, 256)
    before = ring.alltoall.launches
    out, grads = fn(tokens, idx, w_up, w_down, mesh)
    assert ring.alltoall.launches == before  # twins on the CPU
    leaves = [x.detach().requires_grad_() for x in (tokens, w_up, w_down)]
    ref, keep = _dense_reference(leaves[0], idx, leaves[1], leaves[2])
    torch.sin(ref).sum().backward()
    assert 0 < int((~keep).sum()) < keep.numel()
    assert not bool(out[~keep].any())
    kept, want = out[keep].float(), ref.detach()[keep]
    assert float((kept - want).norm() / want.norm()) < 2e-2
    for g, leaf in zip(grads, leaves):
        assert g.shape == leaf.shape and bool(torch.isfinite(g.float()).all())
        rel = float((g.float() - leaf.grad.float()).norm()
                    / leaf.grad.float().norm())
        assert rel < 2e-2, rel
    assert not bool(grads[0][~keep].any())
