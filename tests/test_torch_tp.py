"""gloo_tpu_torch.parallel.tp against gloo_tpu.parallel.tp.

The TP layers run on a CPU world of 4 ranks (the plain twins of B3, B4a,
B4b, B5a and B5b) and are held against the JAX functions inside
shard_map over 4 CPU devices, on the same numpy inputs (the forms of
tests/test_parallel.py and tests/test_tp_dispatch.py). The dispatch rule
is held against JAX's on the same (share, ratio) inputs.

Tolerances (f32): the sums over ranks run in ring order on the port's side
and in XLA's order (psum) or the interpreted kernels' on the JAX side, so
results agree to rtol 1e-5, atol 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.parallel import tp as jax_tp  # noqa: E402
from gloo_tpu_torch.parallel import tp  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

N = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _jax(fn, in_specs, out_specs, *args, axis="x"):
    mesh = JaxMesh(np.asarray(jax.devices()[:N], dtype=object), (axis,))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=False))
    return np.asarray(f(*args))


def _mesh(axis="x"):
    return make_mesh({axis: N}, devices=["cpu"] * N)


def _world(a, along=None):
    """A replicated (along None) or split numpy array as a world tensor."""
    if along is None:
        return torch.from_numpy(a).expand(N, *a.shape).contiguous()
    return torch.from_numpy(np.stack(np.split(a, N, axis=along)))


def test_tp_mlp_block_matches_jax():
    """test_parallel.py::test_tp_mlp_block_matches_dense's form."""
    d, ff = 16, 32 * N
    rng = np.random.RandomState(2)
    x = rng.randn(4, d).astype(np.float32)
    w_up = rng.randn(d, ff).astype(np.float32) * 0.1
    w_down = rng.randn(ff, d).astype(np.float32) * 0.1
    ref = _jax(lambda a, b, c: jax_tp.tp_mlp_block(a, b, c, "model"),
               (P(), P(None, "model"), P("model", None)), P(),
               x, w_up, w_down, axis="model")
    out = tp.tp_mlp_block(_world(x), _world(w_up, 1), _world(w_down, 0),
                          "model", mesh=_mesh("model"))
    for r in range(N):
        np.testing.assert_allclose(out[r].numpy(), ref, **TOL)
        assert torch.equal(out[r], out[0])


def test_row_and_column_parallel_dense_match_jax():
    x = _rand((8, 32), 3)
    w = _rand((32, 24), 4)
    ref = _jax(lambda a, b: jax_tp.row_parallel_dense(a, b, "x"),
               (P(None, "x"), P("x", None)), P(), x, w)
    out = tp.row_parallel_dense(_world(x, 1), _world(w, 0), "x",
                                mesh=_mesh())
    for r in range(N):
        np.testing.assert_allclose(out[r].numpy(), ref, **TOL)
    ref = _jax(lambda a, b: jax_tp.column_parallel_dense(a, b, "x"),
               (P(), P(None, "x")), P(None, "x"), x, w)
    out = tp.column_parallel_dense(_world(x), _world(w, 1), "x")
    np.testing.assert_allclose(np.concatenate(list(out.numpy()), 1), ref,
                               **TOL)


def test_row_parallel_dense_is_differentiable():
    """The allreduce's VJP (B3 of the cotangent) gives the dense
    gradients."""
    x, w = _rand((8, 32), 5), _rand((32, 24), 6)
    xw = _world(x, 1).requires_grad_()
    ww = _world(w, 0).requires_grad_()
    y = tp.row_parallel_dense(xw, ww, "x", mesh=_mesh())
    (y[0] ** 2).sum().backward()
    xd = torch.from_numpy(x).requires_grad_()
    wd = torch.from_numpy(w).requires_grad_()
    ((xd @ wd) ** 2).sum().backward()
    torch.testing.assert_close(torch.cat(list(xw.grad), 1), xd.grad, **TOL)
    torch.testing.assert_close(torch.cat(list(ww.grad), 0), wd.grad, **TOL)


# ---- dispatch ----

def test_env_override_forces_both_ways_and_bad_values_raise(monkeypatch):
    monkeypatch.setenv("TPUCOLL_TP_OVERLAP", "fused")
    assert tp.use_fused_overlap(2048, 4096, 4096, 8, comm_share=0.0,
                                ratio=0.5)
    assert tp.use_fused_overlap(2048, 4096, 4096, 8)
    monkeypatch.setenv("TPUCOLL_TP_OVERLAP", "unfused")
    assert not tp.use_fused_overlap(4096, 2048, 2048, 8, comm_share=0.99,
                                    ratio=0.99)
    monkeypatch.setenv("TPUCOLL_TP_OVERLAP", "bogus")
    with pytest.raises(ValueError, match="TPUCOLL_TP_OVERLAP"):
        tp.use_fused_overlap(4096, 2048, 2048, 8, comm_share=0.5, ratio=0.9)
    # The same message as JAX's.
    with pytest.raises(ValueError) as ours:
        tp.use_fused_overlap(64, 64, 64, 4)
    with pytest.raises(ValueError) as theirs:
        jax_tp.use_fused_overlap(64, 64, 64, 4)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("share", [0.0, 0.05, 0.1, 0.32, 0.4, 0.9])
@pytest.mark.parametrize("ratio", [0.68, 0.79, 0.93, 0.95, 1.0])
def test_decision_matches_jax_for_the_same_share_and_ratio(
        monkeypatch, share, ratio):
    monkeypatch.delenv("TPUCOLL_TP_OVERLAP", raising=False)
    for m, k, cols, p in ((4096, 2048, 2048, 8), (2048, 4096, 4096, 8),
                          (256, 256, 256, 4)):
        assert tp.use_fused_overlap(m, k, cols, p, comm_share=share,
                                    ratio=ratio) == \
            jax_tp.use_fused_overlap(m, k, cols, p, comm_share=share,
                                     ratio=ratio)


def test_no_share_or_no_ratio_means_unfused(monkeypatch):
    monkeypatch.delenv("TPUCOLL_TP_OVERLAP", raising=False)
    assert not tp.use_fused_overlap(4096, 2048, 2048, 8)
    assert not tp.use_fused_overlap(4096, 2048, 2048, 8, comm_share=0.9)
    assert not tp.use_fused_overlap(4096, 2048, 2048, 8, ratio=0.99)
    # A ring of one has no collective to hide.
    assert not tp.use_fused_overlap(4096, 2048, 2048, 1, ratio=0.99)


def test_estimate_comm_share_matches_jax_for_the_same_rates():
    rates = dict(link_bytes_per_s=45e9, flops_per_s=300e12)
    for m, k, cols, p, wire in ((4096, 2048, 2048, 8, None),
                                (4096, 2048, 8192, 8, 4096 * 2048),
                                (256, 256, 256, 4, None)):
        ours = tp.estimate_comm_share(m, k, cols, p, wire_elems=wire,
                                      **rates)
        ref = jax_tp.estimate_comm_share(m, k, cols, p, wire_elems=wire,
                                         ici_bytes_per_s=45e9,
                                         flops_per_s=300e12)
        assert ours == pytest.approx(ref, rel=1e-12)
    assert tp.estimate_comm_share(4096, 2048, 2048, 1, **rates) == 0.0


def test_measure_fused_ratio_mechanism():
    """On the CPU the probe runs the twins: a number, never cached. A
    cached probe (seeded here, as a run on the card leaves one) is what
    the *_auto wrappers read."""
    tp._PROBE_CACHE.clear()
    r = tp.measure_fused_ratio(32, 16, 4, chain=2, reps=1, device="cpu")
    assert isinstance(r, float) and r > 0.0
    assert tp._PROBE_CACHE == {}
    with pytest.raises(ValueError, match="divisible"):
        tp.measure_fused_ratio(30, 16, 4, device="cpu")
    with pytest.raises(ValueError, match="chain"):
        tp.measure_fused_ratio(32, 16, 4, chain=1, device="cpu")


def _arm_spy(monkeypatch):
    calls = []
    for name in ("row_parallel_dense_scattered", "allgather_matmul_dense"):
        real = getattr(tp, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tp, name, spy)
    return calls


def test_auto_takes_the_unfused_arm_without_a_probe(monkeypatch):
    monkeypatch.delenv("TPUCOLL_TP_OVERLAP", raising=False)
    tp._PROBE_CACHE.clear()
    calls = _arm_spy(monkeypatch)
    mesh = _mesh()
    x, w = _world(_rand((32, 64), 7), 1), _world(_rand((64, 16), 8), 0)
    tp.row_parallel_dense_scattered_auto(x, w, "x", comm_share=0.9,
                                         mesh=mesh)
    xs, ws = _world(_rand((32, 16), 9), 0), _world(_rand((16, 16), 10))
    tp.allgather_matmul_dense_auto(xs, ws, "x", comm_share=0.9, mesh=mesh)
    assert calls == []
    # With a probe cached for the shape, the same share fuses.
    tp._PROBE_CACHE[(32, 16, N, str(torch.float32))] = 0.95
    tp.row_parallel_dense_scattered_auto(x, w, "x", comm_share=0.9,
                                         mesh=mesh)
    tp.allgather_matmul_dense_auto(xs, ws, "x", comm_share=0.9, mesh=mesh)
    tp._PROBE_CACHE.clear()
    assert calls == ["row_parallel_dense_scattered", "allgather_matmul_dense"]


@pytest.mark.parametrize("force", ["fused", "unfused"])
def test_both_arms_match_jax(force, monkeypatch):
    """test_tp_dispatch.py's *_auto_both_paths tests: each forced arm
    against the JAX function's forced arm on the same inputs, and the
    Megatron-SP pair of dryrun_multichip through both wrappers."""
    monkeypatch.setenv("TPUCOLL_TP_OVERLAP", force)
    mesh = _mesh()
    m, k_total, cols = 8 * N, 16 * N, 128
    x, w = _rand((m, k_total), 0), _rand((k_total, cols), 1)
    ref = _jax(lambda a, b: jax_tp.row_parallel_dense_scattered_auto(
        a, b, "x", interpret=True), (P(None, "x"), P("x", None)),
        P("x", None), x, w)
    out = tp.row_parallel_dense_scattered_auto(_world(x, 1), _world(w, 0),
                                               "x", mesh=mesh)
    np.testing.assert_allclose(out.reshape(m, cols).numpy(), ref, **TOL)
    x2, w2 = _rand((m, 32), 2), _rand((32, cols), 3)
    ref = _jax(lambda a, b: jax_tp.allgather_matmul_dense_auto(
        a, b, "x", interpret=True), (P("x", None), P(None, None)),
        P(None, None), x2, w2)
    out = tp.allgather_matmul_dense_auto(_world(x2, 0), _world(w2), "x",
                                         mesh=mesh)
    for r in range(N):
        np.testing.assert_allclose(out[r].numpy(), ref, **TOL)
    # dryrun_multichip's pair: the arm against the fused result.
    ov_x = np.full((8 * N, 16), 0.01, np.float32)
    ov_wu = np.full((16, 16 * N), 0.02, np.float32)
    ov_wd = np.full((16 * N, 128), 0.03, np.float32)
    args = (_world(ov_x, 0), _world(ov_wu, 1), _world(ov_wd, 0))
    fused = tp.row_parallel_dense_scattered(
        tp.allgather_matmul_dense(args[0], args[1], "x", mesh=mesh),
        args[2], "x", mesh=mesh)
    arm = tp.row_parallel_dense_scattered_auto(
        tp.allgather_matmul_dense_auto(args[0], args[1], "x", mesh=mesh),
        args[2], "x", mesh=mesh)
    np.testing.assert_allclose(arm.numpy(), fused.numpy(), rtol=1e-5)


def test_unfused_arms_are_differentiable(monkeypatch):
    """The unfused arms ride B4a and B4b, whose VJPs are each other: the
    gradients equal the fused pair's."""
    mesh = _mesh()
    x0 = _world(_rand((8 * N, 16), 11), 0)
    wu0 = _world(_rand((16, 8 * N), 12), 1)
    wd0 = _world(_rand((8 * N, 16), 13), 0)
    grads = {}
    for force in ("fused", "unfused"):
        monkeypatch.setenv("TPUCOLL_TP_OVERLAP", force)
        leaves = [t.clone().requires_grad_() for t in (x0, wu0, wd0)]
        y = tp.row_parallel_dense_scattered_auto(
            torch.tanh(tp.allgather_matmul_dense_auto(
                leaves[0], leaves[1], "x", mesh=mesh)), leaves[2], "x",
            mesh=mesh)
        (y ** 2).sum().backward()
        grads[force] = [t.grad for t in leaves]
    for a, b in zip(grads["fused"], grads["unfused"]):
        torch.testing.assert_close(a, b, **TOL)


def test_jax_dispatch_functions_exist_in_the_port():
    for name in ("column_parallel_dense", "row_parallel_dense",
                 "tp_mlp_block", "row_parallel_dense_scattered",
                 "allgather_matmul_dense", "estimate_comm_share",
                 "use_fused_overlap", "measure_fused_ratio",
                 "row_parallel_dense_scattered_auto",
                 "allgather_matmul_dense_auto"):
        assert callable(getattr(tp, name)) and hasattr(jax_tp, name)
    # Not carried over: the TPU calibration (ROADMAP ground rule 4).
    assert not hasattr(tp, "fused_compute_ratio")
