"""The port's examples (examples/torch_*.py) against the reference's.

torch_device_plane's DDP losses are held against gloo_tpu's
make_ddp_train_step on the same weights (the JAX init from PRNGKey(0),
converted by gloo_tpu_torch.weights) with use_flash_attention=False and
f32 on both sides, at test_torch_ddp.py's tolerance (rtol 1e-5; the ring
adds rank gradients in ring order and XLA's psum in its own, and Adam
carries the difference along its 20 steps). torch_fused_tp's outputs are
held against example_fused_tp.py's computation in JAX (the Pallas kernels
interpreted on the 8-device CPU mesh), f32 products summed in another
order. The host-plane examples run as their users run them, on the CPU,
in processes that cannot import jax, and must print the markers that
tests/test_examples.py asserts for the reference's; the flight-recorder
example's dumps read the same through both packages' viewers.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.models import Transformer as JaxTransformer  # noqa: E402
from gloo_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from gloo_tpu.parallel import make_ddp_train_step as jax_ddp  # noqa: E402
from gloo_tpu.parallel.tp import (  # noqa: E402
    allgather_matmul_dense as jax_ag_dense,
    allgather_matmul_dense_auto as jax_ag_dense_auto,
    row_parallel_dense_scattered as jax_rs_dense,
    row_parallel_dense_scattered_auto as jax_rs_dense_auto)
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch import _lib, weights  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402
from tests.test_torch_tools import (load_file, no_jax_env,  # noqa: E402
                                    run_viewer)

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
LOSS_RTOL = 1e-5  # test_torch_ddp.py's
TP_TOL = dict(rtol=1e-5, atol=1e-6)


def load(name):
    return load_file(EXAMPLES / f"{name}.py")


def test_device_plane_losses_match_jax_ddp():
    ex = load("torch_device_plane")
    cfg = dataclasses.replace(ex.CONFIG, dtype=torch.float32,
                              use_flash_attention=False)
    kw = {f: getattr(cfg, f) for f in ("vocab_size", "d_model", "n_heads",
                                       "n_layers", "d_ff", "max_seq_len")}
    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, use_flash_attention=False,
                                  **kw))
    jparams = jm.init(jax.random.PRNGKey(0))
    state = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tx = optax.adam(ex.LR)
    jstate = tx.init(jparams)
    jstep = jax_ddp(jm.loss, tx, jax_make_mesh(
        {"data": ex.RANKS}, devices=jax.devices()[:ex.RANKS]))
    tokens, targets = ex.batch(cfg)
    jlosses = []
    for _ in range(ex.STEPS):
        jparams, jstate, loss = jstep(jparams, jstate, (tokens, targets))
        jlosses.append(float(loss))
    mesh = make_mesh({"data": ex.RANKS}, devices=["cpu"] * ex.RANKS)
    losses = ex.ddp_losses(mesh, cfg, state=state, log=lambda _: None)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)


def test_device_plane_example_on_the_cpu(capsys):
    """The example as shipped: bf16, the flash kernels' plain versions,
    the loss falling over its 20 steps."""
    losses = load("torch_device_plane").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "allreduce : [112. 120. 128. 136.]" in out
    assert "broadcast : [0. 1. 2. 3.]" in out
    assert out.rstrip().endswith("done")
    assert len(losses) == 20 and losses[-1] < losses[0]


def jax_fused_tp(x, w_up, w_down):
    """example_fused_tp.py's computation: the fused block, dL/dw_up of
    mean(out ** 2) and the *_auto block, over the 8-device CPU mesh."""
    mesh = jax_make_mesh({"model": -1})
    specs = dict(in_specs=(P("model", None), P(None, "model"),
                           P("model", None)),
                 out_specs=P("model", None), check_vma=False)

    def block(xs, wu, wd):
        h = jax.nn.gelu(jax_ag_dense(xs, wu, "model", interpret=True))
        return jax_rs_dense(h, wd, "model", interpret=True)

    def block_auto(xs, wu, wd):
        h = jax.nn.gelu(jax_ag_dense_auto(xs, wu, "model", interpret=True))
        return jax_rs_dense_auto(h, wd, "model", interpret=True)

    fused = jax.jit(jax.shard_map(block, mesh=mesh, **specs))
    y = np.asarray(fused(x, w_up, w_down))

    def loss(xs, wu, wd):
        out = jax.shard_map(block, mesh=mesh, **specs)(xs, wu, wd)
        return jnp.mean(out ** 2)

    g = np.asarray(jax.grad(loss, argnums=1)(x, w_up, w_down))
    y_auto = np.asarray(jax.jit(jax.shard_map(block_auto, mesh=mesh,
                                              **specs))(x, w_up, w_down))
    return y, g, y_auto


def test_fused_tp_matches_jax(capsys, monkeypatch):
    monkeypatch.delenv("TPUCOLL_TP_OVERLAP", raising=False)
    ex = load("torch_fused_tp")
    out = ex.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "fused tensor-parallel example OK" in printed
    assert "auto dispatcher on this shape/mesh picks: unfused" in printed
    y, g, y_auto = jax_fused_tp(*ex.inputs())
    np.testing.assert_allclose(out["y"], y, **TP_TOL)
    np.testing.assert_allclose(out["grad_w_up"], g, **TP_TOL)
    np.testing.assert_allclose(out["y_auto"], y_auto, **TP_TOL)
    assert out["picked"] is False


def run_example(name, tmp_path, *extra, timeout=240):
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / name), "--device", "cpu", *extra],
        cwd=REPO, env=no_jax_env(tmp_path), capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, (name, proc.stdout[-2000:],
                                  proc.stderr[-3000:])
    return proc.stdout


def test_observability_example(tmp_path):
    out = run_example("torch_observability.py", tmp_path, "--out",
                      str(tmp_path))
    assert "observability example OK" in out
    assert "[watchdog] rank0 was blocked" in out
    assert "labeled rank rows" in out
    assert (tmp_path / "observability_trace.json").is_file()


def test_chaos_example(tmp_path):
    out = run_example("torch_chaos.py", tmp_path)
    assert "chaos example: OK" in out
    assert "fault firing sequence:" in out
    assert '"action": "stall"' in out and '"action": "kill"' in out
    assert "rebuilt OK" in out
    assert "[watchdog] rank0 was blocked" in out
    assert "merged chaos trace" in out


def test_flightrec_example_and_its_dumps(tmp_path, capsys):
    dumps = tmp_path / "flightrec-demo"
    out = run_example("torch_flightrec.py", tmp_path, "--out", str(dumps))
    assert "flightrec example: OK" in out
    assert "reason=stall blamed_peer=1" in out
    assert "desync verdict: collective desync" in out
    assert "merged Perfetto timeline" in out
    # The dumps read the same through both packages' viewers: a desync,
    # exit 2 under --check.
    seen = [run_viewer(REPO / "tools" / viewer, [str(dumps), "--check"],
                       capsys)
            for viewer in ("torch_flightrec_view.py", "flightrec_view.py")]
    assert seen[0] == seen[1]
    assert seen[0][0] == 2 and "verdict: DESYNC" in seen[0][1]


def test_recovery_example(tmp_path):
    out = run_example("torch_recovery.py", tmp_path)
    assert "recovery example: OK" in out
    assert out.count("finished 100 steps in world of 2") == 2
