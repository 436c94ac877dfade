"""Fused tensor parallelism on the PyTorch/CUDA port: the Megatron-SP MLP
with both collectives fused into their matmuls, over a world of ranks on
one card.

The counterpart of examples/example_fused_tp.py. The sequence dim stays
sharded outside the block; inside, the up-projection runs
allgather_matmul (B5b: each ring hop is consumed by the next chunk's
product) and the down-projection matmul_reduce_scatter (B5a), forward and
backward (the two kernels are each other's VJP). The *_auto wrappers
choose per shape whether fusing pays.
    python examples/torch_fused_tp.py              # on the card
    python examples/torch_fused_tp.py --device cpu # plain versions
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from gloo_tpu_torch.device import resolve_device  # noqa: E402
from gloo_tpu_torch.parallel.tp import (  # noqa: E402
    allgather_matmul_dense, allgather_matmul_dense_auto,
    row_parallel_dense_scattered, row_parallel_dense_scattered_auto,
    use_fused_overlap)
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

RANKS = 8
TOL = 2e-3  # the reference example's bound on max |fused - dense|


def inputs(n=RANKS):
    """The reference example's x (16 n, 64), w_up (64, 32 n) and
    w_down (32 n, 64), f32 from np.random.RandomState(0)."""
    seq, d_model, d_ff = 16 * n, 64, 32 * n
    rng = np.random.RandomState(0)
    x = rng.normal(size=(seq, d_model)).astype(np.float32) * 0.1
    w_up = rng.normal(size=(d_model, d_ff)).astype(np.float32) * 0.1
    w_down = rng.normal(size=(d_ff, d_model)).astype(np.float32) * 0.1
    return x, w_up, w_down


def _gelu(h):
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default


def run(dev, n=RANKS):
    """The example's computation over a ring of n ranks on `dev`: the
    fused block's output (seq, d_model), dL/dw_up (d_model, d_ff) of
    L = mean(out ** 2) through the fused VJPs, the *_auto block's output,
    the dense reference and the dispatcher's pick, as numpy arrays."""
    x, w_up, w_down = (torch.as_tensor(a, device=dev) for a in inputs(n))
    seq, d_model = x.shape
    d_ff = w_up.shape[1]
    mesh = make_mesh({"model": n}, devices=[dev] * n)
    # Rank r holds rows r of x, columns r of w_up and rows r of w_down.
    xs = x.view(n, seq // n, d_model)
    wu = w_up.view(d_model, n, d_ff // n).permute(1, 0, 2).contiguous()
    wd = w_down.view(n, d_ff // n, d_model)

    def block(xs, wu, wd):
        h = _gelu(allgather_matmul_dense(xs, wu, "model", mesh=mesh))
        return row_parallel_dense_scattered(h, wd, "model", mesh=mesh)

    def block_auto(xs, wu, wd):
        h = _gelu(allgather_matmul_dense_auto(xs, wu, "model", mesh=mesh))
        return row_parallel_dense_scattered_auto(h, wd, "model", mesh=mesh)

    with torch.no_grad():
        y = block(xs, wu, wd).reshape(seq, d_model)
        y_auto = block_auto(xs, wu, wd).reshape(seq, d_model)
        ref = _gelu(x @ w_up) @ w_down
    leaf = wu.detach().requires_grad_()
    (g,) = torch.autograd.grad(block(xs, leaf, wd).square().mean(), leaf)
    grad_w_up = g.permute(1, 0, 2).reshape(d_model, d_ff)
    picked = use_fused_overlap(seq, d_ff // n, d_model, n)
    return {"y": y.cpu().numpy(), "grad_w_up": grad_w_up.cpu().numpy(),
            "y_auto": y_auto.cpu().numpy(), "ref": ref.cpu().numpy(),
            "picked": picked}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev)
    err = float(np.abs(out["y"] - out["ref"]).max())
    print(f"mesh: {{'model': {RANKS}}} on {dev}  fused MLP out "
          f"{out['y'].shape}  max|err| {err:.2e}")
    if not err < TOL:
        raise AssertionError(f"fused MLP off the dense one by {err}")
    # Gradients flow through the dual kernels (no unfused collective in
    # the backward either).
    g = out["grad_w_up"]
    print(f"dL/dw_up via fused VJPs: {g.shape}, |g| {np.abs(g).mean():.2e}")
    # The *_auto wrappers fuse where the collective's share of the step
    # exceeds the fused kernels' compute penalty (use_fused_overlap); with
    # no measured ratio they take the unfused arm. TPUCOLL_TP_OVERLAP=
    # fused|unfused forces either arm; parallel.measure_fused_ratio()
    # gives a ratio measured on the card.
    auto_err = float(np.abs(out["y_auto"] - out["ref"]).max())
    if not auto_err < TOL:
        raise AssertionError(f"auto MLP off the dense one by {auto_err}")
    print(f"auto dispatcher on this shape/mesh picks: "
          f"{'fused' if out['picked'] else 'unfused'}")
    print("fused tensor-parallel example OK")
    return out


if __name__ == "__main__":
    main()
