"""Parallelism strategies on the port's device plane: data parallelism with
the gradient mean on the ring allreduce kernel (counterpart of
gloo_tpu/parallel/ddp.py's make_ddp_train_step)."""

from gloo_tpu_torch.parallel.ddp import make_ddp_train_step

__all__ = ["make_ddp_train_step"]
