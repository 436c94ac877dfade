"""Device-plane tour on the PyTorch/CUDA port: the array-level process
group and a data-parallel training step, over a world of ranks on one
card.

The counterpart of examples/example_device_plane.py: CudaProcessGroup's
shard, allreduce, broadcast and barrier over 8 ranks, then 20 steps of
make_ddp_train_step (gradients averaged by the ring allreduce B3, the
attention on the flash kernels B1 and B2) with torch.optim.Adam in place
of optax.
    python examples/torch_device_plane.py              # on the card
    python examples/torch_device_plane.py --device cpu # plain versions
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gloo_tpu_torch.device import resolve_device  # noqa: E402
from gloo_tpu_torch.models import Transformer, TransformerConfig  # noqa: E402
from gloo_tpu_torch.parallel import make_ddp_train_step  # noqa: E402
from gloo_tpu_torch.tpu import CudaProcessGroup, make_mesh  # noqa: E402

RANKS = 8
STEPS = 20
BATCH_PER_RANK = 4
LR = 3e-3
# The reference example's model, its attention on the flash kernels.
CONFIG = TransformerConfig(vocab_size=128, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_seq_len=32,
                           use_flash_attention=True)


def batch(cfg, ranks=RANKS):
    """The reference example's global batch: tokens from
    np.random.RandomState(0), targets the tokens shifted left by one."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (BATCH_PER_RANK * ranks,
                                             cfg.max_seq_len)).astype(
        np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def ddp_losses(mesh, cfg=CONFIG, state=None, steps=STEPS, log=print):
    """`steps` steps of make_ddp_train_step over `mesh` ("data" ranks),
    one replica and one Adam(LR) per rank, from `state` (a state_dict) or
    else the port's init from seed 0. Returns the mean loss of each
    step."""
    dev = mesh.device
    first = Transformer(cfg, device=dev)
    if state is None:
        first.init(torch.Generator().manual_seed(0))
    else:
        first.load_state_dict(state)
    replicas = [first]
    for _ in range(mesh.size - 1):
        m = Transformer(cfg, device=dev)
        m.load_state_dict(first.state_dict())
        replicas.append(m)
    optimizers = [torch.optim.Adam(m.parameters(), lr=LR) for m in replicas]
    step = make_ddp_train_step(lambda m, b: m.loss(*b), mesh, "data")
    tokens, targets = (torch.as_tensor(a, device=dev)
                       for a in batch(cfg, mesh.size))
    losses = []
    for i in range(steps):
        losses.append(float(step(replicas, optimizers, (tokens, targets))))
        if i % 5 == 0:
            log(f"ddp step {i:2d} loss {losses[-1]:.4f}")
    for m in replicas[1:]:
        if not all(torch.equal(p, q) for p, q in
                   zip(m.parameters(), first.parameters())):
            raise AssertionError("the replicas drifted apart")
    return losses


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_mesh({"data": RANKS}, devices=[dev] * RANKS)
    pg = CudaProcessGroup(mesh)
    print(f"mesh: {mesh.shape} on {dev}, group size {pg.size}")

    # Array-level collectives (host-API mirror): row r is rank r's value.
    x = pg.shard(np.arange(pg.size * 4, dtype=np.float32).reshape(pg.size,
                                                                  4))
    print("allreduce :", pg.unshard(pg.allreduce(x))[0])
    print("broadcast :", pg.unshard(pg.broadcast(x, root=0))[0])
    pg.barrier()

    # DDP training step: the batch split over the ranks, the gradients
    # averaged by one ring allreduce per step.
    losses = ddp_losses(mesh)
    if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    print("done")
    return losses


if __name__ == "__main__":
    main()
