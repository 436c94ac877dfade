"""Multi-process device-plane bootstrap.

Counterpart of gloo_tpu/tpu/multihost.py. The reference wires two planes
from one set of coordinates: the host plane (rank 0's TcpStoreServer, a
Context connected over a TcpStore) and the device plane
(``jax.distributed`` and a global mesh, over which its Pallas ring
kernels address chips that other processes own). Here the host plane is
the same, on the port's TcpStoreServer, TcpStore, Context and Device; the
device plane is an exchange, through the same store, of each process's
local devices, then a process mesh over the global list (tpu/mesh.py),
whose collectives run the ring kernels' cross-process instances over
CUDA IPC peer-mapped memory (tpu/peer.py, csrc/ring.cu):

    ctx, mesh = init_multihost(rank, size, "host0:29500",
                               mesh_axes={"data": -1})

After it returns, ``mesh`` spans every process's devices (flat ranks
process-major), ``mesh.local_ranks`` are this process's, and ``ctx`` is
the host-plane process group (one rank per process). ``torch.distributed``
is not started: the reference's ``jax.distributed`` also carried XLA's own
collectives (spmd's psum, all_gather) across hosts, whose counterpart
comes later (ROADMAP A.7).
"""

from __future__ import annotations

import socket
from typing import Mapping, Optional, Sequence, Tuple

import torch

from gloo_tpu_torch.core import (Context, Device, TcpStore,
                                 TcpStoreServer)
from gloo_tpu_torch.device import resolve_device
from gloo_tpu_torch.tpu.mesh import Mesh, make_mesh
from gloo_tpu_torch.tpu.peer import PeerWorkspace, exchange


def local_devices(rank: int, devices: Optional[Sequence] = None):
    """This process's devices: `devices` as given, else one rank on
    cuda:(rank % device_count). Raises without a card unless the devices
    are given (devices=["cpu"] for a process on the CPU)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a process needs at least one device")
        for d in devs:
            resolve_device(d)
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] to "
            "init_multihost to run on the CPU with the plain PyTorch "
            "versions of the kernels")
    return [torch.device("cuda", rank % torch.cuda.device_count())]


def init_multihost(rank: int, size: int, store_address: str,
                   mesh_axes: Optional[Mapping[str, int]] = None,
                   timeout: float = 120.0,
                   device_hostname: Optional[str] = None, *,
                   devices: Optional[Sequence] = None
                   ) -> Tuple[Context, Mesh]:
    """Initialize both planes. `store_address` is host:port; rank 0 hosts
    the TcpStoreServer there. `device_hostname` is the name this process
    advertises for host-plane traffic (default: the machine hostname).
    `devices` are this process's local devices (default: one,
    cuda:(rank % device_count)); `mesh_axes` shape the global mesh
    (default: one "data" axis over every process's devices).

    Returns (ctx, mesh): the connected host-plane Context (it holds rank
    0's store server, and closing it closes the mesh's peer workspace
    first) and the process mesh."""
    local = local_devices(rank, devices)
    host, port_str = store_address.rsplit(":", 1)
    port = int(port_str)

    server = None
    if rank == 0:
        server = TcpStoreServer("0.0.0.0", port)
    store = TcpStore(host, port)

    # Host plane: full-mesh process group.
    if device_hostname is None:
        device_hostname = socket.gethostname()
    ctx = Context(rank, size, timeout=timeout)
    ctx.connect_full_mesh(store, Device(hostname=device_hostname))
    ctx._store_server = server  # pin the server to the context's lifetime

    # Device plane: every process's local devices, in process order.
    per_process = exchange(ctx, store, "gloo_tpu_torch/devices",
                           [str(d) for d in local])
    flat = [d for devs in per_process for d in devs]
    owners = [q for q, devs in enumerate(per_process) for _ in devs]
    mesh = make_mesh(mesh_axes, devices=flat, process_of=owners,
                     process=rank)
    mesh.context, mesh.store = ctx, store
    if mesh.device.type == "cuda":
        mesh.workspace = PeerWorkspace(mesh, ctx, store, mesh.device)
        ctx.on_close(mesh.workspace.close)
    return ctx, mesh
