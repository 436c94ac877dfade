"""Launcher-environment bootstrap: a Context from mpirun, srun or
torchrun.

Counterpart of gloo_tpu/bootstrap.py over the port's host plane. Every
mainstream launcher exports the rank and world size into the environment;
``init_from_env`` reads them and runs the ordinary TcpStore rendezvous,
with rank 0 serving the store:

    ctx, server = gloo_tpu_torch.init_from_env()   # inside torchrun etc.

Recognized (first match wins):
  rank/size: RANK + WORLD_SIZE (torchrun), OMPI_COMM_WORLD_RANK/_SIZE
    (Open MPI), PMI_RANK/PMI_SIZE (MPICH/Hydra), SLURM_PROCID/
    SLURM_NTASKS (srun).
  store endpoint: MASTER_ADDR[:MASTER_PORT] (torchrun exports these; for
    mpirun/srun export them yourself). Default 127.0.0.1:29400 suits
    single-host launches.

Under an MPI launch (OMPI_*/PMI_* present) with mpi4py importable, the
endpoint is instead gathered from rank 0 over the live communicator. The
gate is the launcher's environment, never mere importability, so a
torchrun job on a machine that has mpi4py never calls MPI_Init.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

from gloo_tpu_torch.core import (Context, Device, PrefixStore, TcpStore,
                                 TcpStoreServer)

_RANK_VARS = (
    ("RANK", "WORLD_SIZE"),
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
    ("PMI_RANK", "PMI_SIZE"),
    ("SLURM_PROCID", "SLURM_NTASKS"),
)

_DEFAULT_PORT = 29400


def detect_launch_env(env=None):
    """(rank, size) from the launcher's environment, or None when no
    recognized launcher variables are present."""
    env = os.environ if env is None else env
    for rank_var, size_var in _RANK_VARS:
        if rank_var in env and size_var in env:
            return int(env[rank_var]), int(env[size_var])
    return None


def _mpi_endpoint(env_rank: int, host: str, port: int):
    """Gather rank 0's store endpoint over the MPI communicator when
    mpi4py is present (the reference mpi::Context bootstrap). Allgather
    rather than bcast-from-root-0: the serving rank is ENV rank 0,
    which need not share the communicator's numbering (e.g. a stray
    RANK export alongside OMPI vars). Returns (host, port) or None
    without mpi4py.

    The live-communicator branch is a copy of the reference's, which
    has never run under a real MPI launch either; the tests exercise the
    ImportError fallback (the environment's endpoint)."""
    try:
        from mpi4py import MPI  # noqa: PLC0415 - optional dependency
    except ImportError:
        return None
    comm = MPI.COMM_WORLD
    vals = comm.allgather((host, port) if env_rank == 0 else None)
    return next((v for v in vals if v is not None), None)


def init_from_env(device: Optional[Device] = None, timeout: float = 30.0,
                  prefix: str = "tc-env", env=None):
    """Connect a full-mesh Context from launcher environment variables,
    over `device` (default: a new Device on this rank's bind address),
    with its rendezvous keys under `prefix`.

    Returns (context, store_server): store_server is the rank-0-owned
    TcpStoreServer (None elsewhere) — keep it referenced for the life
    of the job; later contexts can rendezvous through the same server
    (a TcpStore at MASTER_ADDR:MASTER_PORT) under another prefix. Raises
    RuntimeError outside a recognized launcher (no silent single-rank
    fallback: a rank that missed its launcher vars would otherwise split
    the job into broken islands).
    """
    env = os.environ if env is None else env
    detected = detect_launch_env(env)
    if detected is None:
        raise RuntimeError(
            "init_from_env: no launcher environment found (looked for "
            + ", ".join("/".join(v) for v in _RANK_VARS)
            + "); set RANK and WORLD_SIZE or use an explicit store")
    rank, size = detected
    host = env.get("MASTER_ADDR", "127.0.0.1")
    port = int(env.get("MASTER_PORT", _DEFAULT_PORT))

    server = None
    if rank == 0:
        # Serve on the advertised port; bind-all so any MASTER_ADDR
        # interface works.
        server = TcpStoreServer("0.0.0.0", port)
        port = server.port
    # Clients cannot dial "" / 0.0.0.0: normalize bind-all or loopback
    # MASTER_ADDR to something resolvable before anyone connects.
    dial_host = host if host not in ("", "0.0.0.0") else "127.0.0.1"

    # MPI-communicator endpoint exchange: gated on the LAUNCHER env so
    # non-MPI jobs never touch MPI_Init even with mpi4py installed.
    mpi_launch = "OMPI_COMM_WORLD_RANK" in env or "PMI_RANK" in env
    if mpi_launch:
        ep = _mpi_endpoint(rank, _advertised_host(dial_host), port)
        if ep is not None:
            dial_host, port = ep

    store = PrefixStore(TcpStore(dial_host, port), prefix)
    dev = device if device is not None else Device(
        hostname=_bind_host(env, dial_host))
    ctx = Context(rank, size, timeout=timeout)
    ctx.connect_full_mesh(store, dev)
    return ctx, server


def _advertised_host(host: str) -> str:
    """A peer-dialable address: pass real addresses through, replace
    loopback/bind-all with this host's resolvable address."""
    if host not in ("", "0.0.0.0", "127.0.0.1", "localhost"):
        return host
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _bind_host(env, dial_host: str) -> str:
    """The transport bind/advertise address for this rank: loopback for
    single-host launches (the default elsewhere in the package), the
    rank's routable hostname when the launch spans hosts. A non-local
    store endpoint — including one learned over MPI — is itself the
    multi-host signal, which covers MPICH/PMI launches that export no
    node-count variable."""
    if env.get("TPUCOLL_HOSTNAME"):
        return env["TPUCOLL_HOSTNAME"]
    multi = (dial_host not in ("127.0.0.1", "localhost")
             or int(env.get("SLURM_NNODES", "1")) > 1
             or int(env.get("OMPI_COMM_WORLD_LOCAL_SIZE",
                            env.get("OMPI_COMM_WORLD_SIZE", "1")))
             < int(env.get("OMPI_COMM_WORLD_SIZE", "1")))
    if not multi:
        return "127.0.0.1"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
