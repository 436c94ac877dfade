"""gloo_tpu_torch.init_from_env against gloo_tpu.init_from_env: the same
launcher environments give the same (rank, size), no launcher gives the
same loud error, and a Context comes up over real processes that see
nothing but a launcher's variables (rank 0 serves the TcpStore)."""

import os
import subprocess
import sys
import textwrap

import pytest

import gloo_tpu_torch
from gloo_tpu_torch import _lib, bootstrap

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENVS = [
    {},
    {"RANK": "3", "WORLD_SIZE": "8"},
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4"},
    {"PMI_RANK": "0", "PMI_SIZE": "2"},
    {"SLURM_PROCID": "5", "SLURM_NTASKS": "6"},
    {"RANK": "1", "WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "9",
     "OMPI_COMM_WORLD_SIZE": "9"},
    {"RANK": "1"},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "PMI_RANK": "1",
     "PMI_SIZE": "3"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(e) or "none")
def test_detect_launch_env_matches_the_reference(env):
    from gloo_tpu import bootstrap as ref

    assert gloo_tpu_torch.detect_launch_env(env) == \
        ref.detect_launch_env(env)
    assert bootstrap._RANK_VARS == ref._RANK_VARS


def test_bind_host_matches_the_reference():
    from gloo_tpu import bootstrap as ref

    for env, dial in (({}, "127.0.0.1"), ({"SLURM_NNODES": "1"}, "localhost"),
                      ({"TPUCOLL_HOSTNAME": "10.0.0.7"}, "127.0.0.1"),
                      ({"OMPI_COMM_WORLD_SIZE": "2",
                        "OMPI_COMM_WORLD_LOCAL_SIZE": "2"}, "127.0.0.1")):
        assert bootstrap._bind_host(env, dial) == ref._bind_host(env, dial)
    assert bootstrap._advertised_host("10.1.2.3") == "10.1.2.3"


def test_init_from_env_requires_a_launcher():
    with pytest.raises(RuntimeError, match="no launcher environment"):
        gloo_tpu_torch.init_from_env(env={})


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import gloo_tpu_torch

    ctx, server = gloo_tpu_torch.init_from_env(timeout=60.0)
    x = torch.full((4096,), float(ctx.rank + 1))
    ctx.allreduce(x)
    size = ctx.size
    assert bool((x == size * (size + 1) / 2).all()), x[:4]
    assert (server is not None) == (ctx.rank == 0)
    ctx.barrier()
    ctx.close()
    del server
    print("OK", ctx.rank, size, flush=True)
""").format(repo=_REPO)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("style", ["torchrun", "openmpi", "slurm"])
def test_init_from_env_over_two_processes(style):
    size = 2
    port = str(_free_port())

    def env_for(rank):
        if style == "torchrun":
            return {"RANK": str(rank), "WORLD_SIZE": str(size),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
        if style == "openmpi":
            return {"OMPI_COMM_WORLD_RANK": str(rank),
                    "OMPI_COMM_WORLD_SIZE": str(size),
                    "OMPI_COMM_WORLD_LOCAL_SIZE": str(size),
                    "MASTER_PORT": port}
        return {"SLURM_PROCID": str(rank), "SLURM_NTASKS": str(size),
                "SLURM_NNODES": "1", "MASTER_PORT": port}

    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER],
                              env=dict(base, **env_for(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(size)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {rank} {size}" in out, (out, err)


_PREFIX_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    import gloo_tpu_torch
    from gloo_tpu_torch import core

    device = gloo_tpu_torch.Device()
    ctx, server = gloo_tpu_torch.init_from_env(device=device,
                                               prefix="job-a", timeout=60.0)
    # A second context through the same store server, under another
    # prefix, over the same device.
    store = core.TcpStore("127.0.0.1", int(os.environ["MASTER_PORT"]))
    second = core.Context(ctx.rank, ctx.size, timeout=60.0)
    second.connect_full_mesh(core.PrefixStore(store, "job-b"), device)
    a = ctx.allreduce(torch.full((64,), float(ctx.rank + 1)))
    b = second.allgather(torch.tensor([ctx.rank * 10]))
    assert float(a[0]) == 3.0 and b.view(-1).tolist() == [0, 10]
    assert ctx._device is device and second._device is device
    keys = store.list()
    assert any(k.startswith("job-a") for k in keys), keys
    assert any(k.startswith("job-b") for k in keys), keys
    assert not any(k.startswith("tc-env") for k in keys), keys
    second.barrier()
    ctx.barrier()
    second.close()
    ctx.close()
    del server
    print("OK", ctx.rank, flush=True)
""").format(repo=_REPO)


def test_init_from_env_prefix_and_device():
    """init_from_env(device=, prefix=): the context rendezvouses under the
    given prefix over the caller's Device, so a second context can meet
    on the same store server under another prefix."""
    port = str(_free_port())
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PREFIX_WORKER],
        env=dict(base, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {rank}" in out, (out, err)
