"""gloo_tpu_torch's transport security, interface and engine arguments
against gloo_tpu's: Device(auth_key=, keyring=, encrypt=, iface=,
busy_poll=, engine=), derive_keyring, crypto_isa_tier, uring_available
and Device.engine_stats.

Both packages run their ranks as threads of this process, each over its
own build of the native core; the port's ranks connect only to the
port's. A refused handshake must fail on the port as it fails on the
reference: the same ranks fail, with the same error classes.
Uring's cases follow what the reference does on the machine at hand.
"""

import threading

import numpy as np
import pytest
import torch

import gloo_tpu
import gloo_tpu_torch
from gloo_tpu_torch import _lib, core
from tests.test_torch_host import raw, spawn

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

ROOT = "launcher-root-secret"
ENC = {"auth_key": "wire-secret", "encrypt": True}


def _group(pkg, size, device_fn, timeout):
    """Connect `size` thread ranks of `pkg` (gloo_tpu or gloo_tpu_torch)
    over Devices from device_fn(rank), then allreduce rank + 1 on each.
    Returns (results, error class names): the allreduced value, or None
    and the class of what the rank raised."""
    store = pkg.HashStore()
    results = [None] * size
    errors = [None] * size

    def worker(rank):
        try:
            ctx = pkg.Context(rank, size, timeout=timeout)
            ctx.connect_full_mesh(store, device_fn(rank))
            if pkg is gloo_tpu:
                x = np.full(100, float(rank + 1), dtype=np.float32)
            else:
                x = torch.full((100,), float(rank + 1))
            ctx.allreduce(x)
            results[rank] = float(x[0])
            ctx.close()
        except BaseException as exc:  # noqa: BLE001 - compared below
            errors[rank] = type(exc).__name__

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return results, errors


def _both(size, device_fn, timeout=2.0):
    """_group on each package at once (the reference's, the port's);
    device_fn(pkg, rank) makes the Device."""
    out = [None, None]

    def run(i, pkg):
        out[i] = _group(pkg, size, lambda r: device_fn(pkg, r), timeout)

    threads = [threading.Thread(target=run, args=(i, pkg), daemon=True)
               for i, pkg in enumerate((gloo_tpu, gloo_tpu_torch))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out


# Runs of a refused handshake (_both) before the error classes of the two
# packages are compared on the last. Both packages build the native core
# from the same csrc/ and map its codes the same way. That core often
# closes a refused connection only as the listener's own connect deadline
# fires (about half the diallers of either package get the close within
# 50 ms of the 2.0 s deadline); the dialler raises IoError if the close
# reaches it before its own deadline, TimeoutError if not. The two
# deadlines start within ~1 ms of each other, so which fires first depends
# on how the two rank threads were scheduled, on the reference as on the
# port. A class the port gets wrong differs on every run.
REFUSAL_RUNS = 3


def _both_refused(size, device_fn):
    """_both until the two packages' error classes agree, at most
    REFUSAL_RUNS times; the last run's results."""
    for _ in range(REFUSAL_RUNS):
        ref, port = _both(size, device_fn)
        if port[1] == ref[1]:
            break
    return ref, port


@pytest.mark.parametrize("root,rank,size", [
    (ROOT, 0, 2), (ROOT, 1, 3), (ROOT, 3, 4), ("another root", 2, 8),
    ("r", 1, 2)])
def test_derive_keyring_is_the_references(root, rank, size):
    assert gloo_tpu_torch.derive_keyring(root, rank, size) == \
        gloo_tpu.derive_keyring(root, rank, size)


@pytest.mark.parametrize("root,rank,size", [(ROOT, 3, 3), ("", 0, 1)],
                         ids=["rank_past_size", "no_root"])
def test_derive_keyring_refuses_as_the_reference(root, rank, size):
    with pytest.raises(gloo_tpu.Error) as ref:
        gloo_tpu.derive_keyring(root, rank, size)
    with pytest.raises(gloo_tpu_torch.Error) as port:
        gloo_tpu_torch.derive_keyring(root, rank, size)
    assert str(port.value) == str(ref.value)


def test_isa_tier_and_uring_are_the_references():
    assert gloo_tpu_torch.crypto_isa_tier() == gloo_tpu.crypto_isa_tier()
    assert gloo_tpu_torch.uring_available() == gloo_tpu.uring_available()


@pytest.mark.parametrize("kwargs", [
    {"encrypt": True}, {"auth_key": "k", "keyring": "r"},
    {"keyring": "r", "auth_key": "k", "encrypt": True}],
    ids=["encrypt_without_key", "both_tiers", "both_tiers_encrypted"])
def test_device_refusals_are_the_references(kwargs):
    with pytest.raises(ValueError) as ref:
        gloo_tpu.Device(**kwargs)
    with pytest.raises(ValueError) as port:
        core.Device(**kwargs)
    assert str(port.value) == str(ref.value)


def test_bad_engine_raises_as_the_reference():
    with pytest.raises(gloo_tpu.Error) as ref:
        gloo_tpu.Device(engine="kqueue")
    with pytest.raises(gloo_tpu_torch.Error) as port:
        core.Device(engine="kqueue")
    assert str(port.value) == str(ref.value)


def _keyring(pkg, rank, size, encrypt=False):
    return pkg.Device(keyring=pkg.derive_keyring(ROOT, rank, size),
                      encrypt=encrypt)


@pytest.mark.parametrize("case", [
    "auth_key", "auth_key_encrypted", "keyring", "keyring_encrypted",
    "iface_lo", "busy_poll", "epoll"])
def test_handshakes_connect(case):
    """Three ranks connect and allreduce under each tier and option, on
    the port as on the reference."""
    makers = {
        "auth_key": lambda pkg, r: pkg.Device(auth_key="sesame-open"),
        "auth_key_encrypted": lambda pkg, r: pkg.Device(**ENC),
        "keyring": lambda pkg, r: _keyring(pkg, r, 3),
        "keyring_encrypted": lambda pkg, r: _keyring(pkg, r, 3, True),
        "iface_lo": lambda pkg, r: pkg.Device(iface="lo"),
        "busy_poll": lambda pkg, r: pkg.Device(busy_poll=True),
        "epoll": lambda pkg, r: pkg.Device(engine="epoll"),
    }
    ref, port = _both(3, makers[case], timeout=10.0)
    assert ref == ([6.0, 6.0, 6.0], [None, None, None])
    assert port == ref


@pytest.mark.parametrize("case", [
    "wrong_key", "plain_client", "keyring_wrong_rank", "keyring_vs_psk",
    "keyring_roots", "tier_mismatch"])
def test_refused_handshakes_fail_as_the_reference(case):
    """A wrong key, a plaintext client, a keyring of another rank, two
    tiers or two roots, an encrypted against a plaintext peer: no rank
    gets a result, and each rank fails with the reference's class (the
    listener by its connect deadline, the dialler on the refusal, which
    races its own deadline in both packages: _both_refused)."""
    ring1 = gloo_tpu.derive_keyring(ROOT, 1, 3)
    makers = {
        "wrong_key": lambda pkg, r: pkg.Device(
            auth_key="right-key" if r == 0 else "wrong-key"),
        "plain_client": lambda pkg, r: pkg.Device(
            auth_key="secret" if r == 0 else None),
        "keyring_wrong_rank": lambda pkg, r: pkg.Device(
            keyring=ring1 if r == 2 else pkg.derive_keyring(ROOT, r, 3)),
        "keyring_vs_psk": lambda pkg, r: (
            _keyring(pkg, 0, 2) if r == 0 else pkg.Device(auth_key=ROOT)),
        "keyring_roots": lambda pkg, r: pkg.Device(
            keyring=pkg.derive_keyring(
                ROOT if r == 0 else "some-other-root", r, 2)),
        "tier_mismatch": lambda pkg, r: pkg.Device(
            auth_key="wire-secret", encrypt=(r == 0)),
    }
    size = 3 if case == "keyring_wrong_rank" else 2
    ref, port = _both_refused(size, makers[case])
    assert ref[0] == [None] * size
    assert port[0] == [None] * size
    assert port[1] == ref[1]


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_encrypted_allreduce_has_the_plaintext_bits(size, dtype):
    """An allreduce over encrypted pairs gives the bits of the same
    allreduce in plaintext, on every rank, and those of the reference's
    encrypted allreduce."""
    def inputs(rank):
        gen = torch.Generator().manual_seed(31 + rank)
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, (4097,), generator=gen,
                                 dtype=dtype)
        return torch.randn(4097, generator=gen).to(dtype)

    def fn(ctx, rank):
        x = inputs(rank)
        ctx.allreduce(x)
        return raw(x)

    plain = spawn(size, fn)
    encrypted = spawn(size, fn, device_kwargs=ENC)
    assert encrypted == plain
    if dtype != torch.bfloat16:
        from tests.harness import spawn as ref_spawn

        def ref_fn(ctx, rank):
            x = inputs(rank).numpy()
            ctx.allreduce(x)
            return raw(x)

        assert ref_spawn(size, ref_fn, device_kwargs=ENC) == encrypted


def test_encrypted_send_recv():
    def fn(ctx, rank):
        if rank == 0:
            ctx.send(torch.arange(100000, dtype=torch.float64), dst=1,
                     slot=9)
            return None
        got = torch.zeros(100000, dtype=torch.float64)
        ctx.recv(got, src=0, slot=9)
        return got

    got = spawn(2, fn, device_kwargs=ENC)[1]
    assert torch.equal(got, torch.arange(100000, dtype=torch.float64))


def test_engine_stats_follow_the_reference():
    """engine_stats() has the reference's keys; on the epoll engine every
    counter is 0 on both."""
    assert core.Device(engine="epoll").engine_stats() == \
        gloo_tpu.Device(engine="epoll").engine_stats() == \
        {"enters": 0, "sqes": 0, "cqes": 0}
    assert set(core.Device().engine_stats()) == {"enters", "sqes", "cqes"}


def test_uring_engine_behaves_as_the_reference():
    """engine="uring" connects where the reference's does, and where the
    reference refuses it the port refuses it with the same words."""
    if gloo_tpu.uring_available():
        ref, port = _both(2, lambda pkg, r: pkg.Device(engine="uring"),
                          timeout=10.0)
        assert port == ref == ([3.0, 3.0], [None, None])
        return
    with pytest.raises(gloo_tpu.Error) as ref:
        gloo_tpu.Device(engine="uring")
    with pytest.raises(gloo_tpu_torch.Error) as port:
        core.Device(engine="uring")
    assert str(port.value) == str(ref.value)
