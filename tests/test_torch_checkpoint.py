"""gloo_tpu_torch.checkpoint.StepCheckpointer against gloo_tpu.checkpoint.

The reference stores through orbax and the port through torch.save, so
the two are held to the same contract on the same numpy-seeded state:
the same committed steps after the same saves and the same `keep`, and
equal values loaded back. The port's own cases: an uncommitted
``step_<n>.tmp-*`` directory is skipped, a step that vanishes between the
listing and the load is skipped for the next newest, force=True replaces
a committed step, and a template sets the loaded tensors' device and
dtype (an Adam state_dict round trip included).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from gloo_tpu_torch import checkpoint
from gloo_tpu_torch.checkpoint import StepCheckpointer


def _state(step):
    """The reference test's state at `step`, from a seed: numpy for the
    reference, torch for the port."""
    w = np.random.RandomState(step).randn(8).astype(np.float32) * step
    return ({"w": w, "step": np.int64(step)},
            {"w": torch.from_numpy(w.copy()), "step": step})


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_roundtrip_and_gc_matches_the_reference(tmp_path, keep):
    pytest.importorskip("orbax.checkpoint")
    from gloo_tpu.checkpoint import StepCheckpointer as Reference

    ref = Reference(str(tmp_path / "ref"), keep=keep)
    ours = StepCheckpointer(str(tmp_path / "ours"), keep=keep)
    assert ref.load_latest() == ours.load_latest() == (None, None)
    for step in (1, 5, 9, 12):
        ref_state, our_state = _state(step)
        ref.save(step, ref_state)
        ours.save(step, our_state)
        assert ours.steps() == ref.steps()
    assert ours.steps() == [1, 5, 9, 12][-keep:]
    ref_step, ref_state = ref.load_latest()
    our_step, our_state = ours.load_latest()
    assert our_step == ref_step == 12
    np.testing.assert_array_equal(our_state["w"].numpy(), ref_state["w"])
    assert our_state["step"] == int(ref_state["step"]) == 12
    for step in ours.steps():
        np.testing.assert_array_equal(ours.load(step)["w"].numpy(),
                                      ref.load(step)["w"])


def test_uncommitted_steps_are_skipped(tmp_path):
    ckpt = StepCheckpointer(str(tmp_path))
    ckpt.save(2, {"w": torch.ones(3)})
    # A writer that died mid-save leaves its temporary directory, and a
    # step directory without the state file is not committed either.
    os.makedirs(tmp_path / "step_7.tmp-4242")
    (tmp_path / "step_7.tmp-4242" / checkpoint.STATE_FILE).write_bytes(
        b"partial")
    os.makedirs(tmp_path / "step_9")
    assert ckpt.steps() == [2]
    step, state = ckpt.load_latest()
    assert step == 2 and torch.equal(state["w"], torch.ones(3))


def test_a_step_that_vanishes_before_its_load_is_skipped(tmp_path,
                                                          monkeypatch):
    """The writer's garbage collection may delete a step between a
    reader's listing and its load: load_latest takes the next newest."""
    ckpt = StepCheckpointer(str(tmp_path), keep=0)
    for step in (1, 2, 3):
        ckpt.save(step, {"step": step})
    listed = ckpt.steps()
    assert listed == [1, 2, 3]
    monkeypatch.setattr(ckpt, "steps", lambda: listed)
    shutil.rmtree(tmp_path / "step_3")
    assert ckpt.load_latest() == (2, {"step": 2})


def test_force_replaces_a_committed_step(tmp_path):
    ckpt = StepCheckpointer(str(tmp_path))
    ckpt.save(4, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save(4, {"w": torch.ones(2)})
    assert torch.equal(ckpt.load(4)["w"], torch.zeros(2))
    ckpt.save(4, {"w": torch.ones(2)}, force=True)
    assert torch.equal(ckpt.load(4)["w"], torch.ones(2))
    assert sorted(os.listdir(tmp_path)) == ["step_4"]


def test_template_sets_device_and_dtype(tmp_path):
    ckpt = StepCheckpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.arange(4.0), "pair": (torch.ones(2), 3),
                  "rows": [torch.zeros(1, dtype=torch.int64)]})
    template = {"w": torch.empty(4, dtype=torch.float64, device="meta"),
                "pair": (torch.empty(2, dtype=torch.bfloat16), 0),
                "rows": [torch.empty(1, dtype=torch.int32)]}
    step, state = ckpt.load_latest(template)
    assert step == 1
    assert state["w"].device.type == "meta"
    assert state["w"].dtype == torch.float64
    assert state["pair"][0].dtype == torch.bfloat16
    assert state["pair"][1] == 3 and isinstance(state["pair"], tuple)
    assert state["rows"][0].dtype == torch.int32
    with pytest.raises(ValueError, match="keys"):
        ckpt.load(1, {"w": torch.empty(4)})


def test_model_and_adam_state_resume_bitwise(tmp_path):
    """A model's and its Adam's state_dicts saved at step 2 and loaded
    with the live state as the template: the resumed run takes the same
    steps, bit for bit, as one that never stopped."""
    def make():
        torch.manual_seed(0)
        model = torch.nn.Linear(6, 3)
        return model, torch.optim.Adam(model.parameters(), lr=1e-2)

    def step(model, opt, i):
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(5, 6, generator=g)
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()

    model, opt = make()
    ckpt = StepCheckpointer(str(tmp_path), keep=2)
    for i in range(5):
        step(model, opt, i)
        if i == 2:
            ckpt.save(i, {"model": model.state_dict(),
                          "adam": opt.state_dict(), "step": i})
    resumed, ropt = make()
    # Adam's state is made at its first step, so a fresh optimizer's
    # state_dict has none to match: None keeps that subtree as loaded.
    at, state = ckpt.load_latest({"model": resumed.state_dict(),
                                  "adam": None, "step": 0})
    assert at == 2 and state["step"] == 2
    resumed.load_state_dict(state["model"])
    ropt.load_state_dict(state["adam"])
    for i in range(3, 5):
        step(resumed, ropt, i)
    for a, b in zip(model.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def test_state_digest_reads_structure_dtypes_and_bytes():
    digest = checkpoint.state_digest
    state = {"w": torch.arange(4.0), "step": 3, "pair": (torch.ones(2),)}
    same = {"step": 3, "pair": (torch.ones(2),), "w": torch.arange(4.0)}
    assert digest(state) == digest(same)  # dict order does not count
    loaded = torch.load(_saved(state), weights_only=True)
    assert digest(state) == digest(loaded)
    for other in ({**state, "step": 4}, {**state, "w": torch.arange(4.0)
                                         .double()},
                  {**state, "w": torch.arange(4.0).view(2, 2)},
                  {**state, "pair": [torch.ones(2)]},
                  {**state, "w": torch.arange(4.0) + 1e-7}):
        assert digest(other) != digest(state)


def _saved(state):
    import io

    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return buf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the template's tensors lie on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_state_comes_back_on_the_card(tmp_path, cuda_device):
    model = torch.nn.Linear(4, 2).to(cuda_device)
    opt = torch.optim.Adam(model.parameters())
    model(torch.ones(3, 4, device=cuda_device)).sum().backward()
    opt.step()
    state = {"model": model.state_dict(), "adam": opt.state_dict()}
    ckpt = StepCheckpointer(str(tmp_path))
    ckpt.save(0, state)
    at, loaded = ckpt.load_latest(state)
    assert at == 0
    for name, t in loaded["model"].items():
        assert t.is_cuda and torch.equal(t, state["model"][name])
    moments = loaded["adam"]["state"][0]
    assert moments["exp_avg"].is_cuda
    assert checkpoint.state_digest(loaded) == checkpoint.state_digest(state)
