"""gloo_tpu_torch.ops.rope against gloo_tpu.ops.rope on the same inputs.

Tolerances: f32 angles and rotations agree to a few f32 ulps (the two
frameworks' pow/cos/sin differ in the last bits), so rtol 1e-5, atol 1e-5
at positions up to a few hundred; bf16 outputs may differ by one bf16 ulp
where such a last-bit difference crosses a rounding (rtol 1e-2).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gloo_tpu.ops import rope as jrope  # noqa: E402
from gloo_tpu_torch.ops import rope  # noqa: E402


@pytest.mark.parametrize("head_dim", [8, 64, 128])
def test_rope_angles_match(head_dim):
    pos = np.arange(300, dtype=np.int32)
    ours = rope.rope_angles(torch.from_numpy(pos), head_dim).numpy()
    ref = np.asarray(jrope.rope_angles(jnp.asarray(pos), head_dim))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (np.float32, 1e-5, 1e-5),
    ("bfloat16", 1e-2, 1e-2),
])
@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope_matches(dtype, rtol, atol, offset):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 24, 16).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(x, jdtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdtype)
    ref = jrope.apply_rope(jx, jrope.rope_positions(24, offset))
    ours = rope.apply_rope(tx, rope.rope_positions(24, offset))
    assert ours.dtype == tdtype
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


def test_rope_positions_and_batched_positions():
    np.testing.assert_array_equal(
        rope.rope_positions(5, 3).numpy(),
        np.asarray(jrope.rope_positions(5, 3)))
    assert rope.rope_positions(5).dtype == torch.int32
    # Per-batch positions broadcast over heads: (b, 1, t) against
    # (b, h, t, d), as under sequence parallelism.
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 8, 16).astype(np.float32)
    pos = np.stack([np.arange(8), np.arange(8) + 100])[:, None, :]
    ours = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_rope_rejects_odd_head_dim():
    with pytest.raises(ValueError, match="even"):
        rope.rope_angles(torch.arange(4), 7)
