"""The ring-attention step twins (B6, and B7a + B7b) against gloo_tpu's
flash_attention_step / flash_attention_bwd_step, and the ring backward's
accumulating step (flash_attention_bwd_step_into) over a whole ring.

On the CPU the port runs flash_attention_step_plain and the two backward
step twins; they are held against the JAX step kernels in Pallas interpret
mode, with JAX's block sizes set to the twins' tiles over the same keys
and queries (the whole block below 64 rows, else 64), so that the online
softmax rescales at the same places. Inputs are made with numpy from a
seed; bf16 values are rounded once by JAX and carried over exactly.

Cases: f32 and bf16; MHA and GQA (kv_group 2); causal and full; offsets
that make the block wholly visible, straddle the diagonal, or hide it
wholly; a state that starts at (0, -inf, 0) and one left by a previous
step; dO in f32, as the ring backward passes it (with bf16 q/k/v).

Tolerances, as (rtol, atol): f32 (1e-5, 1e-5): the same arithmetic, with
the dot products summed in another order (under 7e-7 of the largest value
seen). bf16 (1.6e-2, 8e-3 x the largest |JAX value| of the tensor): p
(forward) and ds (backward) are rounded to bf16 inside the sums, so an f32
score that differs in its last bit can flip one bf16 ulp (2**-8 relative)
of one term (2.2e-3 of the largest dk seen); m and l stay f32 and keep
(1e-5, 1e-5) relative to their largest value.

The in-place step's twin (flash_attention_step_into_plain) writes the
step twin's new state into the caller's buffers for the 64-row query tiles
that see a key of the block and leaves the others untouched, as the
kernel's blocks do: bitwise the out-of-place twin on every state a step
can carry, and held to TOL against JAX.

The accumulating step's twin adds the unscaled dQ piece and the
group-summed dK/dV partials into f32 buffers; over a ring of 3 ranks its
sums are held to the same TOL against the JAX step's pieces summed per
rank and per block. A bf16 cotangent and its f32 cast give bitwise the
same twin outputs.

Tests marked `cuda` hold the kernels against the twins on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gloo_tpu.ops import attention as jattn  # noqa: E402
from gloo_tpu_torch.ops import attention as attn  # noqa: E402
from gloo_tpu_torch.parallel import sp  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh, spmd  # noqa: E402

# (q_offset, k_offset) at t_q = t_kv = T: block wholly visible, straddling
# the diagonal, wholly above it.
T, D = 32, 32
OFFSETS = {"full": (T, 0), "diagonal": (T, T), "masked": (0, T)}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 8e-3)}


def _to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
        {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
            jnp.dtype(x.dtype).type])


def _inputs(bh, group, tq, tkv, dtype, seed):
    rng = np.random.RandomState(seed)
    jd = jnp.dtype(dtype)
    q = jnp.asarray(rng.randn(bh, tq, D).astype(np.float32), jd)
    k = jnp.asarray(rng.randn(bh // group, tkv, D).astype(np.float32), jd)
    v = jnp.asarray(rng.randn(bh // group, tkv, D).astype(np.float32), jd)
    return (q, k, v), tuple(_to_torch(x) for x in (q, k, v))


def _blocks(tq, tkv):
    return dict(block_q=min(tq, attn.BLOCK_Q), block_k=min(tkv, attn.BLOCK_K))


def _jax_step(q, k, v, state, qo, ko, causal, group, blocks=None):
    return jattn.flash_attention_step(
        q, k, v, *state, jnp.int32(qo), jnp.int32(ko), causal=causal,
        interpret=True, kv_group=group,
        **(blocks or _blocks(q.shape[1], k.shape[1])))


def _fresh(bh, tq):
    return (jnp.zeros((bh, tq, D), jnp.float32),
            jnp.full((bh, tq, 1), -jnp.inf, jnp.float32),
            jnp.zeros((bh, tq, 1), jnp.float32))


def _close(ours, ref, dtype, state=False):
    """ours within TOL[dtype] of ref (atol x the largest finite |ref| in
    bf16), or within the f32 TOL x that peak for the f32 state m and l;
    -inf where ref is -inf."""
    ref = np.asarray(ref, np.float32)
    rtol, atol = TOL["float32" if state else dtype]
    finite = np.isfinite(ref)
    peak = float(np.abs(ref[finite]).max()) if finite.any() else 1.0
    if state or dtype == "bfloat16":
        atol *= max(peak, 1.0)
    got = ours.float().numpy()
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=rtol,
                               atol=atol)


def _state(qj, group, causal, carried):
    """(0, -inf, 0), or the state that one JAX step over another block of
    keys at positions 0 .. T - 1, wholly visible to the queries (offset
    2T), leaves."""
    bh, tq = qj.shape[:2]
    state = _fresh(bh, tq)
    if carried:
        _, kj, vj = _inputs(bh, group, tq, T, str(qj.dtype), 99)[0]
        state = _jax_step(qj, kj, vj, state, 2 * T, 0, causal, group)
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("where", list(OFFSETS))
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_step_matches_jax(dtype, group, causal, where, carried):
    bh = 4
    (qj, kj, vj), (q, k, v) = _inputs(bh, group, T, T, dtype, 1)
    # A carried state moves the step two blocks later in the sequence.
    qo, ko = (o + (2 * T if carried else 0) for o in OFFSETS[where])
    state = _state(qj, group, causal, carried)
    ref = _jax_step(qj, kj, vj, state, qo, ko, causal, group)
    ours = attn.flash_attention_step(
        q, k, v, *(_to_torch(x) for x in state), qo, ko, causal=causal,
        kv_group=group)
    for name, a, r in zip(("acc", "m", "l"), ours, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
        _close(a, r, dtype, state=name != "acc")
    if causal and where == "masked":
        # A block wholly above the diagonal leaves the state as it was.
        for a, s in zip(ours, state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_two_key_tiles_matches_jax(dtype):
    """t_kv = 128: two of the twin's 64-key tiles, with the online softmax
    rescaling between them (JAX at block_k 64), t_q 96 ragged to the
    64-row query tile (query rows are independent in the forward, so JAX's
    block_q 32 changes nothing)."""
    bh, group = 4, 2
    (qj, kj, vj), (q, k, v) = _inputs(bh, group, 96, 128, dtype, 3)
    ref = _jax_step(qj, kj, vj, _fresh(bh, 96), 100, 40, True, group,
                    dict(block_q=32, block_k=64))
    ours = attn.flash_attention_step(
        q, k, v, *(_to_torch(x) for x in _fresh(bh, 96)), 100, 40,
        kv_group=group)
    for name, a, r in zip(("acc", "m", "l"), ours, ref):
        _close(a, r, dtype, state=name != "acc")


def test_step_per_row_offsets_are_per_rank_calls():
    """Per-row int32 offsets (two ranks of 4 rows, each its own q and k
    offset) equal one JAX call per rank with scalar offsets."""
    (qj, kj, vj), (q, k, v) = _inputs(8, 2, T, T, "bfloat16", 5)
    qo = torch.tensor([T] * 4 + [0] * 4, dtype=torch.int32)
    ko = torch.tensor([0] * 4 + [0] * 4, dtype=torch.int32)
    fresh = _fresh(8, T)
    ours = attn.flash_attention_step(q, k, v, *(_to_torch(x) for x in fresh),
                                     qo, ko, kv_group=2)
    for r, (rows, kvr) in enumerate(((slice(0, 4), slice(0, 2)),
                                     (slice(4, 8), slice(2, 4)))):
        ref = _jax_step(qj[rows], kj[kvr], vj[kvr],
                        tuple(x[rows] for x in fresh), int(qo[4 * r]),
                        int(ko[4 * r]), True, 2)
        for name, a, b in zip(("acc", "m", "l"), ours, ref):
            _close(a[rows], b, "bfloat16", state=name != "acc")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_step_into_is_the_step_in_place(dtype, group, causal, carried):
    """flash_attention_step_into (on the CPU its twin) leaves in the
    caller's buffers bitwise what flash_attention_step_plain returns, and
    that state is JAX's within TOL, at every placement of the block."""
    bh = 4
    (qj, kj, vj), (q, k, v) = _inputs(bh, group, T, T, dtype, 11)
    state = _state(qj, group, causal, carried)
    for where, (qo, ko) in OFFSETS.items():
        if carried:
            qo, ko = qo + 2 * T, ko + 2 * T
        bufs = [_to_torch(x).clone() for x in state]
        plain = attn.flash_attention_step_plain(q, k, v, *bufs, qo, ko,
                                                causal, group)
        ptrs = [b.data_ptr() for b in bufs]
        assert attn.flash_attention_step_into(
            q, k, v, *bufs, qo, ko, causal=causal, kv_group=group) is None
        assert [b.data_ptr() for b in bufs] == ptrs
        ref = _jax_step(qj, kj, vj, state, qo, ko, causal, group)
        for name, a, p, r in zip(("acc", "m", "l"), bufs, plain, ref):
            assert torch.equal(a, p), (where, name)
            _close(a, r, dtype, state=name != "acc")


def test_hidden_tiles_keep_their_state():
    """Rows that see no key of the block keep their state bitwise in the
    step twin, and the in-place form leaves the query tiles that see none
    untouched: with t_q 96 (tiles of rows 0-63 and 64-95) and keys from
    global position 80, row 0's first tile is hidden and its second sees
    keys from row 80 on; row 1 (keys after all its queries) is hidden
    whole, row 2 (keys before them) sees every key. A sentinel state in
    the hidden tiles (l 7 where m is -inf), which a step would rewrite,
    stays as it was."""
    bh, tq = 3, 96
    (_, _, _), (q, k, v) = _inputs(bh, 1, tq, T, "bfloat16", 12)
    qo = torch.tensor([0, 0, 200], dtype=torch.int32)
    ko = torch.tensor([80, 100, 0], dtype=torch.int32)
    rng = np.random.RandomState(13)
    acc = torch.from_numpy(rng.randn(bh, tq, D).astype(np.float32))
    m = torch.from_numpy(rng.randn(bh, tq, 1).astype(np.float32))
    l = torch.from_numpy(rng.rand(bh, tq, 1).astype(np.float32)) + 1.0
    new = attn.flash_attention_step_plain(q, k, v, acc, m, l, qo, ko)
    hidden = torch.zeros((bh, tq), dtype=torch.bool)
    hidden[0, :80] = hidden[1] = True
    for a, b in zip(new, (acc, m, l)):
        assert torch.equal(a[hidden], b[hidden])
        assert not torch.equal(a[~hidden], b[~hidden])
    seen = attn.visible_tiles(qo, ko, tq, True)[..., 0]
    assert seen[0].tolist() == [False] * 64 + [True] * 32
    assert not seen[1].any() and seen[2].all()
    bufs = [acc.clone(), m.clone(), l.clone()]
    sentinel = ~seen
    bufs[1][sentinel] = -float("inf")
    bufs[2][sentinel] = 7.0
    keep = [b.clone() for b in bufs]
    attn.flash_attention_step_into(q, k, v, *bufs, qo, ko)
    for a, b, x in zip(bufs, keep, new):
        assert torch.equal(a[sentinel], b[sentinel])
        assert torch.equal(a[seen], x[seen])


@pytest.mark.parametrize("d", [32, 96])
def test_chained_step_into_updates_the_d_wide_state(d):
    """Three in-place steps at a head_dim the kernels zero-pad (d 32 on
    the 64 instance, d 96 on the 128) update the caller's d-wide state:
    bitwise three chained out-of-place steps."""
    bh, t = 4, 64
    rng = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rng.randn(bh, t, d).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    state = (torch.zeros((bh, t, d)), torch.full((bh, t, 1), -np.inf),
             torch.zeros((bh, t, 1)))
    bufs = [x.clone() for x in state]
    for i, (qo, ko) in enumerate(((2 * t, 0), (2 * t, t), (2 * t, 2 * t))):
        state = attn.flash_attention_step(q, k, v, *state, qo, ko)
        attn.flash_attention_step_into(q, k, v, *bufs, qo, ko)
        for a, b in zip(bufs, state):
            assert a.shape == b.shape and torch.equal(a, b), i


def _bwd_inputs(bh, group, dtype, causal, qo, seed):
    """q, k, v, an f32 cotangent, and the lse and delta of a completed
    forward over the block at offsets (qo, 0), in the layouts the ring
    backward hands over."""
    (qj, kj, vj), (q, k, v) = _inputs(bh, group, T, T, dtype, seed)
    rng = np.random.RandomState(seed + 1)
    do = jnp.asarray(rng.randn(bh, T, D).astype(np.float32))
    acc, m, l = _jax_step(qj, kj, vj, _fresh(bh, T), qo, 0, causal, group)
    l_safe = jnp.maximum(l, 1e-30)
    out = acc / l_safe
    lse = m + jnp.log(l_safe)
    delta = jnp.sum(do * out, axis=-1, keepdims=True)
    return (qj, kj, vj, do, delta, lse), (q, k, v, *(_to_torch(x) for x in
                                                   (do, delta, lse)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("where", list(OFFSETS))
def test_bwd_step_matches_jax(dtype, group, causal, where):
    """dq_partial, and dk / dv group-summed, against the interpreted JAX
    kernels + group_sum_kv; the twin's own dk / dv are per query head."""
    bh = 4
    qo, ko = OFFSETS[where]
    jargs, targs = _bwd_inputs(bh, group, dtype, causal, T, 11)
    dq_r, dk_r, dv_r = jattn.flash_attention_bwd_step(
        *jargs, jnp.int32(qo), jnp.int32(ko), causal=causal, interpret=True,
        kv_group=group, **_blocks(T, T))
    dq, dk, dv = attn.flash_attention_bwd_step(*targs, qo, ko, causal=causal,
                                               kv_group=group)
    assert dk.shape == dv.shape == (bh, T, D) and dq.dtype == torch.float32
    _close(dq, dq_r, dtype)
    for ours, ref in ((dk, dk_r), (dv, dv_r)):
        _close(attn.group_sum_kv(ours, group),
               jattn.group_sum_kv(ref, group), dtype)
    if causal and where == "masked":
        for x in (dq, dk, dv):
            assert not bool(x.any())


def test_bwd_step_ragged_tiles_match_jax():
    """t_q = 96 (a 64-row query tile and a ragged one) against JAX at
    block_q 32, t_kv = 96 at block_k 32: the f32 sums over the query and
    key tiles fall at other places, within the f32 tolerance."""
    bh, group = 4, 2
    (qj, kj, vj), (q, k, v) = _inputs(bh, group, 96, 96, "float32", 21)
    do = np.random.RandomState(22).randn(bh, 96, D).astype(np.float32)
    lse = np.random.RandomState(23).rand(bh, 96, 1).astype(np.float32) + 3.0
    delta = np.random.RandomState(24).randn(bh, 96, 1).astype(np.float32)
    ref = jattn.flash_attention_bwd_step(
        qj, kj, vj, jnp.asarray(do), jnp.asarray(delta), jnp.asarray(lse),
        jnp.int32(96), jnp.int32(50), causal=True, interpret=True,
        kv_group=group, block_q=32, block_k=32)
    ours = attn.flash_attention_bwd_step(
        q, k, v, *(torch.from_numpy(x) for x in (do, delta, lse)), 96, 50,
        kv_group=group)
    for a, r in zip(ours, ref):
        _close(a, r, "float32")


def _ring_inputs(n, bh, group, t, dtype, causal, seed):
    """A world of n ranks, each with bh query rows of t positions (rank r
    at r t .. (r + 1) t - 1) and bh / group kv rows, as numpy-seeded JAX
    arrays and their torch copies: q, k, v (n, rows, t, D), an f32
    cotangent, and the lse and delta of the attention over the whole
    sequence (materialized in f32 from the same values)."""
    rng = np.random.RandomState(seed)
    jd = jnp.dtype(dtype)
    js = [jnp.asarray(rng.randn(n, rows, t, D).astype(np.float32), jd)
          for rows in (bh, bh // group, bh // group)]
    do = jnp.asarray(rng.randn(n, bh, t, D).astype(np.float32))
    q, k, v = (_to_torch(x) for x in js)
    glob = [x.transpose(0, 1).reshape(x.shape[1], n * t, D) for x in (q, k, v)]
    rows = torch.arange(bh) // group
    qs = (glob[0] * torch.tensor(attn._folded_scale(D, q.dtype),
                                 dtype=q.dtype)).float()
    s = qs @ glob[1][rows].float().transpose(-1, -2)
    if causal:
        pos = torch.arange(n * t)
        s = s.masked_fill(pos[None, :] > pos[:, None], -float("inf"))
    lse = torch.logsumexp(s, -1, keepdim=True)
    out = torch.softmax(s, -1) @ glob[2][rows].float()
    local = [x.view(bh, n, t, -1).transpose(0, 1) for x in (out, lse)]
    dot = torch.from_numpy(np.array(do))
    delta = (dot * local[0]).sum(-1, keepdim=True)
    return js, (q, k, v), dot, local[1].contiguous(), delta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [T, 96], ids=["t32", "t96"])
def test_accumulating_twin_over_a_ring_matches_jax(dtype, group, causal, t):
    """The ring backward's accumulating step: n = 3 steps of
    flash_attention_bwd_step_into over the whole world at once (per-row
    offsets, each rank's block src = r - i), adding into a dQ buffer and
    into one dK/dV carrier per kv block, then flash_bwd_step_finish,
    against the n x n calls of gloo_tpu's flash_attention_bwd_step
    (interpret mode) whose dQ pieces each rank sums and whose dK/dV
    partials (group_sum_kv) each block gathers. t 96 is ragged to the
    twin's 64-row tiles (JAX at block 32). Tolerance: TOL (the f32 sums
    of the n pieces in another order; bf16: ds rounds to bf16 inside
    them)."""
    n, bh = 3, 4
    js, (q, k, v), do, lse, delta = _ring_inputs(n, bh, group, t, dtype,
                                                 causal, 31)
    jq, jk, jv = js
    blocks = dict(block_q=min(t, 32 if t % 64 else 64),
                  block_k=min(t, 32 if t % 64 else 64))
    ref_dq = [0.0] * n
    ref_dkv = [[0.0, 0.0] for _ in range(n)]
    for r in range(n):
        for i in range(n):
            src = (r - i) % n
            dq_p, dk_p, dv_p = jattn.flash_attention_bwd_step(
                jq[r], jk[src], jv[src], jnp.asarray(do[r].numpy()),
                jnp.asarray(delta[r].numpy()), jnp.asarray(lse[r].numpy()),
                jnp.int32(r * t), jnp.int32(src * t), causal=causal,
                interpret=True, kv_group=group, **blocks)
            ref_dq[r] = ref_dq[r] + dq_p
            ref_dkv[src][0] = ref_dkv[src][0] + jattn.group_sum_kv(dk_p, group)
            ref_dkv[src][1] = ref_dkv[src][1] + jattn.group_sum_kv(dv_p, group)

    width = attn.kernel_head_dim(D)
    qf = q.reshape(n * bh, t, D)
    cot = attn.prepare_bwd_step(qf, do.reshape(n * bh, t, D),
                                delta.reshape(n * bh, t, 1),
                                lse.reshape(n * bh, t, 1))
    dq = torch.zeros((n * bh, t, width))
    carriers = torch.zeros((2, n, bh // group, t, width))
    q_off = torch.arange(n).repeat_interleave(bh) * t
    for i in range(n):
        src = (torch.arange(n) - i) % n
        bufs = carriers[:, src].reshape(2, -1, t, width)
        attn.flash_attention_bwd_step_into(
            qf, k[src].reshape(-1, t, D), v[src].reshape(-1, t, D), cot,
            q_off, src.repeat_interleave(bh) * t, dq, bufs[0], bufs[1],
            causal=causal, kv_group=group)
        carriers[:, src] = bufs.view(2, n, bh // group, t, width)
    got_dq = attn.flash_bwd_step_finish(dq, D, torch.float32)
    for r in range(n):
        _close(got_dq.view(n, bh, t, D)[r], ref_dq[r], dtype)
        for x in range(2):
            assert not carriers[x, r, ..., D:].any()
            _close(carriers[x, r, ..., :D], ref_dkv[r][x], dtype)


@pytest.mark.parametrize("group", [1, 2])
def test_bf16_cotangent_and_its_f32_cast_agree_bitwise(group):
    """The ring backward passes a bf16 cotangent as it is: the twins take
    it to f32 exactly, so both entries give bitwise what its f32 cast
    gives."""
    _, targs = _bwd_inputs(4, group, "bfloat16", True, T, 41)
    q, k, v, do, delta, lse = targs
    do16 = do.bfloat16()
    fresh = [attn.flash_attention_bwd_step(q, k, v, x, delta, lse, T, T,
                                           kv_group=group)
             for x in (do16, do16.float())]
    for a, b in zip(*fresh):
        assert torch.equal(a, b)
    sums = []
    for x in (do16, do16.float()):
        bufs = [torch.zeros((4, T, 64)), torch.zeros((4 // group, T, 64)),
                torch.zeros((4 // group, T, 64))]
        cot = attn.prepare_bwd_step(q, x, delta, lse)
        attn.flash_attention_bwd_step_into(q, k, v, cot, T, 0, *bufs,
                                           kv_group=group)
        attn.flash_attention_bwd_step_into(q, k, v, cot, T, T, *bufs,
                                           kv_group=group)
        sums.append(bufs)
    for a, b in zip(*sums):
        assert a.any() and torch.equal(a, b)


def test_step_rejects_what_it_does_not_take():
    q = torch.zeros((4, 8, 16))
    state = (torch.zeros((4, 8, 16)), torch.zeros((4, 8, 1)),
             torch.zeros((4, 8, 1)))
    with pytest.raises(ValueError, match="kv_group"):
        attn.flash_attention_step(q, q[:3], q[:3], *state, 0, 0, kv_group=2)
    with pytest.raises(ValueError, match="acc"):
        attn.flash_attention_step(q, q, q, state[0][:, :4], *state[1:], 0, 0)
    with pytest.raises(ValueError, match="offset"):
        attn.flash_attention_step(q, q, q, *state, torch.zeros(3), 0)
    with pytest.raises(ValueError, match="f32"):
        attn.flash_attention_bwd_step(q, q, q, q.bfloat16(), *state[1:],
                                      0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention_step_into(q, q, q, state[0].transpose(0, 1)
                                       .contiguous().transpose(0, 1),
                                       *state[1:], 0, 0)
    # The twins launch nothing.
    counters = (attn.flash_attention_step, attn.flash_attention_bwd_step,
                attn.prepare_bwd_step, attn.flash_bwd_step_finish)
    before = tuple(c.launches for c in counters)
    attn.flash_attention_step(q, q, q, *state, 8, 0)
    attn.flash_attention_step_into(q, q, q, *state, 8, 0)
    attn.flash_attention_bwd_step(q, q, q, q, *state[1:], 8, 0)
    cot = attn.prepare_bwd_step(q, q, *state[1:])
    bufs = [torch.zeros((4, 8, 64)) for _ in range(3)]
    attn.flash_attention_bwd_step_into(q, q, q, cot, 8, 0, *bufs)
    attn.flash_bwd_step_finish(bufs[0], 16, torch.float32)
    assert tuple(c.launches for c in counters) == before


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 2])
def test_step_kernels_match_twins_on_card(cuda_device, dtype, group):
    gen = torch.Generator(cuda_device).manual_seed(group)
    bh, t, d = 8, 200, 64
    q = torch.randn((bh, t, d), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((bh // group, t, d), generator=gen,
                        device=cuda_device).to(dtype) for _ in range(2))
    state = (torch.zeros((bh, t, d), device=cuda_device),
             torch.full((bh, t, 1), -float("inf"), device=cuda_device),
             torch.zeros((bh, t, 1), device=cuda_device))
    qo = torch.tensor([t, t, 0, 0, t, t, 2 * t, 2 * t], dtype=torch.int32,
                      device=cuda_device)
    ko = torch.tensor([0, t, t, 0, t, t, 0, 0], dtype=torch.int32,
                      device=cuda_device)
    before = attn.flash_attention_step.launches
    ours = attn.flash_attention_step(q, k, v, *state, qo, ko, kv_group=group)
    assert attn.flash_attention_step.launches == before + 1
    plain = attn.flash_attention_step_plain(q, k, v, *state, qo, ko,
                                            kv_group=group)
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=5e-2,
                                   equal_nan=True)
    lse = (ours[1] + torch.log(ours[2].clamp_min(1e-30))).clamp_min(-1e4)
    do = torch.randn((bh, t, d), generator=gen, device=cuda_device)
    delta = torch.randn((bh, t, 1), generator=gen, device=cuda_device)
    before = attn.flash_attention_bwd_step.launches
    got = attn.flash_attention_bwd_step(q, k, v, do, delta, lse, qo, ko,
                                        kv_group=group)
    assert attn.flash_attention_bwd_step.launches == before + 1
    plain = attn.flash_attention_bwd_step_plain(q, k, v, do, delta, lse, qo,
                                                ko, kv_group=group)
    for a, b in zip(got, plain):
        peak = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=2e-2, atol=1e-2 * peak)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("cotangent", ["f32", "input"])
def test_accumulating_step_matches_its_twin_on_card(cuda_device, dtype,
                                                    group, cotangent):
    """flash_attention_bwd_step_into on the card (bf16: the fused launch,
    with an f32 cotangent's three-pass products or a cotangent in q's
    dtype's) against its twin on the same carriers, two steps in a row,
    then flash_bwd_step_finish. Tolerance: STEP_TOL's (2e-2, 1e-2 x the
    largest |twin|)."""
    gen = torch.Generator(cuda_device).manual_seed(7 + group)
    bh, t, d = 8, 200, 64
    q = torch.randn((bh, t, d), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((bh // group, t, d), generator=gen,
                        device=cuda_device).to(dtype) for _ in range(2))
    do = torch.randn((bh, t, d), generator=gen, device=cuda_device)
    if cotangent == "input":
        do = do.to(dtype)
    lse = torch.rand((bh, t, 1), generator=gen, device=cuda_device) + 3.0
    delta = torch.randn((bh, t, 1), generator=gen, device=cuda_device)
    bufs = [torch.randn((bh, t, d), generator=gen, device=cuda_device)] + [
        torch.randn((bh // group, t, d), generator=gen, device=cuda_device)
        for _ in range(2)]
    plain = [b.clone() for b in bufs]
    cot = attn.prepare_bwd_step(q, do, delta, lse)
    before = attn.flash_attention_bwd_step.launches
    for q_off, k_off in ((t, 0), (t, t)):
        attn.flash_attention_bwd_step_into(q, k, v, cot, q_off, k_off, *bufs,
                                           kv_group=group)
        attn.flash_attention_bwd_step_into_plain(q, k, v, do, delta, lse,
                                                 q_off, k_off, *plain,
                                                 kv_group=group)
    torch.cuda.synchronize()
    assert attn.flash_attention_bwd_step.launches == before + 2
    for a, b in zip(bufs, plain):
        torch.testing.assert_close(a, b, rtol=2e-2,
                                   atol=1e-2 * float(b.abs().max()))
    torch.testing.assert_close(
        attn.flash_bwd_step_finish(bufs[0], d, dtype).float(),
        (plain[0] * attn._dq_scale(d)).to(dtype).float(), rtol=2e-2,
        atol=1e-2 * float(plain[0].abs().max()) * attn._dq_scale(d))


@pytest.mark.cuda
@pytest.mark.parametrize("case", cs.STEP_CASES,
                         ids=[c[0] for c in cs.STEP_CASES])
def test_step_into_matches_its_twin_on_card(cuda_device, case):
    """B6 in place (flash_attention_step_into) over every ring step of a
    STEP_CASES world, each step against the twin from the same state
    within chip_smoke's STEP_TOL (STATE_TOL for m and l), and bitwise the
    out-of-place flash_attention_step from that state."""
    name, ranks, b, h, h_kv, t, d, dtype, causal = case
    gen = torch.Generator(cuda_device).manual_seed(ranks * t + d)
    mesh = make_mesh({"seq": ranks}, devices=[cuda_device] * ranks)
    q = torch.randn((ranks, b, h, t, d), generator=gen, device=cuda_device)
    k, v = (torch.randn((ranks, b, h_kv, t, d), generator=gen,
                        device=cuda_device) for _ in range(2))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qf, steps, q_off, group = cs.ring_steps(sp, spmd, q, k, v, "seq", mesh,
                                            causal)
    bh = qf.shape[0]
    bufs = [torch.zeros((bh, t, d), device=cuda_device),
            torch.full((bh, t, 1), -float("inf"), device=cuda_device),
            torch.zeros((bh, t, 1), device=cuda_device)]
    for i, (ks, vs, k_off) in enumerate(steps):
        before = [x.clone() for x in bufs]
        launches = attn.flash_attention_step.launches
        attn.flash_attention_step_into(qf, ks, vs, *bufs, q_off, k_off,
                                       causal, group)
        assert attn.flash_attention_step.launches == launches + 1
        out = attn.flash_attention_step(qf, ks, vs, *before, q_off, k_off,
                                        causal, group)
        ref = attn.flash_attention_step_plain(qf, ks, vs, *before, q_off,
                                              k_off, causal, group)
        torch.cuda.synchronize()
        for j, (a, o, r) in enumerate(zip(bufs, out, ref)):
            err, ok = cs.step_close(a, r, dtype, state=j > 0)
            assert ok, (i, j, err)
            assert torch.equal(a, o), (i, j)
