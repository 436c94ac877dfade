"""gloo_tpu_torch's GradientBucketer and HostGradSync against gloo_tpu's,
bitwise, over 2, 3 and 4 thread ranks of each side's host plane.

The same gradients (numpy from a seed per rank) go through
gloo_tpu.bucketer.GradientBucketer and gloo_tpu.parallel.HostGradSync on
numpy arrays and through the port's on torch tensors. The two arms of
HostGradSync round differently when the size is not a power of 2 (the
sequential one divides by the size, the bucketed one multiplies by
1/size; an integer leaf's truncated mean goes through float64), and each
must equal its own reference bit for bit.
"""

import numpy as np
import pytest
import torch

ml_dtypes = pytest.importorskip("ml_dtypes")
jax = pytest.importorskip("jax")

from gloo_tpu.bucketer import GradientBucketer as JaxBucketer  # noqa: E402
from gloo_tpu.parallel import HostGradSync as JaxHostGradSync  # noqa: E402
from gloo_tpu_torch.bucketer import GradientBucketer, scale_inplace  # noqa: E402,E501
from gloo_tpu_torch.parallel import HostGradSync  # noqa: E402
from tests.harness import spawn as jax_spawn  # noqa: E402
from tests.test_torch_host import raw, spawn, to_torch  # noqa: E402

BF16 = ml_dtypes.bfloat16

# name -> (leaf shapes and dtypes, bucket bytes, average, wire)
BUCKET_CASES = {
    "f32_many_buckets": ([((3, 5), np.float32), ((7,), np.float32),
                          ((2, 2, 3), np.float32), ((1,), np.float32),
                          ((40,), np.float32)], 96, True, None),
    "mixed_dtypes": ([((3, 5), np.float32), ((9,), BF16), ((6,), np.int32),
                      ((4, 2), np.float16), ((5,), np.int64),
                      ((11,), BF16), ((8,), np.float32)], 64, True, None),
    "oversized": ([((4,), np.float32), ((64,), np.float32),
                   ((3,), np.float32), ((33,), np.int32)], 128, True, None),
    "q8_wire": ([((300,), np.float32), ((6,), np.int32),
                 ((257,), np.float32)], 1 << 20, True, "q8"),
    "sum": ([((5,), np.float32), ((7,), np.int32), ((3,), BF16)], 32,
            False, None),
}


def _leaf(shape, dtype, rank, i):
    rng = np.random.RandomState(100 * rank + i)
    if np.issubdtype(dtype, np.integer):
        return rng.randint(-50, 50, shape).astype(dtype)
    return rng.randn(*shape).astype(dtype)


def _bucket_run(port, ctx, rank, case):
    leaves, bucket_bytes, average, wire = BUCKET_CASES[case]
    engine = ctx.async_engine(lanes=2)
    cls = GradientBucketer if port else JaxBucketer
    bucketer = cls(engine, bucket_bytes=bucket_bytes, average=average,
                   wire=wire)
    out = []
    for step in range(2):  # the flat buffers are reused in step 2
        arrays = [_leaf(s, d, rank + 10 * step, i)
                  for i, (s, d) in enumerate(leaves)]
        if port:
            arrays = [to_torch(a) for a in arrays]
        for a in arrays:
            bucketer.add(a)
        bucketer.finish()
        out.append([raw(a) for a in arrays])
    return out


@pytest.mark.parametrize("size", (2, 3, 4))
@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucketer_matches_the_reference_bitwise(case, size):
    ref = jax_spawn(size, lambda ctx, r: _bucket_run(False, ctx, r, case),
                    timeout=120)
    got = spawn(size, lambda ctx, r: _bucket_run(True, ctx, r, case),
                timeout=120)
    assert got == ref


def _grads(rank, np_tree=True):
    tree = {"w": _leaf((3, 5), np.float32, rank, 0),
            "b": _leaf((5,), np.float32, rank, 1),
            "emb": _leaf((7, 4), BF16, rank, 2),
            "count": _leaf((6,), np.int32, rank, 3),
            "half": [_leaf((4,), np.float16, rank, 4),
                     (_leaf((2, 3), np.float32, rank, 5),)]}
    if np_tree:
        return tree
    return {"w": to_torch(tree["w"]), "b": to_torch(tree["b"]),
            "emb": to_torch(tree["emb"]), "count": to_torch(tree["count"]),
            "half": [to_torch(tree["half"][0]),
                     (to_torch(tree["half"][1][0]),)]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


ARMS = {"sequential": dict(bucketed=False),
        "bucketed": dict(bucketed=True, bucket_bytes=64),
        "sequential_q8": dict(bucketed=False, wire="q8"),
        "bucketed_q8": dict(bucketed=True, wire="q8")}


def _sync_run(port, ctx, rank, arm):
    cls = HostGradSync if port else JaxHostGradSync
    sync = cls(ctx, **ARMS[arm])
    out = []
    for step in range(2):
        grads = _grads(rank + 10 * step, np_tree=not port)
        before = [raw(x) for x in _leaves(grads)]
        if ARMS[arm].get("wire") and not ARMS[arm]["bucketed"]:
            # The C++ core's q8 wire gives other bits on a reused plan
            # (ROADMAP.md C.7), and whether a leaf's copy lands on an
            # address of the step before depends on the allocator: both
            # sides start each step with no plan.
            ctx.plan_cache_clear()
            ctx.barrier()
        avg = sync.average(grads)
        if port:
            assert [raw(x) for x in _leaves(grads)] == before
            assert isinstance(avg, dict) and isinstance(avg["half"], list)
            assert isinstance(avg["half"][1], tuple)
            assert [x.dtype for x in _leaves(avg)] == \
                [x.dtype for x in _leaves(grads)]
        out.append([raw(np.asarray(x)) if not port else raw(x)
                    for x in _leaves(avg)])
    return out


@pytest.mark.parametrize("size", (2, 3, 4))
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_host_grad_sync_matches_the_reference_bitwise(arm, size):
    """Both arms, with and without the q8 wire on the f32 leaves, over a
    tree of f32, bf16, f16 and int32 leaves; the caller's tensors stay
    unchanged and the tree keeps its structure."""
    ref = jax_spawn(size, lambda ctx, r: _sync_run(False, ctx, r, arm),
                    timeout=120)
    got = spawn(size, lambda ctx, r: _sync_run(True, ctx, r, arm),
                timeout=120)
    assert got == ref


def test_the_arms_round_differently():
    """At size 3 the sequential arm's x / 3 and the bucketed arm's
    x * f32(1/3) differ in some last bits of f32. An integer leaf's
    truncated means can differ too: 49 / 49 = 1, 49 * (1/49) =
    0.999... in float64."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    assert not torch.equal(x / 3, scale_inplace(x.clone(), 1.0 / 3))
    ints = torch.tensor([49, 98, -49], dtype=torch.int32)
    assert scale_inplace(ints.clone(), 1.0 / 49).tolist() == [0, 1, 0]
    assert (ints.double() / 49).to(torch.int32).tolist() == [1, 2, -1]


def test_bucketer_rejects_what_the_reference_rejects():
    def fn(ctx, rank):
        engine = ctx.async_engine(lanes=1)
        errors = []
        for kwargs in (dict(op=lambda a, b: None), dict(average=True,
                                                        op="max"),
                       dict(wire="q9"), dict(bucket_bytes=0)):
            try:
                GradientBucketer(engine, **kwargs)
            except Exception as exc:  # noqa: BLE001
                errors.append(type(exc).__name__)
        bucketer = GradientBucketer(engine)
        for bad in (np.zeros(3, np.float32), torch.zeros(4, 4).T):
            try:
                bucketer.add(bad)
            except Exception as exc:  # noqa: BLE001
                errors.append(type(exc).__name__)
        return errors

    assert spawn(1, fn) == [["Error"] * 4 + ["TypeError", "Error"]]
