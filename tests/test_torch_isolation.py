"""The port stands alone: it imports neither JAX nor gloo_tpu, its entry
points raise rather than run quietly on the CPU, and its kernel table
names every Pallas kernel of the JAX package."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from gloo_tpu_torch.ops.kernel_table import KERNELS

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "gloo_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_import_pulls_in_no_jax_and_no_gloo_tpu():
    code = (
        "import json, sys\n"
        "import gloo_tpu_torch, gloo_tpu_torch.entry, gloo_tpu_torch.weights\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'gloo_tpu' or "
        "m.startswith('gloo_tpu.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_gloo_tpu_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "gloo_tpu"), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}")


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from gloo_tpu_torch import weights
    from gloo_tpu_torch.entry import ENTRY_CONFIG, entry, train_entry
    from gloo_tpu_torch.models import MLP, Transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry, train_entry, lambda: Transformer(ENTRY_CONFIG),
                 lambda: MLP((4, 4)),
                 lambda: weights.transformer_params_from_numpy({}, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    fn, (model, tokens) = entry("cpu")
    assert tokens.device.type == "cpu"
    assert fn(model, tokens).shape == (8, 128, ENTRY_CONFIG.vocab_size)


def test_chip_smoke_fails_without_a_gpu(monkeypatch):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)


def _pallas_kernels(path):
    """{kernel function: (def line, pallas_call line)} for one module of
    gloo_tpu/ops, read as text: each pl.pallas_call's kernel is the
    top-level _*_kernel function bound (functools.partial) in the function
    that makes the call."""
    tree = ast.parse(path.read_text(), filename=str(path))
    defs = {n.name: n.lineno for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.endswith("_kernel")}
    found = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name in defs:
            continue
        calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)),
                       key=lambda c: c.lineno)
        sites = [c.lineno for c in calls
                 if isinstance(c.func, ast.Attribute)
                 and c.func.attr == "pallas_call"]
        bound = [a.id for c in calls for a in c.args
                 if isinstance(a, ast.Name) and a.id in defs]
        # One bound kernel per call site, in source order.
        assert len(sites) == len(bound), (path, fn.name)
        for site, name in zip(sites, bound):
            found[name] = (defs[name], site)
    return found


def test_kernel_table_covers_every_pallas_call():
    ops = REPO / "gloo_tpu" / "ops"
    found = {}
    n_calls = 0
    for path in sorted(ops.glob("*.py")):
        n_calls += path.read_text().count("pl.pallas_call(")
        rel = str(path.relative_to(REPO))
        found.update({(rel, name): lines
                      for name, lines in _pallas_kernels(path).items()})
    table = {(k.file, k.function): (k.def_line, k.call_line)
             for k in KERNELS}
    assert n_calls == len(KERNELS) == 14
    assert table == found
    assert len({k.id for k in KERNELS}) == len(KERNELS)
    for k in KERNELS:
        assert k.status.startswith(("ported: ", "to port: slice "))
        if k.status.startswith("ported: "):
            assert (REPO / k.status.split(": ", 1)[1]).is_file()
