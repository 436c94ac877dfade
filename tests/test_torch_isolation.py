"""The port stands alone: it imports neither JAX nor gloo_tpu, its entry
points raise rather than run quietly on the CPU, and its kernel table
names every Pallas kernel of the JAX package."""

import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from gloo_tpu_torch.ops.kernel_table import KERNELS

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "gloo_tpu_torch").rglob("*.py")) + sorted(
    (REPO / "examples").glob("torch_*.py")) + [
    REPO / "chip_smoke.py", REPO / "host_times.py"]


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


def test_recovery_modules_pull_in_no_jax_orbax_or_gloo_tpu():
    code = (
        "import json, sys\n"
        "import gloo_tpu_torch.checkpoint, gloo_tpu_torch.resilience\n"
        "import gloo_tpu_torch.elastic, gloo_tpu_torch.bootstrap\n"
        "print(json.dumps(sorted(m for m in sys.modules if "
        "m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'gloo_tpu'))))\n")
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
            assert root not in ("jax", "jaxlib", "orbax", "gloo_tpu"), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}")


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from gloo_tpu_torch import weights
    from gloo_tpu_torch.entry import (ENTRY_CONFIG, ddp_train_entry,
                                      dp_tp_train_entry,
                                      elastic_step_fn, elastic_train_entry,
                                      entry, ep_entry, fsdp_train_entry,
                                      hier_ddp_entry, host_ddp_entry,
                                      pp_entry, ring_variants_entry,
                                      sp_entry, train_entry)
    from gloo_tpu_torch.models import MLP, Transformer
    from gloo_tpu_torch.tpu import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        make_mesh()
    for call in (entry, train_entry, ddp_train_entry, dp_tp_train_entry,
                 sp_entry, ep_entry, ring_variants_entry, fsdp_train_entry,
                 pp_entry,
                 lambda: hier_ddp_entry(0, 1, str(tmp_path)),
                 lambda: host_ddp_entry(0, 1, str(tmp_path)),
                 lambda: elastic_train_entry(0, 1, str(tmp_path)),
                 lambda: elastic_step_fn(0, None),
                 lambda: Transformer(ENTRY_CONFIG),
                 lambda: MLP((4, 4)),
                 lambda: weights.transformer_params_from_numpy({}, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    fn, (model, tokens) = entry("cpu")
    assert tokens.device.type == "cpu"
    assert fn(model, tokens).shape == (8, 128, ENTRY_CONFIG.vocab_size)


def test_port_maps_its_own_host_library_only():
    """A process that ran a port allreduce has mapped the port's build of
    the host library (build/gloo_tpu_torch/libtpucoll-*.so) and no build
    of the JAX package (gloo_tpu/_native/)."""
    code = (
        "import gloo_tpu_torch, torch\n"
        "ctx = gloo_tpu_torch.Context(0, 1, timeout=10)\n"
        "ctx.connect_full_mesh(gloo_tpu_torch.HashStore(),\n"
        "                      gloo_tpu_torch.Device())\n"
        "assert float(ctx.allreduce(torch.ones(4))[0]) == 1.0\n"
        "ctx.close()\n"
        "print(open('/proc/self/maps').read())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    libs = {line.split()[-1] for line in out.stdout.splitlines()
            if "libtpucoll" in line}
    assert len(libs) == 1, libs
    (lib,) = libs
    assert re.fullmatch(re.escape(str(REPO / "build" / "gloo_tpu_torch"))
                        + r"/libtpucoll-[0-9a-f]{16}\.so", lib), lib
    assert "gloo_tpu/_native" not in out.stdout


def test_host_library_build_is_the_makefiles():
    """The port's build compiles the Makefile's sources (csrc/tpucoll/*.cc
    and */*.cc, the AVX-512 unit only with its flag) with its flags, and
    a second call finds the library it built."""
    from gloo_tpu_torch import _build

    makefile = (REPO / "Makefile").read_text()
    assert "-std=c++17 -O3" in makefile and "-mavx2 -mfma -mf16c" in makefile
    sources = _build.host_sources(avx512=True)
    assert _build.HOST_AVX512_SOURCE in sources
    assert _build.HOST_AVX512_SOURCE not in _build.host_sources(False)
    assert sorted(sources) == sorted(
        str(p.relative_to(REPO / "csrc")) for pattern in
        ("tpucoll/*.cc", "tpucoll/*/*.cc")
        for p in (REPO / "csrc").glob(pattern))
    path = _build.build_host_library()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert _build.build_host_library() == path
    flags, _ = _build.host_flags(_build._cxx())
    assert path == _build.host_library_path(flags)
    assert path != _build.host_library_path(flags + ("-DX",))


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
        ported, *design = k.status.split("; ")
        assert ported.startswith("ported: ")
        assert (REPO / ported.split(": ", 1)[1]).is_file()
        assert design == [] or re.fullmatch(r"redesigned, PR \d+",
                                            design[0]), k
    variants = {k.id: k.status.split("; ")[0] for k in KERNELS if k.id in
                ("B9", "B10", "B11")}
    assert variants == dict.fromkeys(
        ("B9", "B10", "B11"), "ported: gloo_tpu_torch/csrc/ring_variants.cu")
