"""The port's tools against the reference's: tools/torch_bench.py beside
tools/tpu_bench.py, and the dump viewers tools/torch_{critpath,flightrec,
profile}_view.py beside tools/{critpath,flightrec,profile}_view.py.

torch_bench runs on the CPU here (--device cpu: the kernels' plain
versions at the reference's interpreter sizes), in a subprocess that
cannot import jax. Its collective rows must carry the reference's bytes
and elements columns (the reference runs as the oracle with
JAX_PLATFORMS_FORCE_CPU=8; its times are ignored), its flash rows the
reference's byte and FLOP counts, and a failed row must make it exit 1.
The viewers read one set of the port's dumps (three thread ranks, a
delay fault on rank 1) and must print what the reference's viewers print
on the same files, with the same exit codes and Perfetto files.
"""

import importlib.util
import json
import os
import pathlib
import re
import runpy
import subprocess
import sys
import textwrap

import pytest
import torch

from gloo_tpu_torch import _lib, fault
from gloo_tpu_torch.utils import critpath, flightrec
from tests.test_torch_host import spawn

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
ELEMENTS = "1024,65536"
RANKS = 8
COLLECTIVES = ("allreduce", "allgather", "reduce_scatter", "alltoall",
               "ppermute", "pallas_ring", "pallas_ring_hbm")
ROW = re.compile(r"^\s*(\S+)\s+(\S+)\s+(\S+)\s+([\d.]+)\s+([\d.]+)\s+"
                 r"([\d.]+)\s+([\d.]+)\s+(\d+)")


def load_file(path):
    """A tool or example of the repo, imported from its path."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_bench():
    return load_file(TOOLS / "torch_bench.py")


def no_jax_env(tmp_path):
    """An environment whose python cannot import jax: a stub package that
    raises ImportError comes first on PYTHONPATH."""
    stub = tmp_path / "nojax" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        "raise ImportError('this process must not import jax')\n")
    path = os.pathsep.join([str(stub.parent)] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    return dict(os.environ, PYTHONPATH=path)


def rows(text):
    """{(op, elements): (bytes, elements)} of the table's rows."""
    out = {}
    for line in text.splitlines():
        m = ROW.match(line)
        if m and not line.startswith("#"):
            out[(m.group(1), m.group(3))] = (m.group(2), m.group(3))
    return out


@pytest.fixture(scope="module")
def bench_cpu(tmp_path_factory):
    """torch_bench --op all on the CPU, in a process without jax."""
    proc = subprocess.run(
        [sys.executable, str(TOOLS / "torch_bench.py"), "--device", "cpu",
         "--ranks", str(RANKS), "--op", "all", "--elements", ELEMENTS,
         "--min-time", "0.01"],
        cwd=REPO, env=no_jax_env(tmp_path_factory.mktemp("bench")),
        capture_output=True, text=True, timeout=600)
    return proc


@pytest.fixture(scope="module")
def reference_rows():
    """The reference tool's collective rows on the virtual CPU mesh of 8
    (one process; each op one call of its main)."""
    code = textwrap.dedent(f"""
        import runpy, sys
        for op in {list(COLLECTIVES)!r}:
            sys.argv = ["tpu_bench.py", "--op", op, "--elements",
                        "{ELEMENTS}", "--min-time", "0.01", "--warmup", "0"]
            runpy.run_path("tools/tpu_bench.py", run_name="__main__")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PLATFORMS_FORCE_CPU=str(RANKS))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return rows(proc.stdout)


def test_bench_runs_every_op_on_the_cpu(bench_cpu):
    out = bench_cpu.stdout
    assert bench_cpu.returncode == 0, (out[-2000:], bench_cpu.stderr[-3000:])
    assert "skipped" not in out
    assert re.search(r"# torch_bench devices=8xcpu mesh=\{'data': 8\}", out)
    assert ("      op        bytes     elements   min(us)   p50(us)   p99(us)"
            "  algbw(GB/s)   iters") in out
    got = rows(out)
    for op in COLLECTIVES:
        for elements in ELEMENTS.split(","):
            assert (op, elements) in got, (op, elements)
    # Both element counts clamp to t = 128: one row each, as in the
    # reference.
    flash = {k for k in got if k[0] in ("flash_attention", "flash_bwd")}
    assert flash == {("flash_attention", "131072"), ("flash_bwd", "131072")}
    for name in ("plain_dot", "matmul_rs", "ag_matmul"):
        assert (name, "256x256") in got
    for name in ("unfused_step", "fused_step"):
        assert re.search(rf"^\s+{name}\s+[\d.]+ us/step\s+[\d.]+ GFLOP/s",
                         out, re.M), name
    assert re.search(r"^# dispatch: use_fused_overlap at share 0\.00 .* "
                     r"(MATCHES|CONTRADICTS) measured winner$", out, re.M)


@pytest.mark.parametrize("op", COLLECTIVES)
def test_collective_columns_are_the_references(bench_cpu, reference_rows,
                                               op):
    assert bench_cpu.returncode == 0, bench_cpu.stderr[-3000:]
    mine = {k: v for k, v in rows(bench_cpu.stdout).items() if k[0] == op}
    ref = {k: v for k, v in reference_rows.items() if k[0] == op}
    assert len(ref) == 2 and mine == ref


def reference_flash_counts(h, t, d, backward):
    """tools/tpu_bench.py:248-253, as written there."""
    fwd_flops = 2 * h * (t * t // 2) * d * 2
    flops = int(fwd_flops * 3.5) if backward else fwd_flops
    nbytes = 3 * h * t * d * 2
    if backward:
        nbytes = nbytes + 2 * h * t * d * 2 + 3 * h * t * d * 4
    return flops, nbytes


@pytest.mark.parametrize("backward", (False, True))
def test_flash_counts_are_the_references(bench_cpu, backward):
    bench = load_bench()
    for t in (128, 256, 1024, 16384):
        assert bench.flash_counts(8, t, 128, backward) == \
            reference_flash_counts(8, t, 128, backward)
    # t from the element count, as at tpu_bench.py:208 (and its
    # interpreter clamp on the CPU).
    assert [bench.flash_t(e, True) for e in (1024, 1048576, 16777216)] == \
        [128, 1024, 16384]
    assert bench.flash_t(16777216, False) == 256
    label = "flash_bwd" if backward else "flash_attention"
    line = next(ln for ln in bench_cpu.stdout.splitlines()
                if ln.split()[:1] == [label])
    fields = line.split()
    flops, nbytes = reference_flash_counts(8, 128, 128, backward)
    assert int(fields[1]) == nbytes and int(fields[2]) == 8 * 128 * 128
    # The rate column is the FLOPs over p50 (both printed rounded).
    p50_us, rate = float(fields[4]), float(fields[6])
    assert rate == pytest.approx(flops / p50_us / 1e3, rel=2e-3, abs=2e-3)


def test_a_failed_row_exits_1(monkeypatch, capsys):
    bench = load_bench()
    from gloo_tpu_torch.tpu import spmd

    def broken(*args, **kwargs):
        raise RuntimeError("forced failure")

    monkeypatch.setattr(spmd, "allreduce", broken)
    argv = ["--device", "cpu", "--op", "allreduce", "--elements", "1024",
            "--min-time", "0.01"]
    assert bench.main(argv) == 1
    out = capsys.readouterr().out
    assert re.search(r"^\s+allreduce\s+-\s+1024\s+skipped: forced failure",
                     out, re.M)
    monkeypatch.undo()
    got = []
    assert bench.main(argv + ["--op", "ppermute"], rows=got) == 0
    assert [r["op"] for r in got] == ["ppermute"]


def test_flash_blocks_are_fixed_tiles(capsys):
    bench = load_bench()
    argv = ["--device", "cpu", "--op", "flash_attention", "--elements",
            "1024", "--min-time", "0.01", "--flash-blocks",
            "128x128,512x1024"]
    assert bench.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("skipped: the Hopper kernels fix their tiles") == 1
    assert len(re.findall(r"^\s+flash_attention\s+\d+", out, re.M)) == 1


def test_bench_raises_without_a_card(monkeypatch):
    bench = load_bench()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--op", "allreduce"])


# ---- the dump viewers ----

DELAY = {"seed": 7, "faults": [
    {"when": {"rank": 1, "opcode": "data", "min_bytes": 1024},
     "action": "delay", "ms": 50, "count": 6}]}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """One directory of the port's dumps from three thread ranks under a
    delay fault on rank 1: flightrec-rank*.json, spans-rank*.json and
    profile-rank*.json, and a saved fleet document."""
    root = tmp_path_factory.mktemp("dumps")

    def run(ctx, rank):
        ctx.profile_enable(True)
        ctx.spans_enable(True)
        x = torch.ones(1 << 18)
        for _ in range(4):
            ctx.allreduce(x, algorithm="ring")
            x[:] = 1.0
        ctx.barrier()
        flightrec.dump(ctx, str(root))
        critpath.dump(ctx, str(root))
        (root / f"profile-rank{rank}.json").write_text(
            json.dumps(ctx.profile()))

    fault.install(DELAY)
    try:
        spawn(3, run, timeout=60)
    finally:
        fault.clear()
    from tests.test_fleet import _SYNTH_FLEET

    (root / "fleet.json").write_text(json.dumps(_SYNTH_FLEET))
    return root


def run_viewer(path, argv, capsys):
    """(exit status, stdout) of one viewer run in this process, as
    `python PATH ARGV` runs it (its directory first on sys.path)."""
    argv_before, path_before = sys.argv, list(sys.path)
    sys.argv = [str(path)] + argv
    sys.path.insert(0, str(path.parent))
    try:
        runpy.run_path(str(path), run_name="__main__")
        code = 0
    except SystemExit as exc:
        code = exc.code
    finally:
        sys.argv, sys.path[:] = argv_before, path_before
    return code, capsys.readouterr().out


VIEWER_CASES = [
    ("flightrec", []), ("flightrec", ["--check"]),
    ("flightrec", ["--tail", "3"]), ("flightrec", ["--perfetto"]),
    ("flightrec", ["fleet.json", "--fleet"]),
    ("critpath", []), ("critpath", ["--json"]),
    ("critpath", ["--check", "1=send:0.01"]),
    ("critpath", ["--check", "0=local:1.0"]),
    ("critpath", ["--clock", "raw", "--ops", "2", "--slack", "3"]),
    ("critpath", ["--perfetto"]),
    ("profile", []), ("profile", ["--json"]), ("profile", ["--ops", "3"]),
    ("profile", ["--perfetto"]), ("profile", ["fleet.json", "--fleet"]),
]


@pytest.mark.parametrize("viewer,argv", VIEWER_CASES,
                         ids=[f"{v}:{' '.join(a) or 'dir'}"
                              for v, a in VIEWER_CASES])
def test_viewer_is_the_references(dumps, capsys, viewer, argv):
    results = []
    for path in (TOOLS / f"torch_{viewer}_view.py",
                 TOOLS / f"{viewer}_view.py"):
        args = [str(dumps / a) if a == "fleet.json" else a for a in argv]
        if "--fleet" not in args:
            args.insert(0, str(dumps))
        perfetto = None
        if "--perfetto" in args:
            perfetto = dumps / f"{path.stem}.perfetto.json"
            args.insert(args.index("--perfetto") + 1, str(perfetto))
        code, out = run_viewer(path, args, capsys)
        if perfetto is not None:
            out = out.replace(str(perfetto), "OUT")
            out += perfetto.read_text()
        results.append((code, out))
    (code, out), ref = results
    assert out.strip(), "the viewer printed nothing"
    assert (code, out) == ref


def test_viewer_check_codes(dumps, capsys):
    """flightrec --check: 0 on the clean run, 2 on a desync; critpath
    --check: 0 pass, 3 fail."""
    view = TOOLS / "torch_flightrec_view.py"
    assert run_viewer(view, [str(dumps), "--check"], capsys)[0] == 0
    desync = dumps / "desync"
    desync.mkdir()
    for r in range(3):
        doc = json.loads((dumps / f"flightrec-rank{r}.json").read_text())
        if r == 2:
            events = [e for e in doc["events"] if e["cseq"] is not None]
            events[1]["fp"], events[1]["op"] = "ffff", "broadcast"
        (desync / f"flightrec-rank{r}.json").write_text(json.dumps(doc))
    code, out = run_viewer(view, [str(desync), "--check"], capsys)
    assert code == 2 and "verdict: DESYNC" in out
    crit = TOOLS / "torch_critpath_view.py"
    assert run_viewer(crit, [str(dumps), "--check", "1=send:0.01"],
                      capsys)[0] == 0
    assert run_viewer(crit, [str(dumps), "--check", "0=local:1.0"],
                      capsys)[0] == 3
