"""Builds the package's CUDA sources with nvcc and the host library with
g++, and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/gloo_tpu_torch/lib<name>-<hash>.so``
beside the package, at first use. The hash covers the source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. The host library (the C++ core of the repo's
``csrc/tpucoll``: stores, transports, collective schedules) becomes
``build/gloo_tpu_torch/libtpucoll-<hash>.so`` the same way
(``build_host_library``); the port never loads another build of it. There
is no fallback: without the compiler, or when a source does not compile,
the caller gets the compiler's output in the exception.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "gloo_tpu_torch"
# The C++ core of the host plane, shared with the JAX package's build and
# compiled here unchanged.
HOST_SRC_DIR = PACKAGE_DIR.parent / "csrc"
# The Makefile's plain g++ build of the core (its native-cc target),
# without debug info and warnings.
HOST_FLAGS = ("-std=c++17", "-O3", "-fPIC", f"-I{HOST_SRC_DIR}", "-pthread")
HOST_X86_FLAGS = ("-mavx2", "-mfma", "-mf16c")
HOST_AVX512_SOURCE = "tpucoll/common/crypto_avx512.cc"
HOST_LINK = ("-lpthread", "-lrt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register and spill counts) for each source built by
# this process.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of gloo_tpu_torch cannot be built")


def source_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compiles the named sources (default: all) that are not up to date,
    one nvcc process each, all started together. Returns name -> library.
    Raises RuntimeError with the compiler's output if any build fails."""
    names = source_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: library_path(name) for name in names}
    running = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, target)
    failures = []
    for name, (proc, tmp, target) in running.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        for stale in BUILD_DIR.glob(f"lib{name}-*.so"):
            stale.unlink()
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the host library of "
                           "gloo_tpu_torch cannot be built")
    return path


def _takes_avx512(cxx: str) -> bool:
    probe = subprocess.run([cxx, "-mavx512f", "-x", "c++", "-", "-o",
                            os.devnull], input="int main(){return 0;}",
                           capture_output=True, text=True)
    return probe.returncode == 0


def host_sources(avx512: bool) -> list[str]:
    """The core's translation units, relative to csrc/: the Makefile's
    list (csrc/tpucoll/*.cc and */*.cc), the AVX-512 one only when the
    compiler takes -mavx512f."""
    found = sorted(str(p.relative_to(HOST_SRC_DIR)) for pattern in
                   ("tpucoll/*.cc", "tpucoll/*/*.cc")
                   for p in HOST_SRC_DIR.glob(pattern))
    return [s for s in found if avx512 or s != HOST_AVX512_SOURCE]


def host_flags(cxx: str) -> tuple[tuple[str, ...], bool]:
    """(compile flags, whether the AVX-512 unit is built)."""
    flags = HOST_FLAGS
    avx512 = False
    if platform.machine() == "x86_64":
        flags += HOST_X86_FLAGS
        avx512 = _takes_avx512(cxx)
        if avx512:
            flags += ("-DTPUCOLL_HAVE_AVX512=1",)
    return flags, avx512


def host_library_path(flags: tuple[str, ...]) -> Path:
    h = hashlib.sha256()
    for path in sorted(p for p in (HOST_SRC_DIR / "tpucoll").rglob("*")
                       if p.suffix in (".cc", ".h")):
        h.update(str(path.relative_to(HOST_SRC_DIR)).encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags + HOST_LINK).encode())
    return BUILD_DIR / f"libtpucoll-{h.hexdigest()[:16]}.so"


def _compile_all(jobs, limit: int) -> list[str]:
    """Runs every (command, label) of `jobs`, at most `limit` at a time;
    returns the failures with the compiler's output."""
    pending, running, failures = list(jobs), [], []
    while pending or running:
        while pending and len(running) < limit:
            cmd, label = pending.pop(0)
            running.append((subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), label))
        proc, label = running.pop(0)
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"g++ failed for {label} (exit "
                            f"{proc.returncode}):\n{log}")
    return failures


def build_host_library() -> Path:
    """The port's own build of the host library, compiled from csrc/ if it
    is not up to date: one g++ per translation unit, as many at once as
    the machine has cores (each takes some hundreds of MB), then one link.
    A file lock around the build lets concurrent processes build it once;
    the library is installed by an atomic rename. Returns its path; raises
    RuntimeError with the compiler's output if a unit does not compile."""
    cxx = _cxx()
    flags, avx512 = host_flags(cxx)
    target = host_library_path(flags)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtpucoll.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return target
        with tempfile.TemporaryDirectory(dir=BUILD_DIR,
                                         prefix="tpucoll-objs-") as objs:
            jobs, outputs = [], []
            for src in host_sources(avx512):
                obj = os.path.join(objs, src.replace("/", "_")[:-3] + ".o")
                extra = ("-mavx512f",) if src == HOST_AVX512_SOURCE else ()
                jobs.append(([cxx, *flags, *extra, "-c",
                              str(HOST_SRC_DIR / src), "-o", obj], src))
                outputs.append(obj)
            failures = _compile_all(jobs, os.cpu_count() or 1)
            if failures:
                raise RuntimeError("\n".join(failures))
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            link = subprocess.run([cxx, "-shared", "-o", str(tmp), *outputs,
                                   *HOST_LINK], capture_output=True,
                                  text=True)
            if link.returncode != 0:
                raise RuntimeError(f"linking libtpucoll failed (exit "
                                   f"{link.returncode}):\n{link.stdout}"
                                   f"{link.stderr}")
        for stale in BUILD_DIR.glob("libtpucoll-*.so"):
            stale.unlink()
        os.replace(tmp, target)
    return target
