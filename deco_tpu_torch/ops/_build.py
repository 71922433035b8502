"""Build the port's C++ and CUDA sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into ``build/deco_tpu_torch/
<name>-<digest>.so`` at the repository root (listed in ``.gitignore``), where
the digest covers the sources and the flags, so an edited source rebuilds.
The sources expose a plain C interface, which keeps a build to seconds: no
PyTorch header is compiled. The build happens at first use, or up front for
every source at once through :func:`build` (one ``nvcc`` per source, all
started together). A failed build raises; there is no fallback.

Each ``csrc/<name>.cpp`` is host code (the JPEG decoder of the data layer):
the host C++ compiler builds it (:func:`host_compiler`, no ``nvcc``) with
:data:`HOST_FLAGS` into the same folder, at first use, under a file lock so
that parallel processes build it once. Its digest covers the ``.cpp``
sources, the flags and the compiler with its version and the machine type
(a library built on another host is never loaded), and the CUDA digest the
``.cu`` and ``.cuh`` files only, so neither kind rebuilds the other.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deco_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HOST_COMPILERS = ("c++", "g++", "clang++")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (searched PATH and CUDA_HOME): the port's CUDA "
        "kernels are built from source and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):  # the .cu and any shared .cuh
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def host_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else the first of
    :data:`HOST_COMPILERS` on ``PATH`` (``nvcc`` needs one of them too)."""
    for name in (os.environ.get("CXX"), *HOST_COMPILERS):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        "no host C++ compiler found (searched $CXX and " + ", ".join(HOST_COMPILERS)
        + " on PATH): the port's host sources (csrc/*.cpp, the JPEG decoder) are built "
        "from source and need one"
    )


@functools.lru_cache(maxsize=None)
def _compiler_identity(compiler: str) -> str:
    """``compiler``, the first line of its ``--version`` and the machine type."""
    out = subprocess.run([compiler, "--version"], capture_output=True, text=True).stdout
    return " ".join([compiler, *out.splitlines()[:1], platform.machine()])


def host_library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    digest.update(_compiler_identity(host_compiler()).encode())
    for path in sorted(CSRC.glob("*.cpp")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str) -> float:
    """Compile ``csrc/<name>.cpp`` with the host compiler unless it is
    built; returns the seconds the build took (0.0 if it was built). The
    compiler's output is kept as ``<name>.log``."""
    src = CSRC / f"{name}.cpp"
    if not src.is_file():
        raise FileNotFoundError(f"no host source {src}")
    target = host_library_path(name)
    if target.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if target.exists():
            return 0.0
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [host_compiler(), *HOST_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cmd[0]} failed for {name} (exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, target)
        return time.perf_counter() - t0


def build(names=None) -> dict[str, float]:
    """Compile ``names`` (default: every source) concurrently.

    Returns the seconds each build took (0.0 for one already built). The
    compiler's report (registers, shared memory, spills) is kept beside each
    library as ``<name>.log``.
    """
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return seconds
    nvcc = _nvcc()
    started = {}
    for name in todo:
        src = CSRC / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"no kernel source {src}")
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, time.perf_counter())
    failures = []
    for name, (proc, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cpp`` (host code) or
    ``csrc/<name>.cu``, built if missing."""
    lib = _loaded.get(name)
    if lib is None:
        if (CSRC / f"{name}.cpp").is_file():
            build_host(name)
            path = host_library_path(name)
        else:
            path = library_path(name)
            if not path.exists():
                build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, stack frame, spill stores and loads and static shared
    memory (bytes) of each entry function (mangled name) in a build log."""
    report, current = {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            current = report.setdefault(m[1], {})
        elif current is not None and (m := _FRAME.search(line)):
            current.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                           spill_load_bytes=int(m[3]))
        elif current is not None and (m := _USED.search(line)):
            current.update(registers=int(m[1]), static_smem=int(m[2] or 0))
    return report


INFO_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem", "ctas_per_sm", "threads")


def kernel_info(name: str, symbol: str, *args: int) -> dict:
    """What the current card makes of one kernel of ``csrc/<name>.cu``:
    the C entry ``symbol(*args, int out[6])`` fills :data:`INFO_KEYS` from
    the CUDA runtime (registers, local bytes, static and dynamic shared
    memory, resident CTAs per SM, threads)."""
    lib = load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(INFO_KEYS))()
    check(lib, fn(*args, out), f"{symbol}{args}")
    return dict(zip(INFO_KEYS, out))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error code."""
    if err != 0:
        lib.deco_cuda_error_string.restype = ctypes.c_char_p
        lib.deco_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.deco_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
