"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/matfac_tpu_torch/lib<name>-<hash>.so

and each ``csrc/<name>.cpp`` (host code, no kernel) by the host C++
compiler (the first of ``$CXX`` and ``g++`` that takes these flags: a
toolchain's compiler may lack OpenMP) with the flags of the JAX package's
``native/Makefile``:

    g++ -O3 -march=native -fopenmp -fPIC -std=c++17 -Wall -shared \\
        -o build/matfac_tpu_torch/lib<name>-<hash>.so

on first use, into ``build/matfac_tpu_torch/`` at the repository root. The
file name carries a hash of every source under ``csrc/`` and of the flags
(for a host library also of the compiler and of the CPU's instruction-set
flags, which ``-march=native`` reads), so an edited source is rebuilt and
a stale or foreign library is never loaded. Nothing here runs at import
time; callers build from the function that needs the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "matfac_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
              "-Wall", "-shared")
SOURCES = (".cu", ".cuh", ".h", ".cpp")

# ctypes signatures: {function: (restype, argtypes)}. Every pointer and
# the stream are c_void_p — left undeclared, ctypes would pass a Python
# int as a 32-bit C int and cut the pointer.
Signatures = Dict[str, Tuple[object, Sequence[object]]]

_loaded: Dict[str, ctypes.CDLL] = {}
_host_cxx: Dict[str, Optional[str]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build only where the CUDA toolkit is "
                       "installed")


def _builds_with_host_flags(cxx: str) -> bool:
    """Whether ``cxx`` builds an empty shared library with HOST_FLAGS: a
    toolchain may ship a compiler without OpenMP's runtime."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"probe-{os.getpid()}.so"
    try:
        return subprocess.run(
            [cxx, *HOST_FLAGS, "-x", "c++", "-", "-o", str(out)],
            input="int matfac_probe() { return 0; }\n", capture_output=True,
            text=True).returncode == 0
    finally:
        out.unlink(missing_ok=True)


def host_compiler() -> Optional[str]:
    """The host C++ compiler: the first of ``$CXX`` and ``g++`` (on PATH)
    that builds with HOST_FLAGS, else the first that exists (its build
    then fails with its output), else None."""
    if "cxx" not in _host_cxx:
        found = list(dict.fromkeys(
            p for p in (shutil.which(c) for c in (os.environ.get("CXX"),
                                                  "g++") if c) if p))
        _host_cxx["cxx"] = next(
            (c for c in found if _builds_with_host_flags(c)),
            found[0] if found else None)
    return _host_cxx["cxx"]


def _is_host(name: str) -> bool:
    return (CSRC / f"{name}.cpp").exists()


def _cpu_flags() -> bytes:
    """The CPU's instruction-set flags (Linux), which -march=native reads."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path(name: str) -> Path:
    host = _is_host(name)
    h = hashlib.sha256(" ".join(HOST_FLAGS if host else NVCC_FLAGS).encode())
    if host:
        h.update(str(host_compiler()).encode())
        h.update(_cpu_flags())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in SOURCES:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    if _is_host(name):
        cxx = host_compiler()
        if cxx is None:
            raise RuntimeError("no host C++ compiler ($CXX, g++) for "
                               f"csrc/{name}.cpp")
        return [cxx, *HOST_FLAGS, "-o", str(out), str(CSRC / f"{name}.cpp")]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` or ``.cpp`` not yet built, one
    compiler process per source, all started together; returns {name:
    library path}."""
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (cmd, tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(cmd[0])} failed with code "
                            f"{proc.returncode}:\n{' '.join(cmd)}\n"
                            f"{out}{err}")
        else:
            # atomic: a concurrent loader never sees half a file
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless its library is
    already built."""
    return build_all([name])[name]


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare signatures."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = list(argtypes)
        _loaded[name] = lib
    return lib
