"""Build the port's CUDA kernels with nvcc, and its host runtime with g++,
and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point and compiles on first
use into `_build/lib<name>-<hash>.so`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one loads
the library already built. The host runtime, `csrc/runtime.cpp` (DTW,
signal energy, block dequantization and the grammar engine:
runtime/native.py), builds with g++ and needs no CUDA toolkit:

    g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread
        -o _build/libruntime-<hash>.so csrc/runtime.cpp

its hash covering the source, the flags and the CPU's feature flags
(-march=native ties the library to the CPU that built it).
`build()` starts one compiler per source that needs it, all at once, and
waits for them together. Nothing here runs when a module is imported: the
CPU tests import every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# the JAX package's runtime Makefile's flags; -std=c++17 (not gnu++17)
# keeps fused multiply-adds off, so the offset formats' q * d + m rounds
# twice, as the numpy path does
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")
KERNEL_SOURCES = ("flash_attention", "quant_matmul")    # csrc/<name>.cu, nvcc
HOST_SOURCES = ("runtime",)                             # csrc/<name>.cpp, g++

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def gxx_path() -> str:
    for cand in (os.environ.get("CXX", ""), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("g++ not found: the host runtime builds with g++ (set CXX)")


def _cpu_features() -> str:
    """The CPU's feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def _source(name: str) -> pathlib.Path:
    return CSRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(_source(name).read_bytes())
    if name in HOST_SOURCES:
        digest.update(" ".join(GXX_FLAGS).encode())
        digest.update(_cpu_features().encode())
    else:
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, ptxas_verbose: bool = False
          ) -> Dict[str, dict]:
    """Compile every named source (the CUDA kernels by default) whose
    library is missing, one compiler each, all started together. Returns
    {name: {"seconds", "built", "log"}}; the log holds the compiler's
    output (with ptxas_verbose, the registers, shared memory and spills of
    each CUDA kernel). Raises on a failed build."""
    names = tuple(names or KERNEL_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        lib = library_path(name)
        host = name in HOST_SOURCES
        if lib.exists() and (host or not ptxas_verbose):
            out[name] = {"seconds": 0.0, "built": False, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        if host:
            cmd = [gxx_path(), *GXX_FLAGS, "-o", str(tmp), str(_source(name))]
        else:
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
            if ptxas_verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{pathlib.Path(proc.args[0]).name} failed for "
                               f"csrc/{_source(name).name}:\n{log}")
        os.replace(tmp, lib)
        out[name] = {"seconds": time.perf_counter() - t0, "built": True, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The library `name` (a CUDA kernel source or the host runtime),
    built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
