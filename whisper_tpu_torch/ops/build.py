"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point and compiles on first
use into `_build/lib<name>-<hash>.so`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one loads
the library already built. `build()` starts one
nvcc per source that needs it, all at once, and waits for them together.
Nothing here runs when a module is imported: the CPU tests import every
module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
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
KERNEL_SOURCES = ("flash_attention", "quant_matmul")

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


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, ptxas_verbose: bool = False
          ) -> Dict[str, dict]:
    """Compile every named source whose library is missing, one nvcc each,
    all started together. Returns {name: {"seconds", "built", "log"}}; the
    log holds nvcc's output (with ptxas_verbose, the registers, shared
    memory and spills of each kernel). Raises on a failed build."""
    names = tuple(names or KERNEL_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists() and not ptxas_verbose:
            out[name] = {"seconds": 0.0, "built": False, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, lib)
        out[name] = {"seconds": time.perf_counter() - t0, "built": True, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
