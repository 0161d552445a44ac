"""Build the port's CUDA kernels with plain `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` exposes `extern "C"` launchers that return a
cudaError_t.  It is compiled at first use, for sm_90a, into a shared
library under `build/decnet_tpu_torch/` at the root of the checkout (listed
in .gitignore).  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library never loads.
Nothing here touches PyTorch's C++ headers: a build takes seconds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "decnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Loaded libraries by kernel name: loading is idempotent and a process
# never unloads a shared library, so one handle per name is kept.
_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float      # 0.0 when the library was already built
    ptxas: str          # the `-Xptxas -v` report (registers, smem, spills)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> List[BuildResult]:
    """Compile every named kernel that is not built yet, one `nvcc` process
    per source, all started together.  Raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, procs = [], []
    for name in names:
        out = library_path(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, ""))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n"
                            f"{log}")
            continue
        os.replace(tmp, out)
        results.append(BuildResult(name, out, seconds, log))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed.

    `signatures` maps each launcher to its ctypes argument types; every
    launcher returns a C int (a cudaError_t)."""
    lib = _LOADED.get(name)
    if lib is None:
        (res,) = build([name])
        lib = ctypes.CDLL(str(res.path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
