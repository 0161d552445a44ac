"""Build the port's CUDA kernels with plain `nvcc`, and the host library
of the demo's detail masks with `g++`, and load them with ctypes.

Each `csrc/<name>.cu` exposes `extern "C"` launchers that return a
cudaError_t.  It is compiled at first use, for sm_90a, into a shared
library under `build/decnet_tpu_torch/` at the root of the checkout (listed
in .gitignore).  The host libraries are compiled by g++ for this host's
baseline instruction set: `decnet_native` is `csrc/host/decnet_native.cc`
(the port's own copy of the JAX package's `native/decnet_native.cc`,
which it neither builds nor loads), `png_unfilter` is
`csrc/host/png_unfilter.cc`, `jpeg_decode` is `csrc/host/jpeg_decode.cc`.
Every source compiled here lies under `decnet_tpu_torch/`.  A library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and a stale library never loads.  Nothing here touches PyTorch's C++
headers: a build takes seconds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "decnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_LIB = "decnet_native"
PNG_LIB = "png_unfilter"
JPEG_LIB = "jpeg_decode"
HOST_SOURCES = {HOST_LIB: CSRC_DIR / "host" / "decnet_native.cc",
                PNG_LIB: CSRC_DIR / "host" / "png_unfilter.cc",
                JPEG_LIB: CSRC_DIR / "host" / "jpeg_decode.cc"}
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

# Loaded libraries by kernel name: loading is idempotent and a process
# never unloads a shared library, so one handle per name is kept.  The
# loader's worker threads may all reach a host library first at once: the
# lock lets one of them build it.
_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def gxx_path() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host libraries (detail masks, "
                           "PNG unfiltering, JPEG decoding) are built at "
                           "first use")
    return found


def _source(name: str) -> Path:
    return HOST_SOURCES.get(name, CSRC_DIR / f"{name}.cu")


def _command(name: str, out: Path) -> List[str]:
    if name in HOST_SOURCES:
        return [gxx_path(), *HOST_FLAGS, "-o", str(out), str(_source(name))]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, the headers of
    csrc/ it may include, and the flags."""
    h = hashlib.sha1(_source(name).read_bytes())
    if name in HOST_SOURCES:
        h.update(" ".join(HOST_FLAGS).encode())
    else:
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> List[BuildResult]:
    """Compile every named library that is not built yet, one compiler
    process per source, all started together.  Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, procs = [], []
    for name in names:
        out = library_path(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, ""))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (rc {proc.returncode}) ---\n"
                            f"{log}")
            continue
        os.replace(tmp, out)
        results.append(BuildResult(name, out, seconds, log))
    if failures:
        raise RuntimeError("build failed:\n" + "\n".join(failures))
    return results


def load(name: str, signatures: Dict[str, list],
         restype=ctypes.c_int) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed.

    `signatures` maps each function to its ctypes argument types; each
    of them returns `restype` (the kernels' launchers a C int, a
    cudaError_t).  They are set on every call, so callers of different
    functions of one library may declare only their own."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            (res,) = build([name])
            lib = ctypes.CDLL(str(res.path))
            _LOADED[name] = lib
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib
