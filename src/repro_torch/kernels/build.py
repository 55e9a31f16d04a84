"""Build and load the CUDA kernel library at first use.

``nvcc`` compiles each kernel source of ``csrc/`` (``frugal_update.cu``,
the dense kernel; ``frugal_scatter.cu``, the sparse event run kernel) for
``sm_90a``, one compiler process per source, all started together, and
links the objects into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library lands in ``build/repro_torch/`` at the repository root, named by a
hash of the sources and flags, so an edited source is never served by a
stale build. A failed build raises with the compiler's output.
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
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = ("frugal_update.cu", "frugal_scatter.cu")
SOURCES = KERNEL_SOURCES + ("frugal_tick.cuh",)
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
# -fmad=false: no contraction of a*b+c into an FMA anywhere (hazard 3 of
# frugal_tick.cuh); -Xptxas -v: registers and spills per instantiation,
# kept in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path          # the shared library
    log: str            # nvcc's output (ptxas register and spill lines)
    seconds: float      # compile time; 0.0 when an existing build was used


def find_nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME, else the default
    toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels build only where the toolkit is")


def _source_hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library(force: bool = False) -> BuildResult:
    """Compile the kernel library unless a build of these exact sources
    and flags exists (``force`` rebuilds anyway)."""
    return _build(NVCC_FLAGS, force)


def _build(flags, force: bool) -> BuildResult:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libfrugal_update_{_source_hash(flags)}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and not force:
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(out, log, 0.0)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{Path(src).stem}.o")
            for src in KERNEL_SOURCES]
    t0 = time.perf_counter()
    compiles = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([nvcc, *flags, "-c", "-o", str(obj),
                             str(CSRC / src)]
                            for src, obj in zip(KERNEL_SOURCES, objs))]
    steps = [(cmd, proc.communicate()[0], proc.returncode)
             for cmd, proc in compiles]
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(text for _, text, _ in steps)
    for cmd, text, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{text}")
    os.replace(tmp, out)
    log_path.write_text(log)
    return BuildResult(out, log, seconds)


_LIB: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded kernel library: every pointer
    and the stream as ``c_void_p``, the sizes as ``c_int64``, the int32
    scalars as ``c_int32``."""
    fn = lib.frugal_dense_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int32] + [ctypes.c_void_p] * 14
                   + [ctypes.c_int64] * 3 + [ctypes.c_int32] * 6
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.frugal_dense_info
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_int64] * 3
                   + [ctypes.c_int32] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    fn = lib.frugal_scatter_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int32] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int64] * 2 + [ctypes.c_int32] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with its C
    signatures declared."""
    global _LIB
    if _LIB is None:
        _LIB = _declare(ctypes.CDLL(str(build_library().path)))
    return _LIB
