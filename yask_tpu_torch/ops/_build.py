"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each emitted kernel source is written, with the hand-written headers of
``yask_tpu_torch/csrc``, into a build directory that ``.gitignore`` lists,
and compiled at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \\
         -shared -Xcompiler -fPIC -I csrc -o <name>_<hash>.so <name>_<hash>.cu

``--fmad=false`` keeps nvcc from contracting a multiply and an add into one
FMA, so the kernel rounds exactly where its plain version (eager PyTorch,
one rounding per op) and the numpy oracle do: on the card it agrees with
both to the bit for solutions without transcendental functions.  The
kernels are bound by bytes, so the few instructions an FMA would save do
not show.

The library name carries a hash of the source, the headers and the flags,
so a changed kernel never loads a stale build.  The library has a plain C
interface (no PyTorch headers, seconds to compile); the wrapper binds it
with ctypes.  A missing ``nvcc`` or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

from yask_tpu_torch.utils.exceptions import YaskException

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise YaskException(
            "nvcc not found (PATH or /usr/local/cuda/bin): the fused CUDA "
            "kernels are built from source at first use")
    return path


def _headers_digest() -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(fn.encode() + f.read())
    return h.hexdigest()


def library_path(name: str, source: str) -> str:
    key = hashlib.sha256((source + _headers_digest() + " ".join(NVCC_FLAGS))
                         .encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{key}.so")


def build_many(kernels: Sequence[Tuple[str, str]], ptxas_info: bool = False
               ) -> Tuple[List[str], Dict[str, str]]:
    """Compile every ``(name, source)`` not built yet, one ``nvcc`` each,
    all started together.  Returns the library paths and, per compiled
    name, nvcc's output (``-Xptxas -v`` register/shared-memory/spill
    report when ``ptxas_info``)."""
    return ([library_path(name, source) for name, source in kernels],
            wait_builds(start_builds(kernels, ptxas_info)))


def start_builds(kernels: Sequence[Tuple[str, str]],
                 ptxas_info: bool = False) -> List[tuple]:
    """Start one ``nvcc`` for every ``(name, source)`` not built yet (each
    name once) and return the running builds, for :func:`wait_builds`,
    so that a caller can go on while they compile."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    flags = tuple(NVCC_FLAGS) + (("-Xptxas", "-v") if ptxas_info else ())
    procs = []
    for name, source in dict(kernels).items():
        so = library_path(name, source)
        if os.path.exists(so):
            continue
        cu = so[:-3] + ".cu"
        with open(cu, "w") as f:
            f.write(source)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *flags, "-I", CSRC, "-o", tmp, cu]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def wait_builds(procs: List[tuple]) -> Dict[str, str]:
    """Wait for the builds :func:`start_builds` started; returns nvcc's
    output per compiled name and raises if any failed."""
    logs: Dict[str, str] = {}
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out[-4000:]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise YaskException("kernel build failed:\n" + "\n".join(failed))
    return logs


def build_and_load(name: str, source: str) -> Tuple[ctypes.CDLL, float]:
    """Build (if needed) and load one kernel library; returns it with the
    seconds spent building (0 when it was already built)."""
    t0 = time.perf_counter()
    (path,), _ = build_many([(name, source)])
    return ctypes.CDLL(path), time.perf_counter() - t0
