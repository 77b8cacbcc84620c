"""Build the CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface, at first use, into `mlprobs_tpu_torch/_build/kernels`
(listed in .gitignore).  The library's file name carries a hash of its
source and flags, so an edited source builds anew.  `build_all` starts one
nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build" / "kernels"
KERNELS = ("sweep", "combine")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel failed to compile or load."""


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                     / "bin" / "nvcc"),
                 shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or NVCC): the CUDA kernels build "
        "only where the CUDA toolkit is installed"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    rc = proc.wait()
    log = (BUILD_DIR / f"{name}.log").read_text()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file


def build_all(names=KERNELS) -> dict:
    """Build every kernel that is not built yet, one nvcc each, in
    parallel.  Returns {"seconds": wall time, "logs": {name: nvcc output}}."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        _finish(n, job)
    logs = {}
    for n in names:
        log = BUILD_DIR / f"{n}.log"
        logs[n] = log.read_text() if log.exists() else ""
    return {"seconds": time.perf_counter() - t0, "logs": logs}


_ARGTYPES = {
    "sweep": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
              + [ctypes.c_void_p] * 4),
    "combine": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                + [ctypes.c_float] + [ctypes.c_void_p] * 6),
}


@functools.lru_cache(maxsize=None)
def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; raises
    KernelBuildError when it cannot be built or loaded."""
    _finish(name, _start(name))
    try:
        handle = ctypes.CDLL(str(_target(name)))
    except OSError as e:
        raise KernelBuildError(f"cannot load {name} kernel: {e}") from e
    fn = getattr(handle, f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return handle
