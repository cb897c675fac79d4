"""Build the kernels' CUDA sources at first use and load them.

Each ``csrc/*.cu`` compiles on its own, with a plain C interface, into
a shared library under ``build/kernels/`` at the repository root, named
by a hash of its source and flags so an edited kernel rebuilds.  A
measurement may build another checkout's source beside them under a
label of its own.  All missing libraries build in parallel, one
``nvcc`` per source.  The libraries load with ctypes; nothing here
includes PyTorch's headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
SOURCES = {
    "spmv_ell": _KERNELS / "spmv" / "csrc" / "spmv_ell.cu",
    "bfs_pull": _KERNELS / "frontier" / "csrc" / "bfs_pull.cu",
    "flash_attention_fwd": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention_fwd.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(label: str, src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{label}-{digest}.so"


def library_path(name: str) -> Path:
    return _target(name, SOURCES[name])


def build_all(extra=()) -> dict[str, str]:
    """Compile every kernel whose library is missing, all at once, and
    with them each ``(label, source)`` of ``extra`` (another checkout's
    source, for a measurement).  Returns each build's compiler log
    (``-Xptxas -v``: registers, shared memory, spills) by kernel name or
    label; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {name: (library_path(name), src) for name, src in SOURCES.items()}
    for label, src in extra:
        jobs[label] = (_target(label, Path(src)), Path(src))
    procs = {}
    for label, (out, src) in jobs.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[label] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for label, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{label} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    logs = {}
    for label, (out, _) in jobs.items():
        log = out.with_suffix(".log")
        logs[label] = log.read_text() if log.exists() else ""
    return logs


def load(name: str, src=None) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (or of the build labelled
    ``name`` of ``src``), built first if missing."""
    path = library_path(name) if src is None else _target(name, Path(src))
    lib = _loaded.get(str(path))
    if lib is None:
        if not path.exists():
            build_all(() if src is None else ((name, src),))
        lib = _loaded[str(path)] = ctypes.CDLL(str(path))
    return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code:
        err = getattr(lib, f"{prefix}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {code} "
                           f"({err(code).decode()})")
