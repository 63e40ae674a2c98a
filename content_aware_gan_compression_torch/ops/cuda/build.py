"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` into its own shared library
with a plain C interface, for Hopper (``sm_90a``), and loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Libraries
go to ``build/cuda/`` beside the package. A failed build raises: there is no
fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
SOURCES = ("blur4", "fused_noise_bias_lrelu", "masked_scale")
# -Xptxas -v writes each kernel's registers and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the CUDA "
            "kernels are built from csrc/ at first use and need the toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives at its current hash."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is missing, one ``nvcc`` per
    source, all started together. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log_path = out.with_suffix(".log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, out, log_path))
    failed = []
    for name, proc, tmp, out, log_path in running:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log_path.read_text()[-4000:]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def build_log(name: str) -> str:
    """The nvcc output (ptxas register/spill report) of the current build."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build((name,))[name]))
        return _libs[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")
