"""Build and load the port's CUDA kernels.

``load(name)`` compiles ``csrc/<name>.cu`` with one ``nvcc`` command for
``sm_90a`` into a shared library with a plain C interface, at first use, into
``build/hm_vae_torch_kernels/`` beside the package, and loads it with
``ctypes``.  A library's file name carries a hash of its source and flags, so
an edited source is rebuilt.

Nothing here runs at import: the CPU tests import every module of the port,
and a machine without a GPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hm_vae_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, compiled first if it is missing.

    Every library exports ``hmvae_error_string(int) -> const char*``.
    """
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    with _lock:
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    lib.hmvae_error_string.argtypes = [ctypes.c_int]
    lib.hmvae_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.hmvae_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
