"""Build and load the port's CUDA kernels.

``load(name)`` compiles ``csrc/<name>.cu`` with one ``nvcc`` command for
``sm_90a`` into a shared library with a plain C interface, at first use, into
``build/hm_vae_torch_kernels/`` beside the package, and loads it with
``ctypes``.  ``load_all(names)`` starts the ``nvcc`` of every missing library
at once and waits for them together.  ``load_host(name)`` compiles a header
of plain C++ (``csrc/<name>.h``) alone with ``g++``, for the CPU.  A
library's file name carries a hash of its source, the headers of ``csrc/``
and its flags, so an edited source or header is rebuilt.

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
from typing import List, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hm_vae_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str, suffix: str = ".cu", flags: Sequence[str] = NVCC_FLAGS) -> Path:
    # the headers of csrc/ count as part of every source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.h")))
    digest = hashlib.sha256((CSRC_DIR / f"{name}{suffix}").read_bytes() + headers
                            + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_all(names: Sequence[str]) -> List[ctypes.CDLL]:
    """The libraries of ``csrc/<name>.cu`` for each name, the missing ones
    compiled first, all at once.

    Every library exports ``hmvae_error_string(int) -> const char*``.
    """
    with _lock:
        jobs = []
        for name in names:
            target = _target(name)
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                src = CSRC_DIR / f"{name}.cu"
                jobs.append((src, tmp, target, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, tmp, target, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name}:\n{out}{err}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))
    libs = []
    for name in names:
        lib = ctypes.CDLL(str(_target(name)))
        lib.hmvae_error_string.argtypes = [ctypes.c_int]
        lib.hmvae_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    return libs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, compiled first if it is missing."""
    return load_all([name])[0]


def load_host(name: str) -> ctypes.CDLL:
    """The host library of ``csrc/<name>.h``, a header of plain C++ that a
    CUDA source includes, compiled alone by ``g++`` at first use: the part
    of a launcher that the CPU can run (a launch plan)."""
    with _lock:
        target = _target(name, ".h", HOST_FLAGS)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            src = CSRC_DIR / f"{name}.h"
            proc = subprocess.run(["g++", *HOST_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {name}.h:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
    return ctypes.CDLL(str(target))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.hmvae_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
