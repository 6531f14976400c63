"""ctypes bindings for the native C++ window sampler (``hm_vae_torch/native/loader.cpp``).

Port of ``hm_vae_tpu.data.native_loader``: the same C++ source (a verbatim
copy), built the same way (``g++ -O3 -march=native -shared -fPIC``), seeded
the same way (``(seed << 20) + counter``), so the same data and seed give the
same windows as the JAX package's loader.  :class:`NativeMotionLoader`
samples whole batches (the 7-field contract), compact batches on one wire
(``rotmat``, ``rot6d`` or ``aa``, with ``root_v`` where asked), and
double-buffered superbatch streams for several steps a call.

The library is built at first use into ``build/native_loader/`` beside the
package, its file name keyed by a hash of the source, the flags and the
host's CPU (a ``-march=native`` binary must not run on another
microarchitecture).  **No fallback**: where the JAX package samples with numpy
after a failed build (with a warning), here a failed build raises with the
compiler's error; ``use_native_loader: false`` opts out of the native
sampler.

The streams fill host buffers in a background thread while the caller uses
the previous ones.  With ``pin_memory`` the buffers are pinned, so that the
caller's copy to the device can be asynchronous; the caller then hands the
copy's CUDA event to :meth:`BufferStream.copy_done`, and the buffer is not
refilled before that event has completed.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from . import layout

SOURCE = Path(__file__).resolve().parents[1] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native_loader"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _cpu_key() -> str:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return hashlib.sha1(f.read()).hexdigest()[:12]
    except OSError:
        return "nocpuinfo"


def library_path() -> Path:
    """Where the library of this source, these flags and this CPU lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmotion_loader-{digest.hexdigest()[:16]}-{_cpu_key()}.so"


def build_library() -> Path:
    """The library, compiled first if it is missing.  Raises with the
    compiler's error if the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native loader's build ({' '.join(cmd)}) could not start: {e}; "
                           "set use_native_loader: false to sample with numpy") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the native loader's build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}\n"
                           "set use_native_loader: false to sample with numpy")
    os.replace(tmp, target)
    return target


def get_library() -> ctypes.CDLL:
    """The loaded library with its entry points typed, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
    f, i, i64, u64 = (ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint64)
    vp = ctypes.c_void_p
    lib.ml_open.restype = vp
    lib.ml_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, f, f, i64]
    lib.ml_num_seqs.restype = i64
    lib.ml_num_seqs.argtypes = [vp]
    lib.ml_sample_fields_mt.argtypes = [vp, i, i, u64, i] + [f] * 7 + [i]
    lib.ml_sample_compact_slice_mt.argtypes = [vp, i, i, u64, i, f, f, i, i64, i64]
    lib.ml_sample_compact_aa_mt.argtypes = [vp, i, i, u64, i, f, f, i]
    lib.ml_start_prefetch.argtypes = [vp, i, i, i, i, u64, i]
    lib.ml_next_batch.argtypes = [vp, f, f]
    lib.ml_close.argtypes = [vp]
    with _lock:
        _lib = lib
    return lib


def _fptr(a: np.ndarray):
    if a.dtype != np.float32 or not a.flags.c_contiguous:
        raise ValueError("the native loader writes contiguous float32 buffers")
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def host_buffer(shape, dtype=np.float32, pin_memory: bool = False) -> np.ndarray:
    """An uninitialised host array; page-locked (through torch) with
    ``pin_memory``, so that a copy from it to a GPU can be asynchronous."""
    if not pin_memory:
        return np.empty(shape, dtype)
    import torch

    tdt = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16}
    return torch.empty(tuple(shape), dtype=tdt[np.dtype(dtype)], pin_memory=True).numpy()


def _fields(B: int, L: int, alloc=np.empty) -> Dict[str, np.ndarray]:
    return {
        "rot_6d": alloc((B, L, 24, 6), np.float32),
        "rot_mat": alloc((B, L, 24, 3, 3), np.float32),
        "rot_pos": alloc((B, L, 24, 3), np.float32),
        "joint_pos": alloc((B, L, 24, 3), np.float32),
        "linear_v": alloc((B, L, 24, 3), np.float32),
        "angular_v": alloc((B, L, 24, 3), np.float32),
        "root_v": alloc((B, L, 3), np.float32),
    }


class BufferStream:
    """Double-buffered stream of host batches: ``fill(i)`` writes slot i's
    buffers (``slots[i]``) in a background thread while the caller reads
    the other slot.  ``view`` shapes what the caller sees (the (K, B, ...)
    superbatch of a flat (K*B, ...) fill).  A slot handed out is refilled
    only after the caller's next ``next()`` and after the event passed to
    :meth:`copy_done` for it, if any, has completed."""

    def __init__(self, slots, fill: Callable[[int], None],
                 view: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]):
        self.slots, self._fill, self._view = slots, fill, view
        self._events = [None, None]
        self._thread: Optional[threading.Thread] = None
        self._slot = None
        self._error: Optional[BaseException] = None

    def _run(self, slot: int) -> None:
        try:
            ev = self._events[slot]
            if ev is not None:
                ev.synchronize()  # the slot's copy to the device has landed
                self._events[slot] = None
            self._fill(slot)
        except BaseException as e:  # re-raised by the next next()
            self._error = e

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._slot is None:
            self._fill(0)
            self._slot = 0
        else:
            self._join()
            self._slot = 1 - self._slot
        nxt = 1 - self._slot
        self._thread = threading.Thread(target=self._run, args=(nxt,), daemon=True)
        self._thread.start()
        return self._view(self.slots[self._slot])

    def copy_done(self, event) -> None:
        """The CUDA event after which the slot last handed out may be
        refilled (its asynchronous copy to the device)."""
        self._events[self._slot] = event

    def close(self) -> None:
        """Join the background fill and raise its error, if it failed."""
        self._join()


class NativeMotionLoader:
    """Window sampler backed by the C++ library, with the
    :class:`~hm_vae_torch.data.dataset.MotionDataset` batch contract."""

    def __init__(self, seq_dir: str, index_json: str, mean_std: np.ndarray,
                 train_seq_len: int, fps_aug: bool = False, seed: int = 0):
        self.lib = get_library()
        with open(index_json) as f:
            ids = json.load(f)
        names = [ids[k] for k in sorted(ids, key=int)]
        paths = [os.path.join(seq_dir, n).encode() for n in names]
        arr = (ctypes.c_char_p * len(paths))(*paths)
        mean = np.ascontiguousarray(mean_std[0], np.float32)
        std = np.ascontiguousarray(mean_std[1], np.float32)
        self.handle = self.lib.ml_open(arr, len(paths), _fptr(mean), _fptr(std),
                                       layout.FRAME_DIM)
        if not self.handle:
            raise RuntimeError(f"the native loader could not read the sequences of {index_json}")
        # the stats as MotionDataset keeps them (a zero std read as 1)
        self.mean, self.std = mean, np.where(std == 0, np.float32(1), std)
        self.train_seq_len = train_seq_len
        self.fps_aug = fps_aug
        self.seed = seed
        self._counter = 0
        self._prefetching = False

    def __len__(self) -> int:
        return int(self.lib.ml_num_seqs(self.handle))

    def _next_seed(self) -> int:
        self._counter += 1
        return (self.seed << 20) + self._counter

    def _fill_fields(self, out: Dict[str, np.ndarray], threads: int) -> None:
        B = out["rot_6d"].shape[0]
        self.lib.ml_sample_fields_mt(
            self.handle, B, self.train_seq_len, self._next_seed(), int(self.fps_aug),
            *(_fptr(out[k]) for k in layout.BATCH_FIELDS), threads)

    def sample_batch(self, batch_size: int, threads: int = 1) -> Dict[str, np.ndarray]:
        """One batch of the 7 fields, written by C++ into fresh buffers."""
        out = _fields(batch_size, self.train_seq_len)
        self._fill_fields(out, threads)
        return out

    def sample_superbatch(self, k: int, batch_size: int,
                          threads: int = 8) -> Dict[str, np.ndarray]:
        """(K, B, ...) stacked batches, filled by a thread team in one call."""
        flat = self.sample_batch(k * batch_size, threads=threads)
        return {key: v.reshape((k, batch_size) + v.shape[1:]) for key, v in flat.items()}

    def alloc_compact(self, B: int, need_root_v: bool, wire: str,
                      pin_memory: bool = False) -> Dict[str, np.ndarray]:
        """Host buffers of a compact batch on ``wire``."""
        L = self.train_seq_len
        shape = {"aa": ("aa", (24, 3)), "rot6d": ("rot_6d", (24, 6)),
                 "rotmat": ("rot_mat", (24, 3, 3))}
        if wire not in shape:
            raise ValueError(f"unknown wire_format {wire!r} (rotmat | rot6d | aa)")
        key, tail = shape[wire]
        out = {key: host_buffer((B, L) + tail, pin_memory=pin_memory)}
        if need_root_v:
            out["root_v"] = host_buffer((B, L, 3), pin_memory=pin_memory)
        return out

    def sample_compact(self, batch_size: int, need_root_v: bool = False, threads: int = 8,
                       out: Optional[Dict[str, np.ndarray]] = None,
                       wire: str = "rotmat") -> Dict[str, np.ndarray]:
        """A minimal-transfer batch: the rotations on one wire (``rotmat``
        (B, L, 24, 3, 3), ``rot6d`` (B, L, 24, 6), or ``aa`` (B, L, 24, 3),
        from a sidecar the C++ side builds once by a robust SO(3) log map),
        and ``root_v`` with ``need_root_v``.  ``out`` reuses buffers."""
        B = batch_size
        if out is None:
            out = self.alloc_compact(B, need_root_v, wire)
        rv = out.get("root_v")
        rvp = _fptr(rv) if rv is not None else ctypes.POINTER(ctypes.c_float)()
        seed = self._next_seed()
        if wire == "aa":
            self.lib.ml_sample_compact_aa_mt(self.handle, B, self.train_seq_len, seed,
                                             int(self.fps_aug), _fptr(out["aa"]), rvp, threads)
            return out
        key, (off, width) = (("rot_6d", (layout.ROT6D.start, layout.ROT6D_DIM))
                             if wire == "rot6d" else
                             ("rot_mat", (layout.ROTMAT.start, layout.ROTMAT_DIM)))
        self.lib.ml_sample_compact_slice_mt(self.handle, B, self.train_seq_len, seed,
                                            int(self.fps_aug), _fptr(out[key]), rvp, threads,
                                            off, width)
        return out

    @staticmethod
    def _superbatch_view(k: int, batch_size: int):
        """A slot's last buffer set (what is sent) as (K, B, ...)."""
        def view(bufs):
            return {key: v.reshape((k, batch_size) + v.shape[1:])
                    for key, v in bufs[-1].items()}
        return view

    def iter_compact_superbatches(self, k: int, batch_size: int, need_root_v: bool = False,
                                  threads: int = 8, wire: str = "rotmat",
                                  dtype=np.float32, pin_memory: bool = False) -> BufferStream:
        """Double-buffered compact (K, B, ...) superbatch stream in
        ``dtype`` (float32, or float16 converted on the host after the
        fill: the f16 wire)."""
        B = k * batch_size
        f16 = np.dtype(dtype) == np.float16
        slots = []
        for _ in range(2):
            raw = self.alloc_compact(B, need_root_v, wire, pin_memory and not f16)
            wire_bufs = ({key: host_buffer(v.shape, np.float16, pin_memory)
                          for key, v in raw.items()} if f16 else raw)
            slots.append((raw, wire_bufs))

        def fill(slot):
            raw, wire_bufs = slots[slot]
            self.sample_compact(B, need_root_v, threads, out=raw, wire=wire)
            if f16:
                for key, v in raw.items():
                    np.copyto(wire_bufs[key], v, casting="same_kind")

        return BufferStream(slots, fill, self._superbatch_view(k, batch_size))

    def iter_superbatches(self, k: int, batch_size: int, threads: int = 8,
                          pin_memory: bool = False) -> BufferStream:
        """Double-buffered (K, B, ...) superbatch stream of the 7 fields."""
        B = k * batch_size
        slots = [(_fields(B, self.train_seq_len,
                          lambda s, d: host_buffer(s, d, pin_memory)),) for _ in range(2)]
        return BufferStream(slots, lambda slot: self._fill_fields(slots[slot][0], threads),
                            self._superbatch_view(k, batch_size))

    def start_prefetch(self, batch_size: int, depth: int = 4, threads: int = 2) -> None:
        """Start the C++ thread pool that fills a bounded queue of batches."""
        self.lib.ml_start_prefetch(self.handle, batch_size, self.train_seq_len, depth, threads,
                                   self.seed + 1, int(self.fps_aug))
        self._prefetching = True
        self._pf_batch = batch_size

    def next_batch(self) -> Dict[str, np.ndarray]:
        if not self._prefetching:
            raise RuntimeError("start_prefetch first")
        L, D = self.train_seq_len, layout.FRAME_DIM
        raw = np.empty((self._pf_batch, L, D), np.float32)
        norm = np.empty((self._pf_batch, L, D), np.float32)
        self.lib.ml_next_batch(self.handle, _fptr(raw), _fptr(norm))
        B, T = raw.shape[:2]
        return {
            "rot_6d": raw[..., layout.ROT6D].reshape(B, T, 24, 6),
            "rot_mat": raw[..., layout.ROTMAT].reshape(B, T, 24, 3, 3),
            "rot_pos": raw[..., layout.COORD].reshape(B, T, 24, 3),
            "joint_pos": norm[..., layout.COORD].reshape(B, T, 24, 3),
            "linear_v": norm[..., layout.LINEAR_V].reshape(B, T, 24, 3),
            "angular_v": norm[..., layout.ANGULAR_V].reshape(B, T, 24, 3),
            "root_v": norm[..., layout.ROOT_V],
        }

    def iter_batches(self, batch_size: int):
        """Batches from the C++ prefetch pool (started on first use)."""
        if not self._prefetching:
            self.start_prefetch(batch_size)
        while True:
            yield self.next_batch()

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.ml_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
