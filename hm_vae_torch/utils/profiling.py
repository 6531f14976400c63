"""Profiling and timing helpers (port of ``hm_vae_tpu.utils.profiling``).

- :class:`Timer`: a context manager whose elapsed time covers the device
  work queued inside it (it synchronises CUDA on entry and exit where CUDA
  is in use), not only its dispatch;
- :func:`trace`: a context manager around ``torch.profiler`` writing a
  Chrome / Perfetto trace (``trace.json``) under ``log_dir``;
- :func:`time_fn`: the median time of a call, by CUDA events where its
  tensors are on the card, else by the host clock.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """with Timer("step") as t: ... ; t.elapsed holds seconds."""

    def __init__(self, msg: str = "", verbose: bool = True):
        self.msg = msg
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        _sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self.start
        if self.verbose and self.msg:
            print(f"[timer] {self.msg}: {self.elapsed * 1e3:.3f} ms")
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, where CUDA is available, device
    activity) and write ``<log_dir>/trace.json``, viewable in Perfetto or
    ``chrome://tracing``.  Yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_cuda(obj) -> bool:
    if torch.is_tensor(obj):
        return obj.is_cuda
    if isinstance(obj, dict):
        return any(_on_cuda(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_on_cuda(v) for v in obj)
    return False


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> float:
    """Median time of ``fn(*args)`` in seconds over ``iters`` calls after
    ``warmup``.  Where an argument or the result is on the card, each call
    is timed by CUDA events around it, synchronised; else by the host
    clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if _on_cuda(args) or _on_cuda(out):
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return statistics.median(times)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
