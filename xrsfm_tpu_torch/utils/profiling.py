"""Tracing and device-time helpers (port of xrsfm_tpu/utils/profiling.py).

The reference's observability is wall-clock timers printed at stage ends
(Timer/TimerArray/TIMING, src/utility/timer.h:12-70; utils/timer here).
This module adds the device layer: torch.profiler traces (a Chrome trace
that Perfetto or chrome://tracing opens), named spans, and device time
measured between CUDA events.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def maybe_trace(trace_dir):
    """Wrap a block in a torch.profiler trace of the CPU and, when a GPU
    is there, CUDA activity, written as a Chrome trace into trace_dir;
    a no-op when trace_dir is empty.  Usage:

        with maybe_trace("/tmp/trace"):
            pipeline()
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(str(trace_dir), "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}", flush=True)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def device_time(fn, *args, warmup: int = 1, iters: int = 10, **kw):
    """Median seconds of ``fn(*args, **kw)``: device time between two
    CUDA events when fn returns CUDA tensors, host perf_counter time
    otherwise.  Returns (median_seconds, last_result)."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args, **kw)
    cuda = any(t.is_cuda for t in _leaves(out))
    times = []
    for _ in range(max(iters, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


@contextlib.contextmanager
def annotate(name: str):
    """Named profiler span (shows up in the torch.profiler trace)."""
    with torch.profiler.record_function(name):
        yield
