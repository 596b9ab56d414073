"""Tracing and device-time helpers (port of xrsfm_tpu/utils/profiling.py).

The reference's observability is wall-clock timers printed at stage ends
(Timer/TimerArray/TIMING, src/utility/timer.h:12-70).  Here every phase
of the program opens a `span`: a named range on torch.profiler's clock
that also keeps its own host seconds, which the mapper's MapperStats and
the pipelines' stats read.  Besides: torch.profiler traces (a Chrome
trace that Perfetto or chrome://tracing opens), device time measured
between CUDA events, and counts of device operations and host fetches.
"""

from __future__ import annotations

import collections
import contextlib
import os
import re
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


try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # a torch without it: the user-scope range
    _Range = torch.autograd.profiler.record_function

_profiling = torch.autograd._profiler_enabled


class span:
    """A named phase of the program: `with span("xrsfm.mapper.lba") as s:`.

    While a torch.profiler profile runs, the block is a host event named
    `name` in the same trace as the device's kernels, copies and runtime
    calls; spans nest by the call stack.  The range is torch's
    _RecordFunctionFast, which is not a user annotation, so the profiler
    puts nothing on the device's timeline for it.  Where torch lacks that
    class the range is record_function: about 10 us a span, and a user
    annotation that the profiler also copies onto the device's timeline.

    s.seconds holds the block's host seconds (time.perf_counter) once it
    exits.  A span never synchronises: what the device did inside it is
    read from a trace.  With no profiler running a span costs two clock
    reads and a check, under a microsecond; there is no switch."""

    __slots__ = ("name", "seconds", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = _Range(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False


# CUDA runtime calls that make the host wait for the device without a
# copy (torch.profiler's names under torch 2.11 + CUDA 12.8, on an H100).
# A fetch of a tensor's value (.item(), .cpu(), bool(), nonzero) shows as
# a device event "Memcpy DtoH (Device -> Pageable|Pinned)" with its
# runtime pair cudaMemcpyAsync + cudaStreamSynchronize, and is counted
# once, by the copy.
_SYNC_CALLS = frozenset({"cudaDeviceSynchronize", "cudaEventSynchronize"})
_QUALIFIER = re.compile(r"(?:\(anonymous namespace\)|\w+)::")


def _short_name(name: str) -> str:
    """A kernel's name without "void", namespace qualifiers and its
    parameter list, cut to 160 characters."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return _QUALIFIER.sub("", name)[:160]


@contextlib.contextmanager
def dispatch_counter(device):
    """Count what a block asks of a CUDA device, from torch.profiler (the
    port's counterpart of the JAX package's install_dispatch_counter,
    which counts jit calls and device_get fetches).  Yields a dict that
    is filled when the block ends:

      dispatches  device operations: kernels, copies and fills (every
                  profiler event on the CUDA device);
      fetches     device-to-host copies (device events "Memcpy DtoH ...")
                  and explicit synchronisations (runtime events
                  cudaDeviceSynchronize, cudaEventSynchronize), less the
                  two of the counter's own: its closing synchronise and
                  the cudaDeviceSynchronize of the profiler itself;
      by_name     collections.Counter of kernel launches by short name
                  (copies and fills left out).

    On the CPU the block runs unprofiled and all three stay None.  The
    profiler slows the block (4x to 8x for the image pipeline's stages on
    an H100), so time only uncounted runs.

    Count in a fresh process, or in the first profile of one.  On an H100
    under torch 2.11 (CUPTI of CUDA 12.8) a profile loses device events
    once earlier profiles have run in the process: a row wrapper's two
    launches, counted three times after each of four 2-second profiles,
    read 2, 2, 2 / 1, 1, 1 / 1, 1, 1 / 0, 0, 0, and with 0.1 s of idle
    profile on both sides of the block 2, 2, 2 / 2, 1, 1 / 1, 1, 1 /
    0, 0, 2, so it is not the window's edge.  The same profiles put device times off the host's by
    up to 27 ms, drifting at up to 1.4% and re-synchronised every few
    seconds.  The loss is the profiler's and the counter cannot undo it;
    a single profile in a process lost nothing (every launch and copy of
    a 22-second pipeline pass after 51 seconds of work had its device
    event).  Usage:

        with dispatch_counter("cuda") as c:
            stage()
        print(c["dispatches"], c["fetches"])
    """
    dev = torch.device(device)
    out = {"dispatches": None, "fetches": None, "by_name": None}
    if dev.type != "cuda":
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        yield out
        torch.cuda.synchronize(dev)
    # the raw events: prof.events() builds a Python object for each one,
    # far slower at a million events
    dispatches, fetches, by_name = 0, -2, collections.Counter()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            dispatches += 1
            if name.startswith("Memcpy DtoH"):
                fetches += 1
            elif not name.startswith(("Memcpy", "Memset")):
                by_name[_short_name(name)] += 1
        elif name in _SYNC_CALLS:
            fetches += 1
    out.update(dispatches=dispatches, fetches=fetches, by_name=by_name)
