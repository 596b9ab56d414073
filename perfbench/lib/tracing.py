"""The device trace of one unit of work, reduced to what the per-layer
metrics and the result's breakdown read.

The unit runs inside torch.profiler with CPU and CUDA activity.  Its raw
kineto events are read once (prof.profiler.kineto_results.events(): a
Python object per event from prof.events() is far slower at a million
events) into arrays: the device's operations (kernels, copies, fills;
not the annotations the harness's record_function spans leave on the
device's timeline) and the host's operations.  The program runs on one
host thread, so the host's operations nest.
"""

from __future__ import annotations

import re
import sys
import time

import numpy as np

_QUALIFIER = re.compile(r"(?:\(anonymous namespace\)|\w+)::")


def short_name(name: str) -> str:
    """A kernel's name without "void", namespace qualifiers, template and
    parameter lists, cut to 120 characters."""
    if name.startswith("void "):
        name = name[5:]
    for open_, close in (("(", ")"), ("<", ">")):
        if name.endswith(close):
            depth = 0
            for i in range(len(name) - 1, -1, -1):
                depth += {close: 1, open_: -1}.get(name[i], 0)
                if depth == 0:
                    name = name[:i]
                    break
    return _QUALIFIER.sub("", name)[:120]


def _merged(start, dur):
    """The union of intervals [start, start + dur) as sorted disjoint
    (starts, ends)."""
    o = np.argsort(start, kind="stable")
    s, e = start[o], start[o] + dur[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


class Trace:
    """Device and host events of a traced window of window_s seconds.
    Names are ids into `names`; times in ns."""

    def __init__(self, names, dev, host, window_s):
        self.names = names
        self.dev_name, self.dev_start, self.dev_dur = dev
        self.host_name, self.host_start, self.host_dur = host
        self.window_s = window_s

    @property
    def n_device_ops(self) -> int:
        return len(self.dev_name)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        operations' intervals."""
        if not len(self.dev_start):
            return 0.0
        s, e = _merged(self.dev_start, self.dev_dur)
        return float((e - s).sum()) * 1e-9

    def _by_short_name(self):
        tot = np.bincount(self.dev_name, weights=self.dev_dur,
                          minlength=len(self.names))
        out = {}
        for i in np.nonzero(tot)[0]:
            k = short_name(self.names[i])
            out[k] = out.get(k, 0.0) + float(tot[i]) * 1e-9
        return out

    def kernel_seconds(self, kernels) -> float:
        """Device seconds of the kernels whose short name is in kernels."""
        by = self._by_short_name()
        return sum(by.get(k, 0.0) for k in kernels)

    def top_device_ops(self, k: int = 10):
        by = self._by_short_name()
        return [[n, by[n]] for n in sorted(by, key=by.get, reverse=True)[:k]]

    def idle_gaps(self, k: int = 10):
        """The device's idle gaps inside the traced window, summed by what
        the host was doing at each gap's middle: the outermost and the
        innermost host operation running then ("outer / inner")."""
        if len(self.dev_start) < 2:
            return []
        s, e = _merged(self.dev_start, self.dev_dur)
        mids = (e[:-1] + s[1:]) // 2
        lens = s[1:] - e[:-1]
        labels = self._host_labels(mids)
        tot = {}
        for lab, g in zip(labels, lens.tolist()):
            tot[lab] = tot.get(lab, 0) + g
        top = sorted(tot, key=tot.get, reverse=True)[:k]
        return [[n, tot[n] * 1e-9] for n in top]

    def _host_labels(self, times):
        """The label of each time from the host's nested operations, by
        parent links: the latest operation started before the time, then
        its parents until one still runs."""
        n = len(self.host_start)
        if not n:
            return ["host"] * len(times)
        o = np.lexsort((-self.host_dur, self.host_start))
        hs = self.host_start[o]
        he = hs + self.host_dur[o]
        nm = self.host_name[o]
        parent = np.full(n, -1, np.int64)
        stack = []
        hs_l, he_l = hs.tolist(), he.tolist()
        for i in range(n):
            while stack and he_l[stack[-1]] <= hs_l[i]:
                stack.pop()
            if stack:
                parent[i] = stack[-1]
            stack.append(i)
        root = np.arange(n)
        for _ in range(64):
            p = parent[root]
            if not (p >= 0).any():
                break
            root = np.where(p >= 0, p, root)
        cur = np.searchsorted(hs, times, side="right") - 1
        for _ in range(64):
            gone = (cur >= 0) & (he[np.maximum(cur, 0)] <= times)
            if not gone.any():
                break
            cur = np.where(gone, parent[np.maximum(cur, 0)], cur)
        out = []
        for c in cur.tolist():
            if c < 0:
                out.append("host, between operations")
                continue
            inner, outer = self.names[nm[c]], self.names[nm[root[c]]]
            out.append(inner if inner == outer else f"{outer} / {inner}")
        return out


def capture(fn, device):
    """Run fn() under torch.profiler (CPU and CUDA activity), synchronised
    at both ends.  Returns (fn's result, Trace).  On the CPU (the
    benchmark's tests) only host activity is recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_ = torch.device(device)
    on_card = dev_.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev_)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t2 = time.perf_counter()
    ids = {}
    dev = ([], [], [])
    host = ([], [], [])
    cuda = DeviceType.CUDA
    for ev in events:
        nm = ev.name()
        i = ids.get(nm)
        if i is None:
            i = ids[nm] = len(ids)
        if ev.device_type() == cuda:
            if ev.is_user_annotation() or nm.startswith("perfbench."):
                continue
            part = dev
        else:
            part = host
        part[0].append(i)
        part[1].append(ev.start_ns())
        part[2].append(ev.duration_ns())
    names = [None] * len(ids)
    for nm, i in ids.items():
        names[i] = nm
    arr = lambda t: tuple(np.asarray(a, np.int64) for a in t)
    trace = Trace(names, arr(dev), arr(host), window_s)
    print(f"perfbench: trace of {len(dev[0])} device and {len(host[0])} "
          f"host operations; profiler stop {t1 - t0 - window_s:.1f} s, "
          f"events {t2 - t1:.1f} s, arrays {time.perf_counter() - t2:.1f} s",
          file=sys.stderr, flush=True)
    return out, trace
