"""The program's spans in a traced unit (lib/tracing.Trace), and what the
device and the host did inside them.

The port opens a span (xrsfm_tpu_torch/utils/profiling.span) around each
phase of its work: a host event named xrsfm.<layer>.<phase> in the same
torch.profiler trace, on the same clock, as the device's kernels, copies
and fills and the host's CUDA runtime calls.  Spans nest by the call
stack.  Here a set of spans is the union of the intervals of the host
events whose names start with given prefixes, and the readings are:

  idle seconds  the time inside the intervals in which no device
                operation ran: the intervals less the merged device
                intervals that Trace.busy_s sums;
  host waits    runtime calls inside the intervals in which the host
                blocks until the device drains (WAITS: the names
                torch.profiler gives them under torch 2.11 + CUDA 12.8 on
                an H100, where the two cells showed cudaStreamSynchronize,
                cudaEventSynchronize and cudaDeviceSynchronize and no
                blocking cudaMemcpy): a fetch of a value (.item(), bool(),
                .cpu(), a pageable copy either way) is cudaMemcpyAsync
                followed by cudaStreamSynchronize, and counts once, by the
                latter.

The device's times are first put on the host's clock.  On that card the
profiler's device times stray from its host times by up to tens of
milliseconds within one trace, drifting and re-synchronised every few
seconds, where a span can last a millisecond.  Every blocking fetch pins
the two clocks: its copy ends on the device just before the host's wait
for it returns.  The k-th copy the host asked for (cudaMemcpy*) is the
k-th the device ran (one stream), so each fetch gives the offset of the
device's clock there (device end - the wait's end), and every device time
is moved by the offset interpolated at it (clock_offsets, aligned).
Where the copies do not pair one to one, the device's times are used as
they are.

A program without spans (older than the spans) gives None throughout.
"""

from __future__ import annotations

import sys

import numpy as np

from .tracing import _merged

WAITS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D"})
PREFIX = "xrsfm."
FETCH_GAP_NS = 50_000  # a copy call whose wait starts this soon: a fetch


def _host(trace, pred):
    """(starts, durations) of the host events whose names satisfy pred, in
    start order."""
    ids = [i for i, n in enumerate(trace.names) if pred(n)]
    sel = np.isin(trace.host_name, ids)
    o = np.argsort(trace.host_start[sel], kind="stable")
    return trace.host_start[sel][o], trace.host_dur[sel][o]


def clock_offsets(trace):
    """(device times, offsets) in ns at the trace's blocking fetches, in
    device-time order: where the device's clock stood against the host's
    (the copy's end on the device less the end of the host's wait for it;
    a few microseconds below 0 where the clocks agree).  None where the
    copies the host asked for and those the device ran do not pair."""
    hs, hd = _host(trace, lambda n: n.startswith("cudaMemcpy"))
    ids = [i for i, n in enumerate(trace.names) if n.startswith("Memcpy")]
    sel = np.isin(trace.dev_name, ids)
    o = np.argsort(trace.dev_start[sel], kind="stable")
    ds, dd = trace.dev_start[sel][o], trace.dev_dur[sel][o]
    ws, wd = _host(trace, WAITS.__contains__)
    if not len(hs) or len(hs) != len(ds) or not len(ws):
        return None
    call_end = hs + hd
    k = np.minimum(np.searchsorted(ws, call_end), len(ws) - 1)
    w_end = ws[k] + wd[k]
    fetch = (ws[k] >= call_end) & (ws[k] - call_end <= FETCH_GAP_NS) \
        & (dd <= w_end - hs)  # the copy fits inside the host's wait
    de = ds[fetch] + dd[fetch]
    o = np.argsort(de, kind="stable")
    return de[o], (de - w_end[fetch])[o]


def aligned(trace):
    """The device's starts on the host's clock (clock_offsets
    interpolated; the trace's own where there is nothing to align by)."""
    pts = clock_offsets(trace)
    if pts is None or not len(pts[0]):
        return trace.dev_start
    off = np.interp(trace.dev_start, pts[0], pts[1].astype(np.float64))
    return trace.dev_start - np.rint(off).astype(np.int64)


def intervals(trace, prefixes):
    """(starts, ends) in ns, sorted and disjoint: the union of the host
    events whose names start with prefixes (a str or a tuple of str);
    None where there is no such event."""
    ids = [i for i, n in enumerate(trace.names) if n.startswith(prefixes)]
    sel = np.isin(trace.host_name, ids)
    if not sel.any():
        return None
    return _merged(trace.host_start[sel], trace.host_dur[sel])


def _measure_before(s, e, t):
    """For each time in t, the ns of the disjoint sorted intervals (s, e)
    that lie before it."""
    cum = np.concatenate([[0], np.cumsum(e - s)])
    i = np.searchsorted(s, t, side="right")
    k = np.maximum(i - 1, 0)
    part = np.clip(np.minimum(t, e[k]) - s[k], 0, None)
    return np.where(i > 0, cum[k] + part, 0)


def _overlap_ns(a, b) -> int:
    """ns that the interval sets a and b (each sorted and disjoint) share."""
    if not len(a[0]) or not len(b[0]):
        return 0
    return int((_measure_before(*b, a[1]) - _measure_before(*b, a[0])).sum())


def _busy(trace):
    """The merged device intervals, on the host's clock."""
    if not len(trace.dev_start):
        return (np.zeros(0, np.int64),) * 2
    return _merged(aligned(trace), trace.dev_dur)


def span_s(trace, prefixes):
    """Seconds inside the spans; None where there are none."""
    iv = intervals(trace, prefixes)
    return None if iv is None else float((iv[1] - iv[0]).sum()) * 1e-9


def idle_s(trace, prefixes):
    """Seconds inside the spans in which no device operation ran; None
    where there are no spans."""
    iv = intervals(trace, prefixes)
    if iv is None:
        return None
    inside = int((iv[1] - iv[0]).sum())
    return (inside - _overlap_ns(iv, _busy(trace))) * 1e-9


def waits(trace, prefixes):
    """Host waits (WAITS) that start inside the spans; None where there are
    no spans."""
    iv = intervals(trace, prefixes)
    if iv is None:
        return None
    ids = [i for i, n in enumerate(trace.names) if n in WAITS]
    t = trace.host_start[np.isin(trace.host_name, ids)]
    k = np.searchsorted(iv[0], t, side="right") - 1
    return int(((k >= 0) & (t < iv[1][np.maximum(k, 0)])).sum())


def unit_idle_s(trace) -> float:
    """Seconds of the traced unit, from its first host event to the end of
    its last, in which no device operation ran."""
    s0 = int(trace.host_start.min())
    e0 = int((trace.host_start + trace.host_dur).max())
    unit = (np.array([s0]), np.array([e0]))
    return (e0 - s0 - _overlap_ns(unit, _busy(trace))) * 1e-9


def print_coverage(trace, inner=None, outer=None):
    """Print on stderr how the device's clock was put on the host's, and
    the share of the traced unit's device-idle time that lies inside any
    xrsfm.* span; with inner and outer (prefixes, inner's spans inside
    outer's) also the share of the idle time inside outer that lies
    inside inner."""
    if not len(trace.host_start):
        return
    pts = clock_offsets(trace)
    if pts is None or not len(pts[0]):
        print("perfbench: device times used as they are (no blocking fetch "
              "pairs the clocks)", file=sys.stderr)
    else:
        print(f"perfbench: device clock put on the host's at {len(pts[0])} "
              f"fetches, offsets {pts[1].min() / 1e3:.1f} to "
              f"{pts[1].max() / 1e3:.1f} us", file=sys.stderr)
    total = unit_idle_s(trace)
    spanned = idle_s(trace, PREFIX) or 0.0
    line = (f"perfbench: {PREFIX}* spans hold {spanned:.6f} s of the traced "
            f"unit's {total:.6f} s device idle "
            f"({100.0 * spanned / max(total, 1e-12):.2f}%)")
    if inner is not None:
        i, o = idle_s(trace, inner), idle_s(trace, outer)
        if i is not None and o is not None:
            line += (f"; {'|'.join(inner)} hold {i:.6f} s of the {o:.6f} s "
                     f"inside {outer} ({100.0 * i / max(o, 1e-12):.2f}%)")
    print(line, file=sys.stderr)
