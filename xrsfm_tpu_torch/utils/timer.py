"""Wall-clock timers (host copy of xrsfm_tpu/utils/timer.py; reference:
src/utility/timer.h:12-70, Timer, TimerArray and the TIMING macro).

`sync_device` is the barrier to call before reading a clock around device
work: torch.cuda.synchronize for a CUDA tensor, nothing on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self.total = 0.0
        self._start: Optional[float] = None

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self):
        if self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None
        return self.total

    @contextlib.contextmanager
    def timing(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def print(self):
        print(f"[timer] {self.name}: {self.total:.3f}s", flush=True)


class TimerArray:
    """Named timer set, mirroring the reference's
    {tot, reg, tri, fil, merge, che, lba, gba} array."""

    def __init__(self, names=("tot", "reg", "tri", "fil", "merge", "che", "lba", "gba")):
        self.timers: Dict[str, Timer] = {n: Timer(n) for n in names}

    def __getitem__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def print_all(self):
        for t in self.timers.values():
            t.print()


def sync_device(x) -> None:
    """Barrier: wait for the device work feeding x (a tensor, or a
    sequence or dict of them) to finish."""
    import torch

    if isinstance(x, dict):
        x = list(x.values())
    leaves = x if isinstance(x, (list, tuple)) else [x]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return
