"""The device's timeline from the profiler's trace (CUPTI through
`torch.profiler`): each kernel, copy and fill that ran on the card, on
the host's monotonic clock, and what the readers take from it."""
from __future__ import annotations

import time


class DeviceTrace:
    """Start with `start()` at the window's start, `stop()` at its close;
    `events` then holds (name, start, end) of every device operation."""

    def __init__(self, torch):
        self.torch = torch
        self.events: list = []
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        # the trace's timestamps are Unix nanoseconds
        self._offset = time.time_ns() - time.monotonic_ns()

    def stop(self):
        self.torch.cuda.synchronize()
        self._prof.stop()

    def collect(self):
        """Read the trace once the run no longer needs the card's time."""
        from torch.autograd import DeviceType
        res = self._prof.profiler.kineto_results
        off = self._offset
        self.events = [
            (e.name(), (e.start_ns() - off) / 1e9,
             (e.start_ns() + e.duration_ns() - off) / 1e9)
            for e in res.events() if e.device_type() == DeviceType.CUDA]
        self._prof = None


def busy_intervals(events, lo: float, hi: float) -> list:
    """The union of the operations' intervals within [lo, hi], sorted."""
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in events
                if e > lo and s < hi)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def idle_gaps(busy: list, lo: float, hi: float) -> list:
    """(start, end) of each stretch in [lo, hi] with no operation."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def device_time_by_name(events, lo: float, hi: float) -> dict:
    """Seconds of device time of each operation name within [lo, hi]."""
    out: dict = {}
    for name, s, e in events:
        if e > lo and s < hi:
            out[name] = out.get(name, 0.0) + min(e, hi) - max(s, lo)
    return out
