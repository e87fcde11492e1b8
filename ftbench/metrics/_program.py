"""The program's own spans and counters (`repro_torch.tracing`), for the
readers of the metrics that read them.

`instrument(rec)` is idempotent: the first reader whose instrument the
run enters installs one `Tracer` for the window with `recording`, and the
others reuse it. When the run ends, the program's spans, converted to
seconds on the monotonic clock, are kept on the record
(`rec.program_spans`, beside the tracer itself, `rec.program_tracer`,
which keeps each span's parent and the counters) and added to the
benchmark's own (`rec.spans.spans`), so the breakdown names an idle gap
by the innermost span around it, the program's where one covers it.
A program without `repro_torch.tracing` records nothing, and its readers
return None. Instruments run only in a traced run.
"""
from __future__ import annotations

import bisect
import contextlib

from ftbench.metrics._common import traced


def instrument(rec):
    if hasattr(rec, "program_spans"):
        return contextlib.nullcontext()
    rec.program_spans, rec.program_tracer = [], None
    try:
        from repro_torch import tracing
    except ImportError:                  # a program with no spans of its own
        return contextlib.nullcontext()
    return _recorded(rec, tracing)


@contextlib.contextmanager
def _recorded(rec, tracing):
    tracer = rec.program_tracer = tracing.Tracer()
    try:
        with tracing.recording(tracer):
            yield
    finally:
        rec.program_spans = [(s[0], s[1] / 1e9, s[2] / 1e9, s[4])
                             for s in tracer.spans if s is not None]
        if rec.spans is not None:
            rec.spans.spans.extend(rec.program_spans)


def spans(rec, name: str, inside: bool = False) -> list:
    """The program's spans `name` that overlap the traced window, or with
    `inside` those that start in it; [] in an untraced run."""
    win = traced(rec)
    if win is None:
        return []
    lo, hi = win
    return [s for s in getattr(rec, "program_spans", ())
            if s[0] == name and (lo <= s[1] < hi if inside
                                 else s[2] > lo and s[1] < hi)]


def busy_within(busy: list, sp: list) -> float:
    """Seconds of the sorted busy intervals `busy` that fall inside the
    spans `sp` (disjoint spans: a rank's spans do not overlap)."""
    starts = [s for s, _ in busy]
    out = 0.0
    for _, lo, hi, _ in sp:
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(busy) and busy[i][0] < hi:
            out += max(0.0, min(busy[i][1], hi) - max(busy[i][0], lo))
            i += 1
    return out
