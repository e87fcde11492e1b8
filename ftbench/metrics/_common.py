"""Helpers the metric readers share (a reader imports this by path)."""
from __future__ import annotations

import numpy as np

from ftbench.harness.check import expected_tokens


def p90(values) -> float | None:
    return float(np.percentile(values, 90)) if len(values) else None


def complete(rec, a) -> bool:
    """Whether request `a` was delivered whole."""
    return rec.sink.delivered(a.rid) >= expected_tokens(a, rec.max_len)


def traced(rec) -> tuple | None:
    """The traced window (start, close), or None in an untraced run."""
    if rec.spans is None or rec.t_close is None:
        return None
    return rec.t0, rec.t_close


def span_seconds(rec, name: str) -> tuple:
    """(seconds inside the traced window, spans) of the spans `name`."""
    lo, hi = traced(rec)
    sp = [s for s in rec.spans.spans if s[0] == name and s[2] > lo
          and s[1] < hi]
    return sum(min(e, hi) - max(s, lo) for _, s, e, _ in sp), sp
