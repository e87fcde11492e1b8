"""latency_p90_ms: the 90th percentile, over every request due in the
window, of the time from when it was due to its last token delivered; a
request not served whole at the window's end counts with its wait so
far. Host clock (the benchmark's `LedgerSink`)."""
from ftbench.metrics._common import complete, p90


def read(rec):
    hi = rec.window[1]
    vals = []
    for a in rec.arrivals:
        t = rec.sink.last[a.rid] if complete(rec, a) else hi
        vals.append((min(t, hi) - a.due_abs) * 1e3)
    return p90(vals)
