"""queue_ttft_p90_ms (layer: cluster, `serve/cluster.py`): the 90th
percentile, over every request due in the window, of the time from when
it was due (open loop) to its first delivered token; a request without
one at the window's end counts with its wait so far. It is set by the
few requests that wait behind the kill's backlog or a publishing round.
Host clock (the benchmark's `LedgerSink`)."""
from ftbench.metrics._common import p90


def read(rec):
    hi = rec.window[1]
    vals = []
    for a in rec.arrivals:
        t = rec.sink.first.get(a.rid, hi)
        vals.append((min(t, hi) - a.due_abs) * 1e3)
    return p90(vals)
