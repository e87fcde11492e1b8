"""publish_share (layer: replication, `serve/replicate.py` and
`checkpoint/serde.py`): the share of the traced window's wall time spent
inside `ServeReplicator.publish`, in percent (the benchmark's span around
each call). The bytes published are printed beside it (`info`)."""
from ftbench.metrics._common import span_seconds, traced


def read(rec):
    win = traced(rec)
    if win is None:
        return None
    secs, spans = span_seconds(rec, "replicator.publish")
    return 100.0 * secs / (win[1] - win[0]) if spans else None
