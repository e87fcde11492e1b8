"""decode_step_ms (layer: engine, `serve/engine.py`): the host wall time
of all decode steps in the traced window over their count, each step
from the call of `Model.decode_step` to the card's synchronisation after
it (the benchmark's span)."""
from ftbench.metrics._common import span_seconds, traced


def read(rec):
    if traced(rec) is None:
        return None
    secs, spans = span_seconds(rec, "model.decode_step")
    return 1e3 * secs / len(spans) if spans else None
