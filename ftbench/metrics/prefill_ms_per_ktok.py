"""prefill_ms_per_ktok (layer: engine, `serve/engine.py`): the host wall
time of all prefill calls in the traced window over the prompt tokens
they took, per thousand tokens. Each call from `Model.prefill` to the
card's synchronisation after it (the benchmark's span); its tokens are
the lanes that are not padding copies times the prompt length."""
from ftbench.metrics._common import span_seconds, traced


def read(rec):
    if traced(rec) is None:
        return None
    secs, spans = span_seconds(rec, "model.prefill")
    tokens = sum(s[3]["lanes"] * s[3]["S"] for s in spans)
    return 1e3 * secs / (tokens / 1e3) if tokens else None
