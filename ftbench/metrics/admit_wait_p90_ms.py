"""admit_wait_p90_ms (layer: engine, `serve/engine.py`'s queue): the 90th
percentile of the length of the program's `request.queued` spans that
start in the traced window: from `ServeEngine.submit` (or the restore
that put a request back in the queue) to the start of the admission that
takes it. The wait for a slot, apart from the round loop's lateness
(due to submit) and the prefill itself."""
from ftbench.metrics import _program
from ftbench.metrics._common import p90

instrument = _program.instrument


def read(rec):
    sp = _program.spans(rec, "request.queued", inside=True)
    return p90([(e - s) * 1e3 for _, s, e, _ in sp])
