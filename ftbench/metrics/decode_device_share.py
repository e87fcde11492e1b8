"""decode_device_share (layer: engine, `serve/engine.py`'s `step`): the
card's busy time (the union of the profiler's operations) inside the
program's `engine.decode` spans (the model call through the read of the
step's tokens) over those spans' seconds in the traced window, in
percent. It shows how far the host paces the decode round: what a CUDA
graph of the step could take away is the rest. None without a device
trace."""
from ftbench.harness.trace import busy_intervals
from ftbench.metrics import _program

instrument = _program.instrument


def read(rec):
    sp = _program.spans(rec, "engine.decode")
    if rec.device is None or not rec.device.events or not sp:
        return None
    lo, hi = rec.t0, rec.t_close
    sp = [(n, max(s, lo), min(e, hi), a) for n, s, e, a in sp]
    total = sum(e - s for _, s, e, _ in sp)
    busy = busy_intervals(rec.device.events, lo, hi)
    return 100.0 * _program.busy_within(busy, sp) / total
