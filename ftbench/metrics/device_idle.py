"""device_idle (layer: device, the H100): the share of the traced window
in which no kernel, copy or fill ran on the card, in percent, from the
profiler's timeline."""
from ftbench.metrics._common import traced

from ftbench.harness.trace import busy_intervals


def read(rec):
    win = traced(rec)
    if win is None or rec.device is None or not rec.device.events:
        return None
    busy = sum(e - s for s, e in busy_intervals(rec.device.events, *win))
    return 100.0 * (1.0 - busy / (win[1] - win[0]))
