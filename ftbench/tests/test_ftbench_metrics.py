"""The metric readers' arithmetic on hand-made records: spans, sink
times, kill, kernel launches and device events."""
import types

import pytest

from ftbench.harness import spec
from ftbench.harness.spans import Spans
from ftbench.harness.traffic import Arrival
from ftbench.harness.trace import busy_intervals, idle_gaps
from ftbench.yardstick import bounds, flops


class Sink:
    def __init__(self):
        self.first, self.last, self.times, self.order = {}, {}, [], []
        self.tokens = {}

    def add(self, rid, t):
        self.first.setdefault(rid, t)
        self.last[rid] = t
        self.times.append(t)
        self.order.append(rid)
        self.tokens.setdefault(rid, []).append(0)

    def delivered(self, rid):
        return len(self.tokens.get(rid, ()))


def _arrival(rid, due, plen=10, new=2):
    a = Arrival(rid=rid, rank=rid % 2, due_s=due, prompt=[1] * plen,
                max_new_tokens=new)
    a.due_abs = 100.0 + due
    return a


def _rec(arrivals, sink, **kw):
    r = types.SimpleNamespace(arrivals=arrivals, sink=sink, t0=100.0,
                              seconds=10.0, max_len=64, spans=None,
                              t_close=110.0, kill=None, device=None,
                              launches={}, setup_s=3.5, sizes=None)
    r.window = (100.0, 110.0)
    r.__dict__.update(kw)
    return r


def test_ttft_and_latency_p90():
    arr = [_arrival(i, float(i)) for i in range(10)]
    sink = Sink()
    for a in arr[:9]:                      # rid 9 never served
        for k in range(3):
            sink.add(a.rid, a.due_abs + 0.1 * (k + 1) * (a.rid + 1))
    rec = _rec(arr, sink)
    ttft = [0.1 * (i + 1) * 1e3 for i in range(9)] + [1e3]   # 110 - 109
    lat = [min(0.3 * (i + 1), 10 - i) * 1e3 for i in range(9)] + [1e3]
    import numpy as np
    assert spec.reader("queue_ttft_p90_ms").read(rec) == pytest.approx(
        np.percentile(ttft, 90))
    assert spec.reader("latency_p90_ms").read(rec) == pytest.approx(
        np.percentile(lat, 90))
    assert spec.reader("setup_s").read(rec) == 3.5


def test_recovery_s():
    arr = [_arrival(i, 0.0) for i in range(4)]
    sink = Sink()
    for rid, t in [(0, 101.0), (1, 101.5), (0, 103.0), (1, 103.2)]:
        sink.add(rid, t)
    rec = _rec(arr, sink, kill={"rank": 1, "t": 102.0})
    assert spec.reader("recovery_s").read(rec) == pytest.approx(1.2)
    assert spec.reader("recovery_s").read(_rec(arr, sink)) is None


def _spans():
    s = Spans()
    s.add("replicator.publish", 99.0, 101.0, nbytes=10, kind="full")
    s.add("replicator.publish", 105.0, 106.0, nbytes=10, kind="delta")
    s.add("model.decode_step", 102.0, 102.1, positions=[100, 200])
    s.add("model.decode_step", 103.0, 103.3, positions=[5])
    s.add("model.prefill", 104.0, 104.5, lanes=1, S=1000)
    s.add("model.prefill", 107.0, 107.5, lanes=2, S=500)
    return s


def test_span_metrics():
    rec = _rec([], Sink(), spans=_spans())
    assert spec.reader("publish_share").read(rec) == pytest.approx(20.0)
    assert spec.reader("decode_step_ms").read(rec) == pytest.approx(200.0)
    assert spec.reader("prefill_ms_per_ktok").read(rec) == pytest.approx(
        500.0)
    assert spec.reader("publish_share").read(_rec([], Sink())) is None


def test_serve_mfu():
    cfg = spec._json(f"{spec.FTBENCH}/configs/falcon-mamba-7b.json")
    sz = flops.Sizes(cfg)
    rec = _rec([], Sink(), spans=_spans(), sizes=sz)
    want = flops.prefill_model_flops(sz, 1000) \
        + 2 * flops.prefill_model_flops(sz, 500) \
        + sum(flops.decode_model_flops(sz, p) for p in (100, 200, 5))
    assert spec.reader("serve_mfu").read(rec) == pytest.approx(
        100 * want / (10.0 * 989e12))


def test_device_metrics():
    dev = types.SimpleNamespace(events=[
        ("selective_scan_fwd<16, true>", 101.0, 101.002),
        ("selective_scan_fwd<16, true>", 101.001, 101.003),
        ("gemm", 104.0, 105.0),
        ("flash_fwd_tc<128, 128>", 106.0, 106.001)])
    rec = _rec([], Sink(), spans=Spans(), device=dev,
               launches={"s1": [(1, 2000, 8192, 16), (1, 1000, 8192, 16)]})
    busy = 0.003 + 1.0 + 0.001
    assert spec.reader("device_idle").read(rec) == pytest.approx(
        100 * (1 - busy / 10.0))
    s1 = bounds.scan_bound_s(1, 2000, 8192, 16)[0] \
        + bounds.scan_bound_s(1, 1000, 8192, 16)[0]
    assert spec.reader("s1_roofline").read(rec) == pytest.approx(
        100 * s1 / 0.004)
    rec.launches = {}
    assert spec.reader("s1_roofline").read(rec) is None


def test_ledger_sink_counts_its_faults():
    from ftbench.harness.bench import LedgerSink
    sink = LedgerSink()
    for rid, idx, tok in [(1, 0, 5), (1, 1, 6), (2, 0, 7), (1, 1, 6),
                          (2, 2, 9), (1, 2, 8)]:
        sink(rid, idx, tok)
    assert sink.tokens == {1: [5, 6, 8], 2: [7, 9]}
    assert sink.faults == [(1, 1, 2), (2, 2, 1)]
    assert sink.order == [1, 1, 2, 2, 1] and len(sink.times) == 5
    assert sink.delivered(1) == 3 and sink.delivered(3) == 0


def test_busy_and_gaps():
    ev = [("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0), ("d", 9, 12)]
    busy = busy_intervals(ev, 0.0, 10.0)
    assert busy == [[1.0, 3.0], [5.0, 6.0], [9.0, 10.0]]
    assert idle_gaps(busy, 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0),
                                          (6.0, 9.0)]
