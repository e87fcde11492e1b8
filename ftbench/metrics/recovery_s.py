"""recovery_s (layer: cluster, `serve/cluster.py`): from the rank kill to
the first token delivered for a request the killed rank owned. Host
clock: the kill's time from the benchmark's injector, the token's from
its `LedgerSink`."""


def read(rec):
    if rec.kill is None:
        return None
    owned = {a.rid for a in rec.arrivals if a.rank == rec.kill["rank"]}
    for rid, t in zip(rec.sink.order, rec.sink.times):
        if t > rec.kill["t"] and rid in owned:
            return t - rec.kill["t"]
    return None
