"""recovery_restore_s (layer: cluster, `serve/cluster.py`'s `_recover`):
the seconds of the program's `recover.compose` (the buddy's held frames
folded into a snapshot) and `recover.restore` (the respawned engine
restored from it) spans of the killed rank after the kill: the
checkpoint read inside `recovery_s`."""
from ftbench.metrics import _program

instrument = _program.instrument


def read(rec):
    if rec.kill is None:
        return None
    sp = [s for name in ("recover.compose", "recover.restore")
          for s in getattr(rec, "program_spans", ())
          if s[0] == name and s[3].get("rank") == rec.kill["rank"]
          and s[1] >= rec.kill["t"]]
    return sum(e - s for _, s, e, _ in sp) if sp else None
