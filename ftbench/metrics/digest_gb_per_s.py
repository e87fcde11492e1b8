"""digest_gb_per_s (layer: replication, `checkpoint/serde.py`): the bytes
the program's `replicate.digest` spans that start in the traced window
digested (their `replicate.bytes_digested` count) over those spans'
seconds, in GB/s (1e9 bytes)."""
from ftbench.metrics import _program

instrument = _program.instrument


def read(rec):
    sp = _program.spans(rec, "replicate.digest", inside=True)
    secs = sum(e - s for _, s, e, _ in sp)
    if not sp or secs <= 0:
        return None
    return sum(a["replicate.bytes_digested"] for *_, a in sp) / secs / 1e9
