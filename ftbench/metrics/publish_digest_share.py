"""publish_digest_share (layer: replication, `checkpoint/serde.py`'s
`FramePublisher.publish`): the seconds of the program's
`replicate.digest` spans inside the traced window (the tile digest of a
rank's whole flattened state, every publish) over the window, in
percent. The part of `publish_share` that digesting on the card would
take away."""
from ftbench.metrics import _program
from ftbench.metrics._common import span_seconds, traced

instrument = _program.instrument


def read(rec):
    win = traced(rec)
    if win is None:
        return None
    secs, spans = span_seconds(rec, "replicate.digest")
    return 100.0 * secs / (win[1] - win[0]) if spans else None
