"""serve_mfu (layer: model step, `models/*`): the model FLOPs of the
prefill and decode work done in the traced window, over the window's
length times the H100's dense bf16 peak (989 TFLOP/s), in percent. A
prompt of S tokens counts the stack over S positions and the unembedding
of the last; a decode step counts each active lane's token at its
position (the frozen arithmetic of `ftbench/yardstick/flops.py`: the
layers' mathematics, not padding lanes, idle slots or the dense MoE
dispatch). The card's power limit is printed beside it (`info.card`)."""
from ftbench.metrics._common import span_seconds, traced

from ftbench.yardstick.bounds import FLOPS_PER_S
from ftbench.yardstick.flops import (decode_model_flops,
                                     prefill_model_flops)


def read(rec):
    win = traced(rec)
    if win is None:
        return None
    _, pre = span_seconds(rec, "model.prefill")
    _, dec = span_seconds(rec, "model.decode_step")
    flops = sum(s[3]["lanes"] * prefill_model_flops(rec.sizes, s[3]["S"])
                for s in pre)
    flops += sum(decode_model_flops(rec.sizes, p) for s in dec
                 for p in s[3]["positions"])
    if not flops:
        return None
    return 100.0 * flops / ((win[1] - win[0]) * FLOPS_PER_S["bfloat16"])
