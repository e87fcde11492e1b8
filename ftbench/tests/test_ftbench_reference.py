"""The plain reference against the port on the CPU at reduced sizes:
with the port computing in float32, its prefill and decode logits equal
the reference's teacher-forced ones; the fp8 control moves them."""
import pytest
import torch

from conftest import tiny_config

from ftbench.harness import bench
from ftbench.yardstick.flops import Sizes


def _port_logits(cfg_dict, prompt, new, seed=3):
    cfg = dict(cfg_dict, compute_dtype="float32")
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    model = Model(bench.model_config(cfg), ExecConfig(**cfg["exec"]))
    sizes = Sizes(dict(cfg, moe_group=model.ec.moe_group))
    ref = bench.reference_module(cfg)
    params = ref.make_weights(sizes, seed, "cpu")
    with torch.no_grad():
        logits, state = model.prefill(
            params, {"tokens": torch.tensor([prompt])}, max_len=128)
        out, toks = [logits[0, -1]], [int(logits[0, -1].argmax())]
        for i in range(new):
            lg, state = model.decode_step(
                params, torch.tensor([[toks[-1]]]), state,
                torch.tensor([len(prompt) + i]))
            out.append(lg[0, 0])
            toks.append(int(lg[0, 0].argmax()))
    want = ref.logits_at(params, sizes, [(prompt, toks)], lanes=1)[0]
    return torch.stack(out), want


@pytest.mark.parametrize("S", [37, 16, 48])
def test_reference_equals_port_in_float32(S):
    cfg = tiny_config()
    prompt = torch.randint(0, cfg["vocab_size"], (S,),
                           generator=torch.Generator().manual_seed(S)
                           ).tolist()
    got, want = _port_logits(cfg, prompt, 4)
    scale = want.abs().max()
    assert torch.allclose(got, want, atol=2e-5 * float(scale), rtol=0), \
        float((got - want).abs().max() / scale)


def test_fp8_control_moves_logits():
    cfg = tiny_config()
    sizes = Sizes(dict(cfg, moe_group=256))
    ref = bench.reference_module(cfg)
    params = ref.make_weights(sizes, 5, "cpu")
    req = [(list(range(3, 40)), [1, 2, 3])]
    hi = ref.logits_at(params, sizes, req)[0]
    lo = ref.logits_at(params, sizes, req, quant="fp8")[0]
    rel = float((hi - lo).abs().max() / hi.abs().max())
    assert 1e-3 < rel < 1.0
