"""The frozen arithmetic equals today's: the analytic FLOPs of
`repro_torch/models/flops.py` for the configuration file and for the
port's olmoe-1b-7b (MoE and attention), and the F1 and S1 bounds
`chip_smoke.py` gives for the kernel table's shapes (PERF.md)."""
import dataclasses

import pytest

from ftbench.harness import bench, spec
from ftbench.yardstick import bounds, flops

CONFIGS = ["falcon-mamba-7b", "olmoe-1b-7b"]


def _config(name):
    """The configuration file, or the port's configuration as a dict where
    the benchmark has no file for it."""
    try:
        return spec._json(f"{spec.FTBENCH}/configs/{name}.json")
    except FileNotFoundError:
        from repro_torch.configs import get_config
        return dataclasses.asdict(get_config(name))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B,S", [(1, 1024), (1, 3840), (4, 512), (8, 1)])
def test_flops_frozen(name, B, S):
    from repro_torch.models import flops as port
    cfg = _config(name)
    mc = bench.model_config(cfg)
    sz = flops.Sizes(cfg)
    assert flops.forward_flops(sz, B, S, flash=True, moe_group=256) == \
        port.forward_flops(mc, B, S, flash=True, moe_group=256)
    assert flops.decode_flops(sz, B, S) == port.decode_flops(mc, B, S)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_is_the_ports(name):
    from repro_torch.configs import get_config
    assert bench.model_config(_config(name)) == get_config(name)


def test_model_flops_parts():
    sz = flops.Sizes(_config("olmoe-1b-7b"))
    S = 2048
    # per layer: attention (flash) + router + 8 of 64 experts
    layer = flops.attn_flops(sz, 1, S, S, causal=True, flash=True) \
        + 2 * S * 2048 * 64 + 3 * 2 * S * 8 * 2048 * 1024
    assert flops.prefill_model_flops(sz, S) == 16 * layer + 2 * 2048 * 50304


# (shape, PERF.md's bound in ms, what sets it)
F1 = [((4, 512, 512, 28, 4, 128), 0.0100, "bytes"),
      ((4, 512, 512, 32, 32, 112), 0.0175, "bytes"),
      ((4, 512, 512, 16, 16, 128), 0.0100, "bytes"),
      ((4, 1024, 1024, 16, 16, 64), 0.0174, "operations"),
      ((4, 512, 1024, 16, 16, 64), 0.0087, "operations"),
      ((2, 3072, 3072, 56, 8, 128), 0.2737, "operations")]
CAUSAL = {(4, 1024, 1024, 16, 16, 64): False, (4, 512, 1024, 16, 16, 64): False}


@pytest.mark.parametrize("shape,ms,by", F1)
def test_f1_bounds(shape, ms, by):
    w = bounds.attention_work(*shape, CAUSAL.get(shape, True), 2)
    t, what = bounds.flash_bound_s(*w, "bfloat16")
    assert round(t * 1e3, 4) == ms and what == by


def test_f1_pairs_closed_form():
    for Sq, Sk in [(5, 5), (3, 9), (9, 3), (1, 1)]:
        loop = sum(min(Sk, max(0, i + Sk - Sq + 1)) for i in range(Sq))
        assert bounds.attention_work(1, Sq, Sk, 1, 1, 1, True, 2)[0] == \
            4 * loop


def test_s1_bound():
    t, what = bounds.scan_bound_s(4, 512, 8192, 16)
    assert round(t * 1e3, 4) == 0.0610 and what == "bytes"
