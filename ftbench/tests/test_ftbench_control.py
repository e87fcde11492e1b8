"""The control: the plain reference put in the program's place and
computed in the precision below the configuration's (fp8 operands for
bf16 compute) must come out as not correct through the harness's own
comparison (`bench.verify`). On the CPU at the tiny sizes; on the card
at a cell's own size, its sizes and load, on three seeds (`-m gpu`;
`ftbench/tools/sweep.py --check` reads the same numbers over more
seeds)."""
import os

import pytest

from ftbench.harness import bench, spec, traffic


def _checks(cell, seed, seconds, device):
    st = bench.make_setup(cell, seed, device)
    arrivals, fault = traffic.generate(cell.mix, cell.config, seed, seconds,
                                       cell.rate)
    bench.warm_up(st, arrivals)
    rec = bench.serve_window(st, arrivals, fault, seconds, False, 0.0)
    return bench.verify(st, rec), bench.verify(st, rec, quant="fp8")


def test_control_fails_at_tiny_size(cells):
    cell = cells(rate=20.0)
    for seed in (21, 22, 23):
        prog, ctrl = _checks(cell, seed, 2.0, "cpu")
        assert not bench.passes(ctrl), (seed, prog, ctrl)
        assert ctrl["max_logit_gap"]["value"] > \
            ctrl["max_logit_gap"]["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in spec._json(
    os.path.join(spec.ROOT, "BENCHMARK.json"))["workloads"]])
def test_control_fails_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = spec.load(workload)
    for seed in (31, 32, 33):
        prog, ctrl = _checks(cell, seed, 20.0, "cuda")
        assert bench.passes(prog) and not bench.passes(ctrl), \
            (seed, prog, ctrl)
