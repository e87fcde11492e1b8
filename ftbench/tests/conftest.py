"""Tiny cells for the CPU tests: the configuration's family at a few
dozen of width, short prompts, and the same harness as a run on the
card."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_config() -> dict:
    return {"name": "falcon-mamba-7b", "family": "ssm", "n_layers": 2,
            "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
            "vocab_size": 256, "ssm_state": 8, "ssm_version": 1,
            "ssm_expand": 2, "ssm_conv": 4, "ssm_chunk": 16,
            "param_dtype": "float32", "compute_dtype": "bfloat16",
            "norm_eps": 1e-5, "assumed": {"max_len": 64},
            "exec": {"attn_impl": "pallas"}, "reference": "mamba1"}


def tiny_mix(strategy: str = "reinit") -> dict:
    return {"arrivals": {"law": "poisson", "blocks": 2},
            "prompt_len": {"law": "log_normal", "median": 24, "sigma": 0.8,
                           "min": 8, "max": 48},
            "new_tokens": {"law": "log_normal", "median": 4, "sigma": 1.2,
                           "min": 1, "max": 8},
            "cluster": {"world": 2, "n_slots": 4, "strategy": strategy,
                        "publish_every": 2, "base_every": 4,
                        "respawn_delay": 2, "prefill_batch": 1},
            "fault": {"point": "serve.decode.step", "rank": 1,
                      "round": 301},
            "check": {"requests": 8, "drain_s": 30}}


#: the tiny limit lies between what sound runs and broken ones read on
#: the CPU
TINY_LIMITS = {"max_logit_gap": 0.01}


def tiny_cell(strategy: str = "reinit", rate: float = 6.0):
    from ftbench.harness import spec
    cfg = tiny_config()
    bench = {"end_to_end": ["latency_p90_ms", "setup_s"],
             "per_layer": ["queue_ttft_p90_ms", "recovery_s",
                           "publish_share", "decode_step_ms",
                           "prefill_ms_per_ktok", "serve_mfu"]}
    units = {"queue_ttft_p90_ms": "ms", "latency_p90_ms": "ms",
             "setup_s": "s", "recovery_s": "s", "publish_share": "%", "decode_step_ms": "ms",
             "prefill_ms_per_ktok": "ms/ktok", "serve_mfu": "%"}
    e2e = [{"name": n, "unit": units[n]} for n in bench["end_to_end"]]
    per = [{"name": n, "unit": units[n]} for n in bench["per_layer"]]
    return spec.Cell(name=f"{cfg['name']}.tiny.{strategy}", chips=1,
                     config=cfg, mix=tiny_mix(strategy), rate=rate,
                     limits=dict(TINY_LIMITS), end_to_end=e2e, per_layer=per,
                     readers={m["name"]: spec.reader(m["name"])
                              for m in e2e + per})


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cells():
    return tiny_cell
