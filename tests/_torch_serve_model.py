"""The serving tests' model: reduced qwen2-7b (2 layers, d_model 64, qkv
bias) with the JAX package's parameters, carried to the port.

The reference's initializer draws the embedding table at scale 1.0 and
ties it to the unembedding, so a random model's greedy decode repeats the
last prompt token whatever attention computes. The table is scaled by
0.05 here (in both packages alike), so that transcripts depend on the
attention and decode paths the tests compare.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models.model import Model as RefModel
from repro.models.transformer import ExecConfig as RefExecConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model, params_from_jax
from repro_torch.models.transformer import ExecConfig

TABLE_SCALE = 0.05


def serve_models(*, compute_dtype="float32", attn_impl="pallas",
                 ref_attn_impl="chunked", **overrides):
    """(reference Model, port Model, reference params as numpy, port
    params on the CPU) of reduced qwen2-7b with `overrides`."""
    rcfg = ref_reduced(ref_get_config("qwen2-7b")).replace(
        compute_dtype=compute_dtype, **overrides)
    cfg = reduced(get_config("qwen2-7b")).replace(
        compute_dtype=compute_dtype, **overrides)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    ref = RefModel(rcfg, RefExecConfig(attn_impl=ref_attn_impl))
    params = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    params["embedding"]["table"] = (params["embedding"]["table"]
                                    * np.float32(TABLE_SCALE))
    port = Model(cfg, ExecConfig(attn_impl=attn_impl))
    return ref, port, params, params_from_jax(params, device="cpu")
