"""Model and optimizer of the port against the JAX package.

The reference's parameters (`Model(reduced(paper_demo)).init(PRNGKey(0))`)
are carried across with `params_from_jax`; both packages then take the
same numpy batch. Tolerances:
  - float32 compute: loss rtol 1e-5, gradients 1e-4 of max|g| — sums run
    in another order (XLA vs ATen), nothing else differs;
  - bfloat16 compute: loss rtol 2e-2 — the frameworks round to bf16 at
    different points (XLA fuses casts into the matmuls);
  - one AdamW update in float32: 1e-6 absolute on parameters of O(1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models.model import Model as RefModel
from repro.train.data import TokenPipeline as RefPipeline
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model, params_from_jax
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, lr_at)
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import few_threads  # noqa: F401  (autouse)


def _pair(compute_dtype):
    rcfg = ref_reduced(ref_get_config("paper-demo")).replace(
        compute_dtype=compute_dtype)
    cfg = reduced(get_config("paper-demo")).replace(
        compute_dtype=compute_dtype)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    ref = RefModel(rcfg)
    params = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    return ref, Model(cfg), params


def _batch(step=3):
    hb = RefPipeline(256, 4, 32, seed=7).host_batch(step)
    ours = TokenPipeline(256, 4, 32, seed=7, device="cpu").batch(step)
    for k in hb:
        assert np.array_equal(ours[k].numpy(), hb[k])
    return {k: jnp.asarray(v) for k, v in hb.items()}, ours


def _loss_and_grads(compute_dtype):
    ref, model, params = _pair(compute_dtype)
    jb, tb = _batch()
    (rl, _), rg = jax.value_and_grad(ref.loss_fn, has_aux=True)(params, jb)
    tp = tree_map(lambda p: p.requires_grad_(),
                  params_from_jax(params, device="cpu"))
    tl, _ = model.loss_fn(tp, tb)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    return float(rl), float(tl.detach()), jax.tree.leaves(rg), tg


def test_param_tree_has_reference_paths_and_shapes():
    from repro.checkpoint.manifest import flatten_leaves as ref_flat
    from repro_torch.checkpoint.manifest import flatten_leaves
    ref, model, params = _pair("float32")
    ours = model.init(torch.Generator().manual_seed(0))
    a, b = ref_flat(params), flatten_leaves(ours)
    assert sorted(a) == sorted(b)
    for k in a:
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        assert str(a[k].dtype) == str(b[k].dtype).removeprefix("torch."), k


def test_loss_and_grads_match_reference_fp32():
    rl, tl, rg, tg = _loss_and_grads("float32")
    assert tl == pytest.approx(rl, rel=1e-5)
    gmax = max(float(np.max(np.abs(np.asarray(g)))) for g in rg)
    for a, b in zip(rg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4 * gmax)


def test_loss_matches_reference_bf16():
    rl, tl, _, _ = _loss_and_grads("bfloat16")
    assert tl == pytest.approx(rl, rel=2e-2)


def test_adamw_update_matches_reference_fp32():
    _, _, params = _pair("float32")
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    rcfg = RefAdamW(lr=1e-3, warmup_steps=2, total_steps=10)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    rp, ro = params, ref_adamw_init(params)
    tp = params_from_jax(params, device="cpu")
    to = adamw_init(tp)
    for _ in range(3):                     # warmup and cosine both covered
        rp, ro, rm = ref_adamw_update(rp, grads, ro, rcfg)
        tg = params_from_jax(grads, device="cpu")
        tp, to, tm = adamw_update(tp, tg, to, cfg)
    assert int(to["count"]) == int(ro["count"]) == 3
    assert to["count"].dtype == torch.int32
    assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    for tree_r, tree_t in ((rp, tp), (ro["m"], to["m"]), (ro["v"], to["v"])):
        for a, b in zip(jax.tree.leaves(tree_r), tree_leaves(tree_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)


def test_lr_schedule_matches_reference():
    from repro.train.optimizer import lr_at as ref_lr_at
    cfg = AdamWConfig(warmup_steps=5, total_steps=50)
    for s in (0, 1, 4, 5, 6, 30, 50, 60):
        assert float(lr_at(cfg, torch.tensor(s))) == pytest.approx(
            float(ref_lr_at(RefAdamW(warmup_steps=5, total_steps=50), s)),
            rel=1e-6)


def test_pallas_attention_not_ported_raises():
    from repro_torch.models.transformer import ExecConfig
    cfg = reduced(get_config("paper-demo"))
    model = Model(cfg, ExecConfig(attn_impl="pallas"))
    params = model.init(torch.Generator().manual_seed(0))
    _, tb = _batch()
    with pytest.raises(NotImplementedError, match="slice 2"):
        model.loss_fn(params, tb)
