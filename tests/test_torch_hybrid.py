"""Mamba2 (SSD), the hybrid model and hybrid serving of the port against
the JAX package, on reduced zamba2-7b (5 layers, attn_every 2: two groups
of two Mamba2 layers, each followed by the shared attention block, and a
tail of one; d_model 64, head dim 16, ds 8, ssm head dim 16, ssm_chunk 16)
with the reference's parameters.

Tolerances, in float32 compute: the Mamba2 block's functions, the model's
logits, prefill state and decode steps within 1e-5 of the largest
magnitude of the reference's output (the einsums sum in another order,
nothing else differs), as `tests/test_torch_mamba.py` states for Mamba1;
the loss within rtol 1e-5 and its gradients within 1e-4 of the largest,
and in bfloat16 the loss within rtol 2e-2, as `tests/test_torch_model.py`
states. Greedy transcripts of the two serving engines must be equal.
Prompt lengths are multiples of ssm_chunk or shorter than it, the rule of
the reference's chunked SSD (ROADMAP C4).

Also pinned here: the port's fixes of two faults of the reference's
prefill for Mamba2 (ROADMAP C3, C4), and the engine's splice along each
state leaf's own batch axis (the port's answer to C2's class of fault).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import mamba as ref_mamba
from repro.models.model import Model as RefModel
from repro.models.transformer import ExecConfig as RefExecConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import mamba
from repro_torch.models.model import Model, params_from_jax
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import Request, ServeEngine
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import few_threads  # noqa: F401  (autouse)

#: scale of the tied embedding table, in both packages alike, so greedy
#: transcripts depend on the stack and not only on the last prompt token
TABLE_SCALE = 0.05
F32 = torch.float32


def _cfgs(**overrides):
    overrides = {"compute_dtype": "float32", **overrides}
    rcfg = ref_reduced(ref_get_config("zamba2-7b")).replace(**overrides)
    cfg = reduced(get_config("zamba2-7b")).replace(**overrides)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    return rcfg, cfg


def _close(got: torch.Tensor, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _paths(tree) -> dict:
    """{jax key path: leaf} of a nested dict (numpy or torch leaves)."""
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_tree(got, want, rel=1e-5):
    g, w = _paths(got), _paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        _close(g[k], w[k], rel)


# ------------------------------------------------------- the Mamba2 block

@pytest.fixture(scope="module")
def block():
    rcfg, cfg = _cfgs()
    rp = jax.device_get(ref_mamba.mamba2_init(jax.random.PRNGKey(0), rcfg,
                                              jnp.float32))
    x = np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, params_from_jax(rp, device="cpu"), x


def test_mamba2_config_is_the_reduced_hybrid(block):
    _, cfg, _, _, _ = block
    assert (cfg.family, cfg.ssm_version, cfg.n_layers, cfg.attn_every) == \
        ("hybrid", 2, 5, 2)
    assert (cfg.d_model, cfg.head_dim, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.ssm_chunk, cfg.n_ssm_heads) == (64, 16, 8, 16, 16, 8)


def test_mamba2_init_draws_the_reference_tree(block):
    """The port's own init gives the reference's leaves and shapes, with
    and without a lead of stacked axes (the hybrid's (G, E) and tail)."""
    _, cfg, rp, _, _ = block
    for lead in ((), (2, 3), (1,)):
        own = mamba.mamba_init(torch.Generator().manual_seed(0), cfg,
                               "float32", lead)
        assert {k: tuple(v.shape) for k, v in _paths(own).items()} == \
            {k: (*lead, *np.shape(v)) for k, v in _paths(rp).items()}


def test_segsum_matches_reference():
    """The cumsum-difference segment sums, -inf above the diagonal."""
    x = np.random.default_rng(2).standard_normal((2, 3, 16)) \
        .astype(np.float32)
    got = mamba._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_mamba._segsum(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 3, 16, 16)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2 * 3 * 16 * 15 // 2
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=1e-5 * float(np.abs(want[fin]).max()))


def test_ssd_chunk_matches_reference():
    """One chunk from a non-zero incoming state: y and the next state."""
    rng = np.random.default_rng(3)
    B, c, nh, hp, ds = 2, 16, 8, 16, 8
    xc = rng.standard_normal((B, c, nh, hp)).astype(np.float32)
    dtc = np.log1p(np.exp(rng.standard_normal((B, c, nh)))).astype(
        np.float32)
    bc = rng.standard_normal((B, c, ds)).astype(np.float32)
    cc = rng.standard_normal((B, c, ds)).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    h0 = rng.standard_normal((B, nh, hp, ds)).astype(np.float32)
    args = (xc, dtc, bc, cc, A, h0)
    y, h = mamba._ssd_chunk(*map(torch.from_numpy, args))
    want_y, want_h = ref_mamba._ssd_chunk(*map(jnp.asarray, args))
    _close(y, want_y)
    _close(h, want_h)


def test_mamba2_forward_matches_reference(block):
    rcfg, cfg, rp, tp, x = block
    want = ref_mamba.mamba2_forward(rp, jnp.asarray(x), rcfg, jnp.float32)
    got = mamba.mamba2_forward(tp, torch.from_numpy(x), cfg, F32)
    _close(got, want)
    _close(mamba.mamba_forward(tp, torch.from_numpy(x), cfg, F32), want)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mamba2_forward_with_state_matches_reference(block, impl):
    """Prefill's output, final state h and conv tail; `impl` does not
    route Mamba2 anywhere but the chunked SSD."""
    rcfg, cfg, rp, tp, x = block
    want, wst = ref_mamba.mamba2_forward_with_state(rp, jnp.asarray(x), rcfg,
                                                    jnp.float32)
    got, st = mamba.mamba_forward_with_state(tp, torch.from_numpy(x), cfg,
                                             F32, impl=impl)
    _close(got, want)
    assert sorted(st) == ["conv", "h"]
    for k in ("h", "conv"):
        assert st[k].dtype == F32
        _close(st[k], wst[k])


def test_mamba2_step_matches_reference(block):
    """Ten decode steps from the prefill state, each against the
    reference's step."""
    rcfg, cfg, rp, tp, x = block
    _, wst = ref_mamba.mamba2_forward_with_state(rp, jnp.asarray(x[:, :16]),
                                                 rcfg, jnp.float32)
    _, st = mamba.mamba2_forward_with_state(tp, torch.from_numpy(x[:, :16]),
                                            cfg, F32)
    for t in range(16, 26):
        want, wst = ref_mamba.mamba2_step(rp, jnp.asarray(x[:, t:t + 1]), wst,
                                          rcfg, jnp.float32)
        got, st = mamba.mamba_step(tp, torch.from_numpy(x[:, t:t + 1]), st,
                                   cfg, F32)
        _close(got, want)
        for k in ("h", "conv"):
            _close(st[k], wst[k])


def test_mamba2_init_state_matches_reference(block):
    rcfg, cfg, _, _, _ = block
    want = ref_mamba.mamba2_init_state(rcfg, 3)
    got = mamba.mamba_init_state(cfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == F32 and not v.any() for v in got.values())


# ------------------------------------------------------------ the model

def _models(attn_impl="pallas", **overrides):
    """(reference Model on chunked, port Model on `attn_impl`, reference
    params as numpy, port params on the CPU), table scaled in both."""
    rcfg, cfg = _cfgs(**overrides)
    ref = RefModel(rcfg, RefExecConfig(attn_impl="chunked"))
    rp = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    rp["embedding"]["table"] = rp["embedding"]["table"] \
        * np.float32(TABLE_SCALE)
    port = Model(cfg, ExecConfig(attn_impl=attn_impl))
    return ref, port, rp, params_from_jax(rp, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def test_params_from_jax_carries_the_hybrid_tree(models):
    """Every leaf of the reference's hybrid tree (stack/shared/...,
    stack/layers/... with lead (G, E), stack/tail/...) arrives with its
    shape and bits, and the port's own init draws the same tree."""
    _, port, rp, tp = models
    want = {k: np.asarray(v) for k, v in _paths(rp).items()}
    got = {k: v.numpy() for k, v in _paths(tp).items()}
    assert sorted(got) == sorted(want)
    assert got["['stack']['layers']['mamba']['A_log']"].shape == (2, 2, 8)
    assert got["['stack']['tail']['mamba']['in_bc']"].shape == (1, 64, 16)
    assert got["['stack']['shared']['attn']['wq']"].shape == (64, 64)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    own = port.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _paths(own).items()} == \
        {k: v.shape for k, v in want.items()}
    assert len(tree_leaves(own)) == len(want)


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_logits_match_reference(models, attn_impl):
    ref, port, rp, tp = models
    port = Model(port.cfg, ExecConfig(attn_impl=attn_impl))
    toks = np.random.default_rng(3).integers(1, 256, (2, 32))
    rl, _ = ref.logits(rp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tl, aux = port.logits(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, rl)
    assert float(aux) == 0.0


def _batch(cfg, seed=4):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 32))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def test_loss_and_grads_match_reference_fp32(models):
    """The training path (chunked SSD, chunked attention, each group
    recomputed as one block in the backward pass)."""
    ref, port, rp, _ = models
    port = Model(port.cfg)
    jb, tb = _batch(port.cfg)
    (rl, _), rg = jax.value_and_grad(ref.loss_fn, has_aux=True)(rp, jb)
    tp = tree_map(lambda p: p.requires_grad_(),
                  params_from_jax(rp, device="cpu"))
    tl, _ = port.loss_fn(tp, tb)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    assert float(tl.detach()) == pytest.approx(float(rl), rel=1e-5)
    rg = jax.tree.leaves(rg)
    gmax = max(float(np.max(np.abs(np.asarray(g)))) for g in rg)
    assert len(rg) == len(tg)
    for a, b in zip(rg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4 * gmax)


def test_loss_matches_reference_bf16():
    ref, port, rp, tp = _models(compute_dtype="bfloat16")
    port = Model(port.cfg)
    jb, tb = _batch(port.cfg)
    rl, _ = ref.loss_fn(rp, jb)
    with torch.no_grad():
        tl, _ = port.loss_fn(tp, tb)
    assert float(tl) == pytest.approx(float(rl), rel=2e-2)


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_prefill_and_decode_match_reference(attn_impl):
    """Prefill logits and every leaf of the nested state, then 4 decode
    steps (logits and every leaf), against the reference's."""
    ref, port, rp, tp = _models(attn_impl)
    toks = np.random.default_rng(3).integers(1, 256, (2, 32))
    rl, rst = ref.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          max_len=40)
    with torch.no_grad():
        tl, tst = port.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               max_len=40)
    _close(tl, rl)
    _close_tree(tst, rst)
    nxt = np.array(jnp.argmax(rl[:, -1], -1))[:, None]
    for pos in range(32, 36):
        rl, rst = ref.decode_step(rp, jnp.asarray(nxt, jnp.int32), rst,
                                  jnp.int32(pos))
        with torch.no_grad():
            tl, tst2 = port.decode_step(tp, torch.from_numpy(nxt), tst,
                                        torch.tensor(pos))
        assert tst2 is tst                    # updated in place
        _close(tl, rl)
        _close_tree(tst, rst)
        nxt = np.array(jnp.argmax(rl[:, 0], -1))[:, None]


def test_init_decode_state_matches_reference_and_names_batch_axes():
    """The zeroed state has the reference's leaves, shapes and dtypes, and
    `decode_state_batch_axes` names an axis of size batch in each leaf."""
    rcfg, cfg = _cfgs()
    for compute in ("float32", "bfloat16"):
        ref = RefModel(rcfg.replace(compute_dtype=compute))
        port = Model(cfg.replace(compute_dtype=compute))
        want = _paths(ref.init_decode_state(3, 24))
        got = _paths(port.init_decode_state(3, 24, device="cpu"))
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert all(not v.any() for v in got.values())
        axes = _paths(port.decode_state_batch_axes())
        assert sorted(axes) == sorted(got)
        assert {k: got[k].shape[a] for k, a in axes.items()} == \
            {k: 3 for k in axes}
        assert axes["['mamba']['h']"] == 2 and axes["['attn']['k']"] == 1


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_decode_matches_forward(attn_impl):
    """`tests/test_models_smoke.py::test_decode_matches_forward` for the
    hybrid arch, in the port: teacher-forced decode agrees with the
    parallel forward. In bfloat16 at the reference's own tolerance (atol
    0.25, rtol 0.1); in float32 within 1e-5 of the largest logit, the
    file's tolerance (the recurrent step and the chunked SSD sum in
    another order)."""
    cfg = reduced(get_config("zamba2-7b"))
    for compute in ("bfloat16", "float32"):
        model = Model(cfg.replace(compute_dtype=compute),
                      ExecConfig(attn_impl=attn_impl))
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (1, 16),
                             generator=torch.Generator().manual_seed(2))

        def check(got, want):
            if compute == "float32":
                _close(got, want.numpy())
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=0.25, rtol=0.1)

        with torch.no_grad():
            full, _ = model.logits(params, {"tokens": toks})
            lp, state = model.prefill(params, {"tokens": toks[:, :8]},
                                      max_len=20)
            check(lp[0, -1], full[0, 7])
            for i in range(8, 12):
                ld, state = model.decode_step(params, toks[:, i:i + 1],
                                              state, torch.tensor(i))
                check(ld[0, 0], full[0, i])


@pytest.mark.parametrize("family", ["moe", "encdec", "vlm"])
def test_unported_families_still_raise(family):
    """Every family is ported now, and each case keeps its node id:
    `Model(cfg).init` succeeds and the tree holds the family's own leaves
    (moe's routed experts; encdec's encoder stack, cross-attention,
    `frontend_proj` and `ln_enc`; vlm's `frontend_proj` beside the dense
    stack). The families' parity is in `tests/test_torch_moe.py`,
    `tests/test_torch_encdec.py` and `tests/test_torch_vlm.py`."""
    arch = {"moe": "olmoe-1b-7b", "encdec": "seamless-m4t-medium",
            "vlm": "llava-next-34b"}[family]
    cfg = reduced(get_config(arch))
    assert cfg.family == family
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    layers = params["stack"]["layers"]
    if family == "moe":
        assert sorted(layers["moe"]) == ["router", "wi_gate", "wi_up", "wo"]
        assert "mlp" not in layers
        return
    assert params["frontend_proj"]["w"].shape == (cfg.d_model, cfg.d_model)
    if family == "encdec":
        assert sorted(layers) == ["attn", "cross", "ln1", "ln2", "ln_x",
                                  "mlp"]
        assert params["stack"]["enc_layers"]["attn"]["wq"].shape[0] == \
            cfg.n_enc_layers
        assert "ln_enc" in params
    else:
        assert sorted(layers) == ["attn", "ln1", "ln2", "mlp"]
        assert "ln_enc" not in params


# ------------------------------------- faults of the reference's prefill

def test_c3_short_prompt_conv_state_is_padded(models):
    """ROADMAP C3 for Mamba2: a 2-token prompt (shorter than ssm_conv - 1
    = 3). The reference's prefill returns conv states of 2 rows where
    decode wants 3; the port left-pads them with the conv's zeros, and
    prefill + teacher-forced decode then match the forward's logits."""
    ref, port, rp, tp = models
    C = port.cfg.d_inner + 2 * port.cfg.ssm_state       # conv channels
    toks = np.random.default_rng(6).integers(1, 256, (1, 8))
    _, rst = ref.prefill(rp, {"tokens": jnp.asarray(toks[:, :2], jnp.int32)},
                         max_len=16)
    assert rst["mamba"]["conv"].shape == (2, 2, 1, 2, C)    # the fault
    with torch.no_grad():
        full, _ = port.logits(tp, {"tokens": torch.from_numpy(toks)})
        lp, st = port.prefill(tp, {"tokens": torch.from_numpy(toks[:, :2])},
                              max_len=16)
        assert tuple(st["mamba"]["conv"].shape) == (2, 2, 1, 3, C)
        assert tuple(st["tail"]["conv"].shape) == (1, 1, 3, C)
        assert not st["mamba"]["conv"][:, :, :, 0].any()
        _close(lp[:, 0], full[:, 1].numpy())
        for i in range(2, 8):
            ld, st = port.decode_step(
                tp, torch.from_numpy(toks[:, i:i + 1]), st, torch.tensor(i))
            _close(ld[:, 0], full[:, i].numpy())


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_c4_chunked_ssd_names_its_chunk_rule(attn_impl):
    """ROADMAP C4 for Mamba2: the chunked SSD needs S % min(ssm_chunk, S)
    == 0, under every attn_impl. At S 40 with ssm_chunk 16 the reference's
    prefill fails in a reshape; the port raises a ValueError that names the
    rule, and at ssm_chunk 8 (40 = 5 x 8) both serve it alike."""
    ref, port, rp, tp = _models(attn_impl)
    toks = np.random.default_rng(7).integers(1, 256, (1, 40))
    with pytest.raises(ValueError, match="ssm_chunk"):
        port.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=48)
    with pytest.raises(ValueError, match="ssm_chunk"):
        port.logits(tp, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(TypeError, match="reshape"):
        ref.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=48)
    ref8 = RefModel(ref.cfg.replace(ssm_chunk=8),
                    RefExecConfig(attn_impl="chunked"))
    port8 = Model(port.cfg.replace(ssm_chunk=8),
                  ExecConfig(attn_impl=attn_impl))
    rl, rst = ref8.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           max_len=48)
    with torch.no_grad():
        tl, tst = port8.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                max_len=48)
    _close(tl, rl)
    _close_tree(tst, rst)


# ------------------------------------------------------------ serving

#: lengths below ssm_chunk (16) or a multiple of it, as the reference's
#: chunked SSD needs (ROADMAP C4); the last, 2 tokens, only the port
#: serves (C3)
PROMPTS = [[5, 6, 7, 8, 9], [9, 8, 7, 6, 5], [40, 41, 42],
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(60, 76)), [7] * 5,
           [100, 2]]


def _run(model, params, **kw):
    eng = ServeEngine(model, params, n_slots=4, max_len=40, **kw)
    for rid, p in enumerate(PROMPTS):
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=8))
    return {r.rid: list(r.out) for r in eng.run_until_drained()}, eng


def test_engine_transcripts_match_reference(models):
    """The port's engine on `pallas` (F1's plain version on the shared
    block's prefill) against the JAX engine on chunked, at n_slots 4."""
    ref, port, rp, tp = models
    n = len(PROMPTS) - 1
    eng = RefServeEngine(ref, rp, n_slots=4, max_len=40)
    for rid, p in enumerate(PROMPTS[:n]):
        eng.submit(RefRequest(rid=rid, prompt=list(p), max_new_tokens=8))
    want = {r.rid: list(r.out) for r in eng.run_until_drained()}
    got, _ = _run(port, tp)
    assert {k: got[k] for k in want} == want
    assert len(got[n]) == 9
    assert len({tuple(v) for v in want.values()}) > 1   # not degenerate


def test_admission_fills_the_batch_axis_of_every_leaf(models):
    """With n_slots == prefill_batch == G == attn_every == 2 every leading
    axis of the Mamba2 state has the slot count, so a search by size (the
    reference's, C2) picks the group axis. The port splices along the
    batch axis the model names: slot 1 holds the prompt's prefill state in
    every leaf, slot 0 stays zero."""
    _, port, _, tp = models
    eng = ServeEngine(port, tp, n_slots=2, max_len=24)
    assert eng.prefill_batch == 2
    assert eng.state["mamba"]["h"].shape[:3] == (2, 2, 2)
    eng.slots[0] = Request(rid=99, prompt=[1])           # slot 0 is busy
    eng.submit(Request(rid=0, prompt=[4, 5, 6, 7], max_new_tokens=3))
    eng._admit()
    with torch.no_grad():
        _, st = port.prefill(tp, {"tokens": torch.tensor([[4, 5, 6, 7]] * 2)},
                             max_len=24)
    axes = _paths(port.decode_state_batch_axes())
    got, want = _paths(eng.state), _paths(st)
    for k, a in axes.items():
        assert torch.equal(got[k].select(a, 1), want[k].select(a, 0)), k
        assert not got[k].select(a, 0).any(), k


def test_batched_prefill_matches_solo_admission(models):
    """Co-admitted prompts of one length (one prefill call, lane-padded to
    4) decode bit-identically to each prompt served alone."""
    _, port, _, tp = models
    solo = {}
    for rid in range(3):
        eng = ServeEngine(port, tp, n_slots=4, max_len=24, prefill_batch=1)
        eng.submit(Request(rid=rid, prompt=[20 + rid] * 5, max_new_tokens=6))
        r, = eng.run_until_drained()
        solo[rid] = r.out
    eng = ServeEngine(port, tp, n_slots=4, max_len=24)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[20 + rid] * 5, max_new_tokens=6))
    assert {r.rid: r.out for r in eng.run_until_drained()} == solo
    assert eng.prefill_calls == 1


def test_snapshot_restore_is_bit_identical(models):
    """A snapshot mid-decode restored into a new engine gives the straight
    run's transcripts and every leaf of its final nested state, bit for
    bit."""
    _, port, _, tp = models
    want, straight = _run(port, tp)
    first = ServeEngine(port, tp, n_slots=4, max_len=40)
    for rid, p in enumerate(PROMPTS):
        first.submit(Request(rid=rid, prompt=list(p), max_new_tokens=8))
    for _ in range(5):
        first.step()
    snap = first.snapshot()
    assert snap["queue"], "the snapshot should hold queued requests"
    for _ in range(3):          # the live state moves on, in place
        first.step()
    second = ServeEngine(port, tp, n_slots=4, max_len=40)
    second.restore(snap)
    got = {r.rid: list(r.out) for r in second.run_until_drained()}
    assert {**{r.rid: list(r.out) for r in first.completed}, **got} == want
    a, b = _paths(second.state), _paths(straight.state)
    assert sorted(a) == sorted(b) and len(a) == 6
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_prefill_cache_reuses_hybrid_lanes(models):
    _, port, _, tp = models
    eng = ServeEngine(port, tp, n_slots=2, max_len=24, prefill_cache=4)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[9, 9, 9], max_new_tokens=3))
        eng.run_until_drained()
    outs = [r.out for r in eng.completed]
    assert outs[0] == outs[1] == outs[2]
    assert eng.prefill_calls == 2
    (_, lane), = eng._prefill_cache.values()
    assert tuple(lane["mamba"]["h"].shape[:3]) == (2, 2, 1)


@pytest.fixture
def torch_state():
    """The CLI sets global torch state (deterministic algorithms); put it
    back for the tests that run after in this process."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    yield
    torch.use_deterministic_algorithms(deterministic)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def test_serve_cli_serves_zamba2_on_the_cpu(capsys, torch_state):
    from repro_torch.launch.serve import main
    n = fa_ops.LAUNCHES["flash_attention"]
    assert main(["--device", "cpu", "--reduced", "--arch", "zamba2-7b",
                 "--attn-impl", "pallas", "--requests", "5",
                 "--prompt-len", "12,12,12,2,32", "--max-new", "4",
                 "--max-len", "64", "--snapshot-every", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "zamba2-7b-smoke"
    assert out["completed"] == 5 and out["tokens_generated"] == 20
    assert out["prefill_calls"] == 3 and out["snapshot_taken"]
    assert out["device"] == "cpu" and out["attn_impl"] == "pallas"
    assert fa_ops.LAUNCHES["flash_attention"] == n      # no kernel on a CPU
