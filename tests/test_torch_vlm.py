"""The vlm family of the port (llava-next-34b: the dense stack behind a
vision frontend whose projected patch embeddings overwrite the first rows
of the prompt's embedding) against the JAX package, on reduced
llava-next-34b (2 layers, d_model 64, 4 heads of 16 over 4 KV heads, 8
frontend rows) with the reference's parameters.

The reference runs `chunked`; the port runs `chunked` and `pallas` (F1's
plain version on the CPU). Tolerances, in float32 compute: the logits,
prefill, every decode step and the KV caches within 1e-5 of the largest
magnitude of the reference's output; the loss within rtol 1e-5 and its
gradients within 1e-4 of the largest; in bfloat16 the loss within rtol
2e-2, as `tests/test_torch_model.py` states. Decode embeds tokens alone,
as in the reference.

Both serving engines prefill from tokens alone (ROADMAP C8), so a vlm
model is served without its frontend; the port's engine gives the
reference's transcripts and token frames. A prompt shorter than the
frontend keeps no text token in the reference (ROADMAP C9); the port
raises a named ValueError.
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
from repro.models.model import Model as RefModel
from repro.models.transformer import ExecConfig as RefExecConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.model import Model, params_from_jax
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import Request, ServeEngine
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import few_threads  # noqa: F401  (autouse)

ARCH = "llava-next-34b"
#: scale of the tied embedding table, in both packages alike, so greedy
#: transcripts depend on the stack and not only on the last prompt token
TABLE_SCALE = 0.05
IMPLS = ["chunked", "pallas"]


def _cfgs(**overrides):
    overrides = {"compute_dtype": "float32", **overrides}
    rcfg = ref_reduced(ref_get_config(ARCH)).replace(**overrides)
    cfg = reduced(get_config(ARCH)).replace(**overrides)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    return rcfg, cfg


def _close(got: torch.Tensor, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _paths(tree) -> dict:
    """{jax key path: leaf} of a nested dict (numpy or torch leaves)."""
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _models(**overrides):
    """(reference Model on chunked, port Model on chunked, reference
    params as numpy, port params on the CPU), table scaled in both."""
    rcfg, cfg = _cfgs(**overrides)
    ref = RefModel(rcfg, RefExecConfig(attn_impl="chunked"))
    rp = jax.device_get(jax.jit(ref.init)(jax.random.PRNGKey(0)))
    rp["embedding"]["table"] = rp["embedding"]["table"] \
        * np.float32(TABLE_SCALE)
    return ref, Model(cfg), rp, params_from_jax(rp, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def _in_compute(models, compute):
    """`models` with both packages' models in compute dtype `compute`. The
    parameters are float32 whatever the compute dtype, so the reference's
    init (and its compilation) is shared."""
    ref, port, rp, tp = models
    return (RefModel(ref.cfg.replace(compute_dtype=compute), ref.ec),
            Model(port.cfg.replace(compute_dtype=compute)), rp, tp)


def _port(port, impl):
    return Model(port.cfg, ExecConfig(attn_impl=impl))


def _batch(cfg, seed=4, S=20, B=2, frontend=True):
    """Tokens, next-token labels and `frontend_emb` (B, nf, D), as jnp and
    as torch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    nb = {"tokens": toks, "labels": labels}
    if frontend:
        nb["frontend_emb"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


# ------------------------------------------------------------ parameters

def test_params_from_jax_carries_the_vlm_tree(models):
    """The reference's vlm tree (the dense stack and `frontend_proj/w`,
    no `ln_enc`) arrives with its shapes and bits, and the port's own init
    draws the same tree."""
    _, port, rp, tp = models
    D = port.cfg.d_model
    want = {k: np.asarray(v) for k, v in _paths(rp).items()}
    got = {k: v.numpy() for k, v in _paths(tp).items()}
    assert sorted(got) == sorted(want)
    assert got["['frontend_proj']['w']"].shape == (D, D)
    assert "['ln_enc']['scale']" not in got
    assert got["['stack']['layers']['mlp']['wi_up']"].shape == \
        (port.cfg.n_layers, D, port.cfg.d_ff)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    own = port.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _paths(own).items()} == \
        {k: v.shape for k, v in want.items()}
    assert len(tree_leaves(own)) == len(want)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_embed_inputs_matches_reference(models, compute):
    """The frontend's projection overwrites the first nf rows; the rest
    are the tokens' embeddings."""
    ref, port, rp, tp = _in_compute(models, compute)
    jb, tb = _batch(port.cfg)
    want = ref._embed_inputs(rp, jb, getattr(jnp, compute))
    got = port._embed_inputs(tp, tb, getattr(torch, compute))
    assert got.dtype == getattr(torch, compute)
    _close(got, np.asarray(want, np.float32),
           rel=1e-6 if compute == "float32" else 1e-2)
    nf = port.cfg.n_frontend_tokens
    plain = port._embed_inputs(tp, {"tokens": tb["tokens"]},
                               getattr(torch, compute))
    assert torch.equal(got[:, nf:], plain[:, nf:])
    assert not torch.equal(got[:, :nf], plain[:, :nf])


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_logits_match_reference(models, impl):
    ref, port, rp, tp = models
    jb, tb = _batch(port.cfg)
    rh, _ = jax.jit(ref.forward)(rp, jb)
    rl, _ = jax.jit(ref.logits)(rp, jb)
    with torch.no_grad():
        th, _ = _port(port, impl).forward(tp, tb)
        tl, _ = _port(port, impl).logits(tp, tb)
    _close(th, rh)
    _close(tl, rl)


def test_frontend_overwrites_prefix(models):
    """The reference's `test_vlm_frontend_overwrites_prefix` on the port:
    frontends of +1 and -1 give different hidden states."""
    _, port, _, tp = models
    cfg = port.cfg
    toks = torch.zeros((1, 16), dtype=torch.long)
    fe = torch.ones((1, 8, cfg.d_model), dtype=torch.bfloat16)
    with torch.no_grad():
        h1, _ = port.forward(tp, {"tokens": toks, "frontend_emb": fe})
        h2, _ = port.forward(tp, {"tokens": toks, "frontend_emb": -fe})
    assert not torch.allclose(h1, h2)


def test_loss_and_grads_match_reference_fp32(models):
    """The training path with a frontend input: chunked attention, each
    layer recomputed in the backward pass; `frontend_proj` gets its
    gradient."""
    ref, port, rp, _ = models
    jb, tb = _batch(port.cfg)
    (rl, _), rg = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        rp, jb)
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
    front = next(i for i, t in enumerate(tree_leaves(tp))
                 if t is tp["frontend_proj"]["w"])
    assert float(tg[front].abs().max()) > 0


def test_loss_matches_reference_bf16(models):
    ref, port, rp, tp = _in_compute(models, "bfloat16")
    jb, tb = _batch(port.cfg)
    rl, _ = jax.jit(ref.loss_fn)(rp, jb)
    with torch.no_grad():
        tl, _ = port.loss_fn(tp, tb)
    assert float(tl) == pytest.approx(float(rl), rel=2e-2)


def test_init_decode_state_is_the_dense_layout():
    """vlm's decode state is the dense family's: KV caches (L, batch,
    max_len, Hkv, hd) in the compute dtype, batch on axis 1."""
    rcfg, cfg = _cfgs()
    for compute in ("float32", "bfloat16"):
        want = RefModel(rcfg.replace(compute_dtype=compute)) \
            .init_decode_state(3, 24)
        port = Model(cfg.replace(compute_dtype=compute))
        got = port.init_decode_state(3, 24, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert port.decode_state_batch_axes() == {"k": 1, "v": 1}


DECODE_POS = (20, 21, np.array([22, 22], np.int32), 23)


def _ref_decode(models, frontend):
    """The reference's prefill of 2 x 20 tokens (with or without the
    frontend), then 4 decode steps on its greedy tokens: [(tokens fed,
    position, logits, state)], the prefill first."""
    ref, port, rp, _ = models
    jb, tb = _batch(port.cfg, seed=8, frontend=frontend)
    keys = ("tokens", "frontend_emb") if frontend else ("tokens",)
    rl, rst = jax.jit(ref.prefill, static_argnums=2)(
        rp, {k: jb[k] for k in keys}, 28)
    steps = [({k: tb[k] for k in keys}, None, rl, rst)]
    step = jax.jit(ref.decode_step)
    for pos in DECODE_POS:
        nxt = np.array(jnp.argmax(rl[:, -1], -1))[:, None]
        rl, rst = step(rp, jnp.asarray(nxt, jnp.int32), rst,
                       jnp.asarray(pos, jnp.int32))
        steps.append((nxt, pos, rl, rst))
    return steps


@pytest.fixture(scope="module")
def ref_decode(models):
    return {fr: _ref_decode(models, fr) for fr in (True, False)}


@pytest.mark.parametrize("frontend", [True, False],
                         ids=["frontend", "tokens-only"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(models, ref_decode, impl,
                                            frontend):
    """Prefill logits and KV caches, with the frontend and from the tokens
    alone, then 4 decode steps teacher-forced on the reference's greedy
    tokens, with a scalar and with per-row positions."""
    _, port, _, tp = models
    port = _port(port, impl)
    (tb, _, rl, rst), *steps = ref_decode[frontend]
    with torch.no_grad():
        tl, tst = port.prefill(tp, tb, max_len=28)
    _close(tl, rl)
    for k in ("k", "v"):
        _close(tst[k], rst[k])
    for nxt, pos, rl, rst in steps:
        with torch.no_grad():
            tl, tst2 = port.decode_step(tp, torch.from_numpy(nxt), tst,
                                        torch.as_tensor(pos))
        assert tst2 is tst
        _close(tl, rl)
        for k in ("k", "v"):
            _close(tst[k], rst[k])


def test_pallas_prefill_runs_f1_once_a_layer(models, monkeypatch):
    """Under "pallas" a prefill with the frontend gives F1's wrapper one
    causal self-attention a layer over the whole prompt, frontend rows
    included; decode gives it none."""
    _, port, _, tp = models
    seen, inner = [], fa_ops._forward

    def record(q, k, v, causal):
        seen.append((q.shape[1], k.shape[1], causal))
        return inner(q, k, v, causal)

    monkeypatch.setattr(fa_ops, "_forward", record)
    _, tb = _batch(port.cfg)
    with torch.no_grad():
        _, st = _port(port, "pallas").prefill(
            tp, {k: tb[k] for k in ("tokens", "frontend_emb")}, max_len=28)
        _port(port, "pallas").decode_step(tp, tb["tokens"][:, :1], st, 20)
    assert seen == [(20, 20, True)] * port.cfg.n_layers


# ---------------------------------------------- the reference's fault C9

def test_c9_prompt_shorter_than_the_frontend(models):
    """A 4-token prompt with 8 frontend rows. The reference keeps no text
    token: its prefill returns the same logits for different prompts over
    8 positions of frontend, and its loss fails in a reshape. The port
    raises a ValueError naming S >= frontend_emb.shape[1]."""
    ref, port, rp, tp = models
    cfg = port.cfg
    fe = np.random.default_rng(9).standard_normal(
        (1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    logits = []
    for toks in ([[5, 6, 7, 8]], [[9, 10, 11, 12]]):
        rl, rst = ref.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32),
                                   "frontend_emb": jnp.asarray(fe)}, 4)
        logits.append(np.asarray(rl))
        assert rst["k"].shape[2] == cfg.n_frontend_tokens
    np.testing.assert_array_equal(logits[0], logits[1])
    jb, _ = _batch(cfg, S=4)
    with pytest.raises(TypeError):
        ref.loss_fn(rp, jb)

    _, tb = _batch(cfg, S=4)
    for call in (lambda: port.prefill(tp, tb, max_len=16),
                 lambda: port.loss_fn(tp, tb),
                 lambda: port.forward(tp, tb)):
        with pytest.raises(ValueError,
                           match=r"S >= frontend_emb\.shape\[1\]"):
            call()
    # a prompt as long as the frontend keeps no text token either, but it
    # keeps its length: both packages agree there
    _, tb = _batch(cfg, S=cfg.n_frontend_tokens)
    with torch.no_grad():
        assert port.prefill(tp, tb, max_len=16)[0].shape == \
            (2, 1, cfg.vocab_size)


# ------------------------------------------------- serving: ROADMAP C8

#: 7 requests for 4 slots, so slots are freed and refilled; three prompt
#: lengths, so the reference compiles three prefill shapes
PROMPTS = [[5, 6, 7, 8, 9], [9, 8, 7, 6, 5], [40, 44, 42],
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(60, 65)), [7] * 5,
           [100, 2, 4]]


def _serve(model, params, engine, request, max_new=8):
    frames = []
    eng = engine(model, params, n_slots=4, max_len=40,
                 sink=lambda rid, idx, tok: frames.append((rid, idx, tok)))
    for rid, p in enumerate(PROMPTS):
        eng.submit(request(rid=rid, prompt=list(p), max_new_tokens=max_new))
    return {r.rid: list(r.out) for r in eng.run_until_drained()}, frames


def test_engine_serves_vlm_from_tokens_like_reference(models):
    """Both engines serve reduced llava from the prompts' tokens alone
    (the frontend never enters serving, ROADMAP C8): the port's engine on
    `pallas` gives the reference's transcripts and the same token frames,
    (request, index, token) in delivery order."""
    ref, port, rp, tp = models
    want, want_frames = _serve(ref, rp, RefServeEngine, RefRequest)
    got, got_frames = _serve(_port(port, "pallas"), tp, ServeEngine,
                             Request)
    assert got == want
    assert got_frames == want_frames
    assert len({tuple(v) for v in want.values()}) > 1   # not degenerate


@pytest.fixture
def torch_state():
    """The CLI sets global torch state (deterministic algorithms); put it
    back for the tests that run after in this process."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    yield
    torch.use_deterministic_algorithms(deterministic)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def test_serve_cli_serves_vlm_on_the_cpu(capsys, torch_state):
    from repro_torch.launch.serve import main
    n = fa_ops.LAUNCHES["flash_attention"]
    assert main(["--device", "cpu", "--reduced", "--arch", ARCH,
                 "--attn-impl", "pallas", "--requests", "5",
                 "--prompt-len", "12,12,12,7,30", "--max-new", "4",
                 "--max-len", "64"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "llava-next-34b-smoke"
    assert out["completed"] == 5 and out["tokens_generated"] == 20
    assert out["prefill_calls"] == 3
    assert fa_ops.LAUNCHES["flash_attention"] == n      # no kernel on a CPU


# ------------------------------------------------------ on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pallas_prefill_and_decode_match_chunked_on_the_card(cuda):
    """Reduced llava in float32 compute on the card, S 77 with the
    frontend: prefill with F1 (its FMA kernel, GQA 4/4 of 16; one launch
    a layer) against chunked, logits and KV caches within 1e-5 of the
    largest, then two decode steps on both states."""
    cfg = reduced(get_config(ARCH)).replace(compute_dtype="float32")
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    params["embedding"]["table"].mul_(TABLE_SCALE)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 77),
                                     device=cuda, generator=g),
             "frontend_emb": torch.randn(
                 (2, cfg.n_frontend_tokens, cfg.d_model), device=cuda,
                 generator=g).to(torch.bfloat16)}
    out = {}
    n = fa_ops.LAUNCHES["flash_attention"]
    for impl in IMPLS:
        m = Model(cfg, ExecConfig(attn_impl=impl))
        with torch.no_grad():
            logits, st = m.prefill(params, batch, max_len=96)
            steps = [logits]
            for pos in (77, 78):
                tok = steps[-1][:, -1].argmax(-1, keepdim=True)
                steps.append(m.decode_step(params, tok, st, pos)[0])
        out[impl] = (steps, st)
    assert fa_ops.LAUNCHES["flash_attention"] == n + cfg.n_layers
    for a, b in zip(out["pallas"][0], out["chunked"][0]):
        _close(a.cpu(), b.cpu().numpy())
    for k in ("k", "v"):
        _close(out["pallas"][1][k].cpu(), out["chunked"][1][k].cpu().numpy())
