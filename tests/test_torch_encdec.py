"""The encdec family of the port (seamless-m4t-medium: a bidirectional
encoder over frontend frame embeddings, a decoder that cross-attends to
it) against the JAX package, on reduced seamless-m4t-medium (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, enc_seq_len 16) with the
reference's parameters.

The reference runs `chunked`; the port runs `chunked` and `pallas` (F1's
plain version on the CPU: non-causal over the encoder and across it, Sq <
Sk at the cross-attention). Tolerances, in float32 compute: the blocks,
the encoder, the logits, prefill and every decode step, and the caches
`k`, `v`, `cross_k`, `cross_v`, within 1e-5 of the largest magnitude of
the reference's output (the products sum in another order, nothing else
differs); the loss within rtol 1e-5 and its gradients within 1e-4 of the
largest; in bfloat16 the loss within rtol 2e-2, as
`tests/test_torch_model.py` states.

The serving engine prefills from tokens alone in both packages, and an
encdec prefill needs `enc_emb` (ROADMAP C8): the reference's engine fails
with a KeyError at its first admission, the port's refuses the model with
a named ValueError.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tf
from repro.models.model import Model as RefModel
from repro.models.transformer import ExecConfig as RefExecConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention, transformer
from repro_torch.models.model import Model, params_from_jax
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import Request, ServeEngine
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import few_threads  # noqa: F401  (autouse)

ARCH = "seamless-m4t-medium"
#: scale of the tied embedding table, in both packages alike, so greedy
#: tokens depend on the stack and not only on the last prompt token
TABLE_SCALE = 0.05
IMPLS = ["chunked", "pallas"]
STATE_KEYS = ("k", "v", "cross_k", "cross_v")


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


def _batch(cfg, seed=4, S=12, B=2):
    """Tokens, next-token labels and `enc_emb` (B, enc_seq_len, D), as jnp
    and as torch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    enc = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)) \
        .astype(np.float32)
    nb = {"tokens": toks, "labels": labels, "enc_emb": enc}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _acts(cfg, seed=5, S=12):
    """A decoder input x (2, S, D) and an encoder output (2, S_enc, D)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, S, cfg.d_model)).astype(np.float32),
            rng.standard_normal((2, cfg.enc_seq_len, cfg.d_model))
            .astype(np.float32))


def _lp(tree, i=0):
    return tree_map(lambda a: a[i], tree)


# ------------------------------------------------------------ parameters

def test_params_from_jax_carries_the_encdec_tree(models):
    """Every leaf of the reference's encdec tree (`frontend_proj/w`,
    `ln_enc/scale`, `stack/enc_layers/...`, `stack/layers/{cross,
    ln_x}/...`) arrives with its shape and bits, and the port's own init
    draws the same tree."""
    _, port, rp, tp = models
    cfg = port.cfg
    want = {k: np.asarray(v) for k, v in _paths(rp).items()}
    got = {k: v.numpy() for k, v in _paths(tp).items()}
    assert sorted(got) == sorted(want)
    D, L = cfg.d_model, cfg.n_layers
    shapes = {
        "['frontend_proj']['w']": (D, D),
        "['ln_enc']['scale']": (D,),
        "['stack']['enc_layers']['attn']['wq']": (cfg.n_enc_layers, D, D),
        "['stack']['enc_layers']['mlp']['wi_up']": (cfg.n_enc_layers, D,
                                                    cfg.d_ff),
        "['stack']['layers']['cross']['wk']": (L, D, D),
        "['stack']['layers']['cross']['wo']": (L, D, D),
        "['stack']['layers']['ln_x']['scale']": (L, D),
    }
    for k, shape in shapes.items():
        assert got[k].shape == shape, k
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    own = port.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _paths(own).items()} == \
        {k: v.shape for k, v in want.items()}
    assert len(tree_leaves(own)) == len(want)


# ------------------------------------------------------- attention parts

@pytest.mark.parametrize("impl", IMPLS)
def test_attention_kv_input_matches_reference(models, impl):
    """Cross-attention through `attention(kv_input=...)`: q from x, K/V
    from the encoder output, no RoPE, non-causal whatever `causal` and
    `positions` say."""
    _, port, rp, tp = models
    x, enc = _acts(port.cfg)
    rlp, tlp = _lp(rp["stack"]["layers"]["cross"]), \
        _lp(tp["stack"]["layers"]["cross"])
    want = jax.jit(lambda p, x, e: ref_attn.attention(
        p, x, port.cfg, kv_input=e, impl="chunked",
        compute_dtype=jnp.float32))(rlp, x, enc)
    for causal in (True, False):
        got = attention.attention(
            tlp, torch.from_numpy(x), port.cfg, causal=causal, impl=impl,
            positions=torch.arange(3, 3 + x.shape[1])[None],
            kv_input=torch.from_numpy(enc), compute_dtype=torch.float32)
        _close(got, want)


def test_project_cross_kv_matches_reference(models):
    _, port, rp, tp = models
    _, enc = _acts(port.cfg)
    rk, rv = ref_attn.project_cross_kv(_lp(rp["stack"]["layers"]["cross"]),
                                       enc, port.cfg, jnp.float32)
    tk, tv = attention.project_cross_kv(
        _lp(tp["stack"]["layers"]["cross"]), torch.from_numpy(enc),
        port.cfg, torch.float32)
    assert tk.shape == (2, port.cfg.enc_seq_len, port.cfg.n_kv_heads,
                        port.cfg.head_dim)
    _close(tk, rk)
    _close(tv, rv)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_cross_decode_attention_matches_reference(models, compute):
    """One decode token against a static cross K/V cache: float32 scores,
    softmax weights in the compute dtype."""
    _, port, rp, tp = models
    x, enc = _acts(port.cfg, S=1)
    rlp, tlp = _lp(rp["stack"]["layers"]["cross"]), \
        _lp(tp["stack"]["layers"]["cross"])
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)
    rk, rv = ref_attn.project_cross_kv(rlp, enc, port.cfg, jdt)
    want = ref_attn.cross_decode_attention(rlp, x, port.cfg, cross_k=rk,
                                           cross_v=rv, compute_dtype=jdt)
    tk, tv = attention.project_cross_kv(tlp, torch.from_numpy(enc),
                                        port.cfg, tdt)
    got = attention.cross_decode_attention(
        tlp, torch.from_numpy(x), port.cfg, cross_k=tk, cross_v=tv,
        compute_dtype=tdt)
    assert got.dtype == tdt and got.shape == (2, 1, port.cfg.d_model)
    _close(got, np.asarray(want, np.float32),
           rel=1e-5 if compute == "float32" else 2e-2)


# ------------------------------------------------------ blocks and stack

@pytest.mark.parametrize("impl", IMPLS)
def test_encdec_block_matches_reference(models, impl):
    """One decoder block: causal self-attention with RoPE, cross-attention
    over the encoder output, the MLP."""
    _, port, rp, tp = models
    cfg = port.cfg
    x, enc = _acts(cfg)
    pos = np.arange(x.shape[1])[None]
    want = jax.jit(lambda p, x, e: ref_tf.encdec_block(
        p, x, e, cfg, RefExecConfig(), jnp.asarray(pos), jnp.float32))(
        _lp(rp["stack"]["layers"]), x, enc)
    got = transformer.encdec_block(
        _lp(tp["stack"]["layers"]), torch.from_numpy(x),
        torch.from_numpy(enc), cfg, ExecConfig(attn_impl=impl),
        torch.from_numpy(pos), torch.float32)
    _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_forward_matches_reference(models, impl):
    """The bidirectional encoder: RoPE at 0..S_enc-1, non-causal."""
    _, port, rp, tp = models
    cfg = port.cfg
    _, enc = _acts(cfg, seed=6)
    want = jax.jit(lambda p, x: ref_tf.encoder_forward(
        p, x, cfg, RefExecConfig(), jnp.float32))(rp["stack"], enc)
    with torch.no_grad():
        got = transformer.encoder_forward(
            tp["stack"], torch.from_numpy(enc), cfg,
            ExecConfig(attn_impl=impl), torch.float32)
    _close(got, want)


def test_encoder_is_bidirectional(models):
    """Changing the last encoder row changes the first row's output (no
    causal mask), where a causal stack would leave it alone."""
    _, port, _, tp = models
    _, enc = _acts(port.cfg, seed=7)
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    with torch.no_grad():
        a, b = (transformer.encoder_forward(
            tp["stack"], torch.from_numpy(e), port.cfg,
            ExecConfig(attn_impl="pallas"), torch.float32)
            for e in (enc, enc2))
    assert not torch.allclose(a[:, 0], b[:, 0])


def test_stack_forward_needs_the_encoder_output(models):
    _, port, _, tp = models
    x, _ = _acts(port.cfg)
    with pytest.raises(ValueError, match="encoder"):
        transformer.stack_forward(tp["stack"], torch.from_numpy(x),
                                  port.cfg, ExecConfig(),
                                  torch.arange(12)[None], torch.float32)


def _unknown_family_calls():
    """Each place a family decision is read, called on a model of an
    unknown family (prefill and decode with a real encdec model's params
    and state)."""
    _, cfg = _cfgs(family="nope")
    model, good = Model(cfg), Model(_cfgs()[1])
    params = good.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "enc_emb": torch.zeros((1, cfg.enc_seq_len, cfg.d_model))}
    return {
        "stack_init": lambda: transformer.stack_init(
            torch.Generator().manual_seed(0), cfg, cfg.param_dtype),
        "init_decode_state": lambda: model.init_decode_state(2, 8,
                                                             device="cpu"),
        "decode_state_batch_axes": model.decode_state_batch_axes,
        "prefill": lambda: model.prefill(params, batch, max_len=8),
        "decode_step": lambda: model.decode_step(
            params, batch["tokens"][:, :1],
            good.init_decode_state(1, 8, device="cpu"), 0),
    }


@pytest.mark.parametrize("call", ["stack_init", "init_decode_state",
                                  "decode_state_batch_axes", "prefill",
                                  "decode_step"])
def test_unknown_family_raises_value_error(call):
    """An unknown family raises ValueError in the reference's init and
    decode state, and in the port wherever a family decision is read
    (every one reads the one family table): the stack, the decode state,
    its batch axes, prefill and decode."""
    rcfg, _ = _cfgs(family="nope")
    with pytest.raises(ValueError):
        RefModel(rcfg).init_decode_state(2, 8)
    with pytest.raises(ValueError, match="nope"):
        _unknown_family_calls()[call]()


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_logits_match_reference(models, impl):
    ref, port, rp, tp = models
    jb, tb = _batch(port.cfg)
    rh, _ = jax.jit(ref.forward)(rp, jb)
    rl, _ = jax.jit(ref.logits)(rp, jb)
    with torch.no_grad():
        th, aux = _port(port, impl).forward(tp, tb)
        tl, _ = _port(port, impl).logits(tp, tb)
    _close(th, rh)
    _close(tl, rl)
    assert float(aux) == 0.0


def test_logits_depend_on_the_encoder_input(models):
    _, port, _, tp = models
    _, tb = _batch(port.cfg)
    tb2 = {**tb, "enc_emb": tb["enc_emb"] + 1.0}
    with torch.no_grad():
        a, _ = port.logits(tp, tb)
        b, _ = port.logits(tp, tb2)
    assert not torch.allclose(a, b)


def test_loss_and_grads_match_reference_fp32(models):
    """The training path: chunked attention, each encoder and decoder
    layer recomputed in the backward pass."""
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


def test_loss_matches_reference_bf16(models):
    ref, port, rp, tp = _in_compute(models, "bfloat16")
    jb, tb = _batch(port.cfg)
    rl, _ = jax.jit(ref.loss_fn)(rp, jb)
    with torch.no_grad():
        tl, _ = port.loss_fn(tp, tb)
    assert float(tl) == pytest.approx(float(rl), rel=2e-2)


def test_init_decode_state_matches_reference():
    """{k, v: (L, B, max_len, Hkv, hd); cross_k, cross_v: (L, B,
    enc_seq_len, Hkv, hd)} in the compute dtype, batch on axis 1 of all
    four."""
    rcfg, cfg = _cfgs()
    for compute in ("float32", "bfloat16"):
        want = RefModel(rcfg.replace(compute_dtype=compute)) \
            .init_decode_state(3, 24)
        port = Model(cfg.replace(compute_dtype=compute))
        got = port.init_decode_state(3, 24, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert all(not v.any() for v in got.values())
        assert port.decode_state_batch_axes() == {k: 1 for k in STATE_KEYS}


DECODE_POS = (12, 13, np.array([14, 14], np.int32), 15)


@pytest.fixture(scope="module")
def ref_decode(models):
    """The reference's prefill of 2 x 12 tokens with `enc_emb`, then 4
    decode steps on its greedy tokens: [(tokens fed, position, logits,
    state)], the prefill first (its position None)."""
    ref, port, rp, _ = models
    jb, tb = _batch(port.cfg, seed=8)
    jb = {k: jb[k] for k in ("tokens", "enc_emb")}
    rl, rst = jax.jit(ref.prefill, static_argnums=2)(rp, jb, 20)
    steps = [(tb, None, rl, rst)]
    step = jax.jit(ref.decode_step)
    for pos in DECODE_POS:
        nxt = np.array(jnp.argmax(rl[:, -1], -1))[:, None]
        rl, rst = step(rp, jnp.asarray(nxt, jnp.int32), rst,
                       jnp.asarray(pos, jnp.int32))
        steps.append((nxt, pos, rl, rst))
    return steps


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(models, ref_decode, impl):
    """Prefill logits and all four state leaves, then 4 decode steps
    teacher-forced on the reference's greedy tokens, with a scalar and
    with per-row positions; the cross caches pass through unchanged."""
    _, port, _, tp = models
    port = _port(port, impl)
    (tb, _, rl, rst), *steps = ref_decode
    with torch.no_grad():
        tl, tst = port.prefill(tp, {"tokens": tb["tokens"],
                                    "enc_emb": tb["enc_emb"]}, max_len=20)
    assert sorted(tst) == sorted(STATE_KEYS)
    _close(tl, rl)
    for k in STATE_KEYS:
        _close(tst[k], rst[k])
    cross = {k: tst[k].clone() for k in ("cross_k", "cross_v")}
    for nxt, pos, rl, rst in steps:
        with torch.no_grad():
            tl, tst2 = port.decode_step(tp, torch.from_numpy(nxt), tst,
                                        torch.as_tensor(pos))
        assert tst2 is tst                    # updated in place
        _close(tl, rl)
        for k in STATE_KEYS:
            _close(tst[k], rst[k])
    for k, v in cross.items():
        assert torch.equal(tst[k], v), k


def test_pallas_prefill_runs_f1_on_every_attention(models, monkeypatch):
    """Under "pallas" a prefill gives F1's wrapper every attention of the
    path: n_enc_layers encoder calls (non-causal, Sq = Sk = S_enc), then
    per decoder layer its self-attention (causal) and its cross-attention
    (non-causal, S queries against S_enc keys); decode gives it none."""
    _, port, _, tp = models
    cfg = port.cfg
    seen, inner = [], fa_ops._forward

    def record(q, k, v, causal):
        seen.append((q.shape[1], k.shape[1], causal))
        return inner(q, k, v, causal)

    monkeypatch.setattr(fa_ops, "_forward", record)
    _, tb = _batch(cfg, S=7)
    with torch.no_grad():
        _, st = _port(port, "pallas").prefill(
            tp, {"tokens": tb["tokens"], "enc_emb": tb["enc_emb"]},
            max_len=16)
        n = len(seen)
        _port(port, "pallas").decode_step(
            tp, tb["tokens"][:, :1], st, 7)
    E = cfg.enc_seq_len
    assert seen == [(E, E, False)] * cfg.n_enc_layers \
        + [(7, 7, True), (7, E, False)] * cfg.n_layers
    assert len(seen) == n


# ------------------------------------------------- serving: ROADMAP C8

def test_c8_engine_refuses_encdec_where_reference_fails_at_admission(
        models):
    """The reference's engine prefills `{"tokens": t}` alone: reduced
    seamless with one 4-token request fails at its first admission with
    `KeyError: 'enc_emb'`. The port's engine refuses the model when it is
    made, naming the rule."""
    ref, port, rp, tp = models
    eng = RefServeEngine(ref, rp, n_slots=2, max_len=32)
    eng.submit(RefRequest(rid=0, prompt=[5, 6, 7, 8], max_new_tokens=4))
    with pytest.raises(KeyError, match="enc_emb"):
        eng.step()
    with pytest.raises(ValueError, match="ROADMAP C8"):
        ServeEngine(port, tp, n_slots=2, max_len=32)


@pytest.fixture
def torch_state():
    """The CLI sets global torch state (deterministic algorithms); put it
    back for the tests that run after in this process."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    yield
    torch.use_deterministic_algorithms(deterministic)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def test_serve_cli_refuses_encdec_on_the_cpu(torch_state):
    from repro_torch.launch.serve import main
    with pytest.raises(ValueError, match="ROADMAP C8"):
        main(["--device", "cpu", "--reduced", "--arch", ARCH,
              "--attn-impl", "pallas", "--requests", "2",
              "--prompt-len", "6", "--max-new", "4", "--max-len", "32"])


# ------------------------------------------------------ on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pallas_prefill_and_decode_match_chunked_on_the_card(cuda):
    """Reduced seamless in float32 compute on the card: prefill with F1
    (its FMA kernel; n_enc_layers + 2 n_layers launches) against chunked,
    logits and the four state leaves within 1e-5 of the largest, then two
    decode steps on both states."""
    cfg = reduced(get_config(ARCH)).replace(compute_dtype="float32")
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    params["embedding"]["table"].mul_(TABLE_SCALE)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 77),
                                     device=cuda, generator=g),
             "enc_emb": torch.randn((4, cfg.enc_seq_len, cfg.d_model),
                                    device=cuda, generator=g)}
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
    assert fa_ops.LAUNCHES["flash_attention"] == \
        n + cfg.n_enc_layers + 2 * cfg.n_layers
    for a, b in zip(out["pallas"][0], out["chunked"][0]):
        _close(a.cpu(), b.cpu().numpy())
    for k in STATE_KEYS:
        _close(out["pallas"][1][k].cpu(), out["chunked"][1][k].cpu().numpy())
