"""The MoE family of the port (top-k routing with capacity, the moe block,
the model and moe serving) against the JAX package, on reduced
olmoe-1b-7b and reduced qwen3-moe-30b-a3b (2 layers, d_model 64, 4 heads
of 16, 4 experts, top-2, d_ff 32; qwen3-moe adds qk-norm) with the
reference's parameters.

Tolerances, in float32 compute: the routing's `dispatch` equal bit for
bit (it is a 0/1 tensor: which assignment goes to which expert slot),
`combine` and the load-balancing loss within 1e-6 of their largest
magnitude; `moe_mlp`, the model's logits, prefill and decode steps within
1e-5 of the largest magnitude of the reference's output (the products sum
in another order, nothing else differs); the loss within rtol 1e-5 and
its gradients within 1e-4 of the largest, and in bfloat16 the loss within
rtol 2e-2, as `tests/test_torch_model.py` states. Greedy transcripts of
the two serving engines must be equal.

Lanes. A routing group is cut from the flattened B*S tokens of a call, so
where a group spans batch lanes they share its capacity, and the engine's
lane padding (copies of lane 0) takes capacity too: a lane's output then
depends on its neighbours (ROADMAP C7, a property of the reference that
the port keeps). Pinned here: where a group spans lanes, both packages
give the same transcripts and a co-admitted lane can differ from the same
prompt served alone; where every group lies inside one lane (prompt
lengths that are multiples of `ExecConfig.moe_group`) and decode never
drops (4 slots, capacity 4), co-admitted prompts decode bit for bit as
each served alone.
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
from repro.models import moe as ref_moe
from repro.models.model import Model as RefModel
from repro.models.transformer import ExecConfig as RefExecConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import moe
from repro_torch.models.model import Model, params_from_jax
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import Request, ServeEngine
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import few_threads  # noqa: F401  (autouse)

#: scale of the tied embedding table, in both packages alike, so greedy
#: transcripts depend on the stack and not only on the last prompt token
TABLE_SCALE = 0.05
F32 = torch.float32
ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]


def _cfgs(arch="olmoe-1b-7b", **overrides):
    overrides = {"compute_dtype": "float32", **overrides}
    rcfg = ref_reduced(ref_get_config(arch)).replace(**overrides)
    cfg = reduced(get_config(arch)).replace(**overrides)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_configs_are_moe(arch):
    _, cfg = _cfgs(arch)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_experts,
            cfg.experts_per_token, cfg.d_ff, cfg.capacity_factor) == \
        ("moe", 2, 64, 4, 2, 32, 1.25)
    assert cfg.qk_norm == (arch == "qwen3-moe-30b-a3b")


# ------------------------------------------------------------- routing

#: the reference's functions compiled whole (op by op, each of their many
#: small ops compiles on its own, which is most of this file's time)
_ref_routing = jax.jit(ref_moe._top_k_routing, static_argnums=(1, 2))
_ref_moe_mlp = jax.jit(ref_moe.moe_mlp, static_argnums=(2, 3, 4))


def _routing(logits: np.ndarray, k: int, capacity: int):
    want = _ref_routing(jnp.asarray(logits), k, capacity)
    got = moe._top_k_routing(torch.from_numpy(logits), k, capacity)
    return got, [np.asarray(w) for w in want]


def _check_routing(got, want):
    (d, c, aux), (wd, wc, waux) = got, want
    assert d.dtype == c.dtype == F32 and tuple(d.shape) == wd.shape
    assert np.array_equal(d.numpy(), wd)
    _close(c, wc, rel=1e-6)
    assert float(aux) == pytest.approx(float(waux), rel=1e-6)


@pytest.mark.parametrize("G,g,E,k,capacity,dropped", [
    (1, 20, 4, 2, 12, 2), (3, 16, 8, 2, 4, 15), (2, 64, 64, 8, 40, 0),
    (2, 64, 64, 8, 8, 141), (1, 7, 16, 4, 4, 1), (2, 33, 8, 3, 8, 70)])
def test_top_k_routing_matches_reference(G, g, E, k, capacity, dropped):
    """dispatch bit for bit, combine and the aux loss within 1e-6, on
    random logits; `dropped` assignments exceed capacity (olmoe's E 64,
    k 8 at a group of 64: capacity 40 drops none, 8 drops many)."""
    logits = np.random.default_rng(G * g + E).standard_normal(
        (G, g, E)).astype(np.float32) * 2
    got, want = _routing(logits, k, capacity)
    _check_routing(got, want)
    assert G * g * k - int(want[0].sum()) == dropped


@pytest.mark.parametrize("grid", ["half-integers", "bfloat16"])
def test_top_k_routing_breaks_ties_as_the_reference(grid):
    """Logits with exact ties at the k-th place: on a coarse grid, or
    random logits rounded to bfloat16 and given few distinct values, as
    the served path's bf16 router gives them. `jax.lax.top_k` puts the
    lower expert index first; `torch.topk` does not (asserted below: it
    picks other experts for some tokens, so a port on `torch.topk` fails
    this case), and the port's stable sort does."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 48, 16)).astype(np.float32)
    if grid == "half-integers":
        logits = np.round(x * 2) / 2
    else:
        logits = np.array(jnp.asarray(np.round(x * 4) / 4 + 1e-3,
                                      jnp.bfloat16).astype(jnp.float32))
    probs = torch.softmax(torch.from_numpy(logits), -1)
    top = torch.sort(probs, -1, descending=True).values
    assert (top[..., 3] == top[..., 4]).any()          # ties at the k-th
    _, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)
    topk = torch.topk(probs, 4).indices.sort(-1).values.numpy()
    assert not np.array_equal(topk, np.sort(np.asarray(want_idx), -1))
    got, want = _routing(logits, 4, 8)
    _check_routing(got, want)


def test_top_k_routing_queues_choice_major():
    """Every token's first choice is queued before any token's second.
    Tokens 0-3 rank expert 1 first and expert 0 second, tokens 4-5 rank
    expert 0 first and expert 2 second; at capacity 4 expert 0 takes the
    first choices of tokens 4, 5 (slots 0, 1), then the second choices of
    tokens 0, 1 (slots 2, 3), and drops those of tokens 2, 3 (a
    token-major queue would drop tokens 4, 5 instead)."""
    logits = np.array([[2.0, 3.0, 0.0, -1.0]] * 4
                      + [[3.0, 0.0, 2.0, -1.0]] * 2, np.float32)[None]
    (d, c, _), (wd, wc, _) = _routing(logits, 2, 4)
    assert np.array_equal(d.numpy(), wd)
    _close(c, wc, rel=1e-6)
    e0 = d[0, :, 0]                                   # (token, slot)
    assert e0.nonzero().tolist() == [[0, 2], [1, 3], [4, 0], [5, 1]]
    assert d[0, :4, 1].nonzero().tolist() == [[0, 0], [1, 1], [2, 2], [3, 3]]


# ------------------------------------------------------------ the layer

@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    rcfg, cfg = _cfgs(request.param)
    rp = jax.device_get(ref_moe.moe_init(jax.random.PRNGKey(0), rcfg,
                                         jnp.float32))
    x = np.random.default_rng(1).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, params_from_jax(rp, device="cpu"), x


@pytest.mark.parametrize("group", [256, 4])
def test_moe_mlp_matches_reference(layer, group):
    """One routing group of all 256 tokens (capacity 160), and 64 groups
    of 4 (capacity 4, so assignments drop)."""
    rcfg, cfg, rp, tp, x = layer
    want, waux = _ref_moe_mlp(rp, jnp.asarray(x), rcfg, jnp.float32, group)
    got, aux = moe.moe_mlp(tp, torch.from_numpy(x), cfg, F32,
                           group_size=group)
    _close(got, want)
    assert aux.dtype == F32
    assert float(aux) == pytest.approx(float(waux), rel=1e-5)


def test_moe_init_scale_is_the_reference_s(layer):
    """Expert leaves are drawn at 1/sqrt(E), the reference's scale (its
    `_init` takes a leaf's first axis as the fan-in), with and without a
    lead of stacked layers; the router at 1/sqrt(D)."""
    _, cfg, rp, _, _ = layer
    E, D = cfg.n_experts, cfg.d_model
    for lead in ((), (3,)):
        own = moe.moe_init(torch.Generator().manual_seed(0), cfg, "float32",
                           lead)
        assert {k: tuple(v.shape) for k, v in own.items()} == \
            {k: (*lead, *np.shape(v)) for k, v in rp.items()}
        for name in ("wi_gate", "wi_up", "wo"):
            for std in (float(own[name].std()), float(np.std(rp[name]))):
                assert std == pytest.approx(E ** -0.5, rel=0.1), name
        assert float(own["router"].std()) == pytest.approx(D ** -0.5,
                                                           rel=0.1)


# ------------------------------------------------------------ the model

def _models(arch="olmoe-1b-7b", attn_impl="pallas", **overrides):
    """(reference Model on chunked, port Model on `attn_impl`, reference
    params as numpy, port params on the CPU), table scaled in both."""
    rcfg, cfg = _cfgs(arch, **overrides)
    ref = RefModel(rcfg, RefExecConfig(attn_impl="chunked"))
    rp = jax.device_get(jax.jit(ref.init)(jax.random.PRNGKey(0)))
    rp["embedding"]["table"] = rp["embedding"]["table"] \
        * np.float32(TABLE_SCALE)
    port = Model(cfg, ExecConfig(attn_impl=attn_impl))
    return ref, port, rp, params_from_jax(rp, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def test_params_from_jax_carries_the_moe_tree(models):
    """Every leaf of the reference's moe tree (stack/layers/moe/{router,
    wi_gate, wi_up, wo} with lead L) arrives with its shape and bits, and
    the port's own init draws the same tree."""
    _, port, rp, tp = models
    want = {k: np.asarray(v) for k, v in _paths(rp).items()}
    got = {k: v.numpy() for k, v in _paths(tp).items()}
    assert sorted(got) == sorted(want)
    assert got["['stack']['layers']['moe']['wi_gate']"].shape == \
        (2, 4, 64, 32)
    assert got["['stack']['layers']['moe']['router']"].shape == (2, 64, 4)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    own = port.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _paths(own).items()} == \
        {k: v.shape for k, v in want.items()}
    assert len(tree_leaves(own)) == len(want)


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_logits_match_reference(models, attn_impl):
    """The logits, and the aux loss summed over the layers."""
    ref, port, rp, tp = models
    port = Model(port.cfg, ExecConfig(attn_impl=attn_impl))
    toks = np.random.default_rng(3).integers(1, 256, (2, 32))
    rl, raux = jax.jit(ref.logits)(rp,
                                   {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tl, aux = port.logits(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, rl)
    assert aux.dtype == F32 and float(aux) > 0
    assert float(aux) == pytest.approx(float(raux), rel=1e-5)


def _batch(cfg, seed=4):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 32))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def test_loss_and_grads_match_reference_fp32(models):
    """The training path (chunked attention, each layer recomputed in the
    backward pass, the aux loss carried out of the checkpointed layers
    into `0.01 * aux`)."""
    ref, port, rp, _ = models
    port = Model(port.cfg)
    jb, tb = _batch(port.cfg)
    (rl, rm), rg = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        rp, jb)
    tp = tree_map(lambda p: p.requires_grad_(),
                  params_from_jax(rp, device="cpu"))
    tl, tm = port.loss_fn(tp, tb)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    assert float(tl.detach()) == pytest.approx(float(rl), rel=1e-5)
    assert float(tm["aux"].detach()) == pytest.approx(float(rm["aux"]),
                                                      rel=1e-5)
    rg = jax.tree.leaves(rg)
    gmax = max(float(np.max(np.abs(np.asarray(g)))) for g in rg)
    assert len(rg) == len(tg)
    for a, b in zip(rg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4 * gmax)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_bf16(arch):
    ref, port, rp, tp = _models(arch, compute_dtype="bfloat16")
    port = Model(port.cfg)
    jb, tb = _batch(port.cfg)
    rl, _ = ref.loss_fn(rp, jb)
    with torch.no_grad():
        tl, _ = port.loss_fn(tp, tb)
    assert float(tl) == pytest.approx(float(rl), rel=2e-2)


DECODE_POS = (20, 21, np.array([22, 22], np.int32), 23)


@pytest.fixture(scope="module")
def ref_decode(models):
    """The reference's prefill of 2 x 20 tokens, then 4 decode steps on
    its greedy tokens: [(tokens fed, position, logits, state)], the
    prefill first (its position None)."""
    ref, _, rp, _ = models
    toks = np.random.default_rng(3).integers(1, 256, (2, 20))
    rl, rst = jax.jit(ref.prefill, static_argnums=2)(
        rp, {"tokens": jnp.asarray(toks, jnp.int32)}, 28)
    steps = [(toks, None, rl, rst)]
    step = jax.jit(ref.decode_step)
    for pos in DECODE_POS:
        nxt = np.array(jnp.argmax(rl[:, -1], -1))[:, None]
        rl, rst = step(rp, jnp.asarray(nxt, jnp.int32), rst,
                       jnp.asarray(pos, jnp.int32))
        steps.append((nxt, pos, rl, rst))
    return steps


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_prefill_and_decode_match_reference(models, ref_decode, attn_impl):
    """Prefill logits and KV caches, then 4 decode steps teacher-forced on
    the reference's greedy tokens, with a scalar and with per-row
    positions."""
    _, port, _, tp = models
    port = Model(port.cfg, ExecConfig(attn_impl=attn_impl))
    (toks, _, rl, rst), *steps = ref_decode
    with torch.no_grad():
        tl, tst = port.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               max_len=28)
    _close(tl, rl)
    for k in ("k", "v"):
        _close(tst[k], rst[k])
    for nxt, pos, rl, rst in steps:
        with torch.no_grad():
            tl, tst2 = port.decode_step(tp, torch.from_numpy(nxt), tst,
                                        torch.as_tensor(pos))
        assert tst2 is tst                    # updated in place
        _close(tl, rl)
        for k in ("k", "v"):
            _close(tst[k], rst[k])


def test_init_decode_state_is_the_dense_layout():
    """moe's decode state is the dense family's: KV caches (L, batch,
    max_len, Hkv, hd) in the compute dtype, batch on axis 1."""
    rcfg, cfg = _cfgs()
    for compute in ("float32", "bfloat16"):
        ref = RefModel(rcfg.replace(compute_dtype=compute))
        port = Model(cfg.replace(compute_dtype=compute))
        want = ref.init_decode_state(3, 24)
        got = port.init_decode_state(3, 24, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert port.decode_state_batch_axes() == {"k": 1, "v": 1}


# ------------------------------------------------------------ serving

PROMPTS = [[5, 6, 7, 8, 9], [9, 8, 7, 6, 5], [40, 41, 42],
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(60, 76)), [7] * 5,
           [100, 2]]


@pytest.fixture
def dropped(monkeypatch):
    """A list that gets, for every routing call of the port, the number
    of expert assignments its capacity dropped."""
    seen, inner = [], moe._top_k_routing

    def record(logits, k, capacity):
        out = inner(logits, k, capacity)
        seen.append(logits.shape[0] * logits.shape[1] * k
                    - int(out[0].sum()))
        return out

    monkeypatch.setattr(moe, "_top_k_routing", record)
    return seen


def _serve(model, params, prompts, engine=ServeEngine, request=Request,
           max_new=8, **kw):
    eng = engine(model, params, n_slots=4, max_len=40, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(request(rid=rid, prompt=list(p), max_new_tokens=max_new))
    return {r.rid: list(r.out) for r in eng.run_until_drained()}, eng


def test_engine_transcripts_match_reference(models, dropped):
    """The port's engine on `pallas` (F1's plain version on prefill)
    against the JAX engine on chunked, at n_slots 4, on a mixed request
    set. Every prefill call is one routing group across its 4 lanes."""
    ref, port, rp, tp = models
    want, _ = _serve(ref, rp, PROMPTS, RefServeEngine, RefRequest)
    got, eng = _serve(port, tp, PROMPTS)
    assert got == want
    assert eng.prefill_calls == 6
    assert len({tuple(v) for v in want.values()}) > 1   # not degenerate
    assert sum(dropped) > 0


def test_lanes_sharing_a_group_match_reference(models, dropped):
    """Three co-admitted 5-token prompts (one prefill call, lane-padded to
    4: one routing group of 20 tokens, capacity 12) give the reference's
    transcripts, with assignments dropped in that call; and the group
    couples lanes: a lane's transcript differs from the same prompt
    served alone (ROADMAP C7, as in the reference)."""
    ref, port, rp, tp = models
    prompts = [[20 + i, 30, 31 + i, 7, 9] for i in range(3)]
    want, _ = _serve(ref, rp, prompts, RefServeEngine, RefRequest)
    got, eng = _serve(port, tp, prompts)
    assert got == want and eng.prefill_calls == 1
    assert dropped[0] > 0 or dropped[1] > 0      # the call's two layers
    solo = {rid: _serve(port, tp, [p], prefill_batch=1)[0][0]
            for rid, p in enumerate(prompts)}
    assert solo != got


@pytest.mark.parametrize("group", [8, 16])
def test_batched_prefill_matches_solo_admission(models, dropped, group):
    """With `moe_group` dividing every prompt's length (16), each routing
    group lies inside one lane, and decode (4 slots: one group of 4,
    capacity 4) drops nothing: co-admitted prompts decode bit for bit as
    each served alone. At a group of 16 (capacity 12) prefill drops
    assignments; at 8 the capacity is 8 and nothing drops."""
    _, port, _, tp = models
    port = Model(port.cfg, ExecConfig(attn_impl="pallas", moe_group=group))
    prompts = [[20 + i, 30, 31 + i, 7, 9, 3, 1, 4] * 2 for i in range(3)]
    solo = {}
    for rid, p in enumerate(prompts):
        solo[rid] = _serve(port, tp, [p], prefill_batch=1)[0][0]
    got, eng = _serve(port, tp, prompts)
    assert got == solo and eng.prefill_calls == 1
    assert (sum(dropped) > 0) == (group == 16)
    assert len({tuple(v) for v in solo.values()}) == 3


def test_snapshot_restore_is_bit_identical(models):
    """A snapshot mid-decode restored into a new engine gives the straight
    run's transcripts and its final KV caches bit for bit."""
    _, port, _, tp = models
    want, straight = _serve(port, tp, PROMPTS)
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
    for k in ("k", "v"):
        assert torch.equal(second.state[k], straight.state[k]), k


@pytest.fixture
def torch_state():
    """The CLI sets global torch state (deterministic algorithms); put it
    back for the tests that run after in this process."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    yield
    torch.use_deterministic_algorithms(deterministic)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def test_serve_cli_serves_olmoe_on_the_cpu(capsys, torch_state):
    from repro_torch.launch.serve import main
    n = fa_ops.LAUNCHES["flash_attention"]
    assert main(["--device", "cpu", "--reduced", "--arch", "olmoe-1b-7b",
                 "--attn-impl", "pallas", "--requests", "5",
                 "--prompt-len", "12,12,12,7,30", "--max-new", "4",
                 "--max-len", "64", "--snapshot-every", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "olmoe-1b-7b-smoke"
    assert out["completed"] == 5 and out["tokens_generated"] == 20
    assert out["prefill_calls"] == 3 and out["snapshot_taken"]
    assert out["device"] == "cpu" and out["attn_impl"] == "pallas"
    assert fa_ops.LAUNCHES["flash_attention"] == n      # no kernel on a CPU


# ------------------------------------------------------ on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_model(cuda, attn_impl, compute_dtype):
    cfg = reduced(get_config("olmoe-1b-7b")).replace(
        compute_dtype=compute_dtype)
    model = Model(cfg, ExecConfig(attn_impl=attn_impl))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    params["embedding"]["table"].mul_(TABLE_SCALE)
    toks = torch.randint(0, cfg.vocab_size, (4, 77), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    return model, params, toks


@pytest.mark.gpu
def test_pallas_prefill_matches_chunked_on_the_card(cuda):
    """Reduced olmoe in float32 compute: prefill logits with F1 (its FMA
    kernel) within 1e-5 of the largest of the chunked route's, and the KV
    caches alike."""
    model, params, toks = _card_model(cuda, "pallas", "float32")
    chunked = Model(model.cfg, ExecConfig(attn_impl="chunked"))
    n = fa_ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        lp, sp = model.prefill(params, {"tokens": toks}, max_len=96)
        lc, sc = chunked.prefill(params, {"tokens": toks}, max_len=96)
    assert fa_ops.LAUNCHES["flash_attention"] == n + model.cfg.n_layers
    for got, want in ((lp, lc), (sp["k"], sc["k"]), (sp["v"], sc["v"])):
        _close(got.cpu(), want.cpu().numpy())


@pytest.mark.gpu
def test_repeated_prefill_is_bit_identical_on_the_card(cuda):
    """The served dtype (bf16): two prefill calls on the same input give
    the same logits and KV caches bit for bit (the routing's sort,
    cumsum and scatter are deterministic on the card)."""
    model, params, toks = _card_model(cuda, "pallas", "bfloat16")
    with torch.no_grad():
        a = model.prefill(params, {"tokens": toks}, max_len=96)
        b = model.prefill(params, {"tokens": toks}, max_len=96)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in ("k", "v"))
