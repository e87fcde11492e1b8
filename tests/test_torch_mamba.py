"""The Mamba1 block, the ssm model and ssm serving of the port against the
JAX package, on reduced falcon-mamba-7b (2 layers, d_model 64, d_inner
128, ds 8, ssm_chunk 16) with the reference's parameters.

Tolerances, in float32 compute: the block's functions within 1e-5 of the
largest magnitude of the reference's output (the scans sum in another
order, nothing else differs), tighter than the reference's own 2e-3 for
its kernel binding (`tests/test_mamba_kernel_integration.py`); model
logits and states within 1e-5 of the largest magnitude. Greedy transcripts
of the two serving engines must be equal.

Also pinned here: the port's fixes of two faults of the reference's
prefill (ROADMAP C3, C4) and its routing of prefill through the kernel
under `attn_impl="pallas"` (C5).
"""
import dataclasses

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
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import mamba
from repro_torch.models.model import Model, params_from_jax
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import Request, ServeEngine
from _torch_threads import few_threads  # noqa: F401  (autouse)

#: scale of the tied embedding table, in both packages alike, so greedy
#: transcripts depend on the scan and not only on the last prompt token
TABLE_SCALE = 0.05
F32 = torch.float32


def _cfgs(**overrides):
    rcfg = ref_reduced(ref_get_config("falcon-mamba-7b")).replace(
        compute_dtype="float32", **overrides)
    cfg = reduced(get_config("falcon-mamba-7b")).replace(
        compute_dtype="float32", **overrides)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    return rcfg, cfg


def _close(got: torch.Tensor, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ------------------------------------------------------------ the block

@pytest.fixture(scope="module")
def block():
    rcfg, cfg = _cfgs()
    rp = jax.device_get(ref_mamba.mamba1_init(jax.random.PRNGKey(0), rcfg,
                                              jnp.float32))
    x = np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, params_from_jax(rp, device="cpu"), x


def test_mamba1_forward_matches_reference(block):
    rcfg, cfg, rp, tp, x = block
    want = ref_mamba.mamba1_forward(rp, jnp.asarray(x), rcfg, jnp.float32)
    got = mamba.mamba1_forward(tp, torch.from_numpy(x), cfg, F32)
    _close(got, want)


def test_mamba1_forward_pallas_matches_reference(block):
    """The kernel binding against the reference's binding with its Pallas
    kernel in interpret mode, and against the chunked forward."""
    rcfg, cfg, rp, tp, x = block
    want = ref_mamba.mamba1_forward_pallas(rp, jnp.asarray(x), rcfg,
                                           jnp.float32, interpret=True,
                                           chunk=16, block_d=32)
    got = mamba.mamba1_forward_pallas(tp, torch.from_numpy(x), cfg, F32)
    _close(got, want)
    _close(got, mamba.mamba1_forward(tp, torch.from_numpy(x), cfg, F32))


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mamba1_forward_with_state_matches_reference(block, impl):
    """Both scan routes of prefill against the reference's (chunked) one:
    output, final state h and conv tail."""
    rcfg, cfg, rp, tp, x = block
    want, wst = ref_mamba.mamba1_forward_with_state(rp, jnp.asarray(x), rcfg,
                                                    jnp.float32)
    got, st = mamba.mamba1_forward_with_state(tp, torch.from_numpy(x), cfg,
                                              F32, impl=impl)
    _close(got, want)
    for k in ("h", "conv"):
        assert st[k].dtype == F32
        _close(st[k], wst[k])


def test_mamba1_step_matches_reference(block):
    """Ten decode steps from the prefill state, each against the
    reference's step."""
    rcfg, cfg, rp, tp, x = block
    _, wst = ref_mamba.mamba1_forward_with_state(rp, jnp.asarray(x[:, :16]),
                                                 rcfg, jnp.float32)
    _, st = mamba.mamba1_forward_with_state(tp, torch.from_numpy(x[:, :16]),
                                            cfg, F32)
    for t in range(16, 26):
        want, wst = ref_mamba.mamba1_step(rp, jnp.asarray(x[:, t:t + 1]), wst,
                                          rcfg, jnp.float32)
        got, st = mamba.mamba1_step(tp, torch.from_numpy(x[:, t:t + 1]), st,
                                    cfg, F32)
        _close(got, want)
        for k in ("h", "conv"):
            _close(st[k], wst[k])


def test_chunk_scan_stays_finite_where_decay_underflows():
    """At large dt·|A| the decay exp(dt·A) underflows to 0: the scan must
    reset the state there, not divide by it (a cumprod/cumsum form gives
    inf or NaN)."""
    rng = np.random.default_rng(4)
    dA = np.exp(-np.abs(rng.standard_normal((1, 16, 4, 8))) * 200) \
        .astype(np.float32)
    dBx = rng.standard_normal((1, 16, 4, 8)).astype(np.float32)
    h0 = rng.standard_normal((1, 4, 8)).astype(np.float32)
    assert (dA == 0).any()
    hs, h = mamba._chunk_scan_m1(*map(torch.from_numpy, (dA, dBx, h0)))
    ref_hs, ref_h = ref_mamba._chunk_scan_m1(*map(jnp.asarray,
                                                  (dA, dBx, h0)))
    assert torch.isfinite(hs).all()
    _close(hs, ref_hs)
    _close(h, ref_h)


def test_mamba2_is_not_ported():
    """Earlier slices of the port refused Mamba2 (`ssm_version=2`) with a
    NotImplementedError; it is ported now, so `mamba_init` draws the
    reference's Mamba2 tree: the same keys, each leaf of the same shape,
    and none of Mamba1's."""
    rcfg, cfg = _cfgs(ssm_version=2)
    want = jax.device_get(ref_mamba.mamba_init(jax.random.PRNGKey(0), rcfg,
                                               jnp.float32))
    got = mamba.mamba_init(torch.Generator().manual_seed(0), cfg, "float32")
    assert sorted(got) == sorted(want)
    assert "in_bc" in got and "x_proj" not in got
    assert {k: tuple(v.shape) for k, v in got["norm"].items()} == \
        {k: np.shape(v) for k, v in want["norm"].items()}
    assert {k: tuple(v.shape) for k, v in got.items() if k != "norm"} == \
        {k: np.shape(v) for k, v in want.items() if k != "norm"}


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


def test_params_from_jax_carries_the_ssm_tree(models):
    """Every leaf of the reference's ssm tree (stack/layers/ln,
    stack/layers/mamba/*) arrives with its shape and bits, and the port's
    own init draws the same tree."""
    from repro_torch.tree import tree_leaves
    _, port, rp, tp = models
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat(rp)}
    got = {jax.tree_util.keystr(k): v.numpy() for k, v in flat(tp)}
    assert sorted(got) == sorted(want)
    assert "['stack']['layers']['mamba']['A_log']" in got
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    own = port.init(torch.Generator().manual_seed(0))
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat(own)} \
        == {k: v.shape for k, v in want.items()}
    assert len(tree_leaves(own)) == len(want)


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_logits_prefill_decode_match_reference(attn_impl):
    ref, port, rp, tp = _models(attn_impl)
    toks = np.random.default_rng(3).integers(1, 256, (2, 32))
    rl, _ = ref.logits(rp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tl, _ = port.logits(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, rl)
    rl, rst = ref.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          max_len=40)
    with torch.no_grad():
        tl, tst = port.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               max_len=40)
    _close(tl, rl)
    for k in ("h", "conv"):
        _close(tst[k], rst[k])
    nxt = np.array(jnp.argmax(rl[:, -1], -1))[:, None]
    for pos in range(32, 36):
        rl, rst = ref.decode_step(rp, jnp.asarray(nxt, jnp.int32), rst,
                                  jnp.int32(pos))
        with torch.no_grad():
            tl, tst = port.decode_step(tp, torch.from_numpy(nxt), tst,
                                       torch.tensor(pos))
        _close(tl, rl)
        for k in ("h", "conv"):
            _close(tst[k], rst[k])
        nxt = np.array(jnp.argmax(rl[:, 0], -1))[:, None]


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_decode_matches_forward(attn_impl):
    """`tests/test_models_smoke.py::test_decode_matches_forward` for the
    ssm arch, in the port: teacher-forced decode agrees with the parallel
    forward (the reference's own bf16 tolerance, and 1e-5 in float32)."""
    cfg = reduced(get_config("falcon-mamba-7b"))
    for compute, atol, rtol in (("bfloat16", 0.25, 0.1),
                                ("float32", 1e-5, 1e-5)):
        model = Model(cfg.replace(compute_dtype=compute),
                      ExecConfig(attn_impl=attn_impl))
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (1, 16),
                             generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            full, _ = model.logits(params, {"tokens": toks})
            lp, state = model.prefill(params, {"tokens": toks[:, :8]},
                                      max_len=20)
            torch.testing.assert_close(lp[0, -1].float(), full[0, 7].float(),
                                       atol=atol, rtol=rtol)
            for i in range(8, 12):
                ld, state = model.decode_step(params, toks[:, i:i + 1],
                                              state, torch.tensor(i))
                torch.testing.assert_close(ld[0, 0].float(),
                                           full[0, i].float(), atol=atol,
                                           rtol=rtol)


def test_loss_backward_runs_on_the_chunked_scan(models):
    """The training forward keeps the chunked scan under every attn_impl:
    it has a gradient, where S1 has none."""
    _, port, _, tp = models
    tp = {k: v for k, v in tp.items()}
    leaf = tp["stack"]["layers"]["mamba"]["in_x"].clone().requires_grad_()
    tp["stack"] = {"layers": {**tp["stack"]["layers"],
                              "mamba": {**tp["stack"]["layers"]["mamba"],
                                        "in_x": leaf}}}
    toks = torch.randint(0, 256, (2, 16),
                         generator=torch.Generator().manual_seed(5))
    loss, _ = port.loss_fn(tp, {"tokens": toks, "labels": toks})
    loss.backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    assert leaf.grad.abs().sum() > 0


# ------------------------------------------- faults of the reference's prefill

def test_c3_short_prompt_conv_state_is_padded(models):
    """ROADMAP C3: a 2-token prompt (shorter than ssm_conv - 1 = 3). The
    reference's prefill returns a conv state of 2 rows where decode wants
    3 (and its next decode step fails); the port left-pads it with the
    conv's zeros, and prefill + teacher-forced decode then match the
    forward's logits."""
    ref, port, rp, tp = models
    toks = np.random.default_rng(6).integers(1, 256, (1, 8))
    _, rst = ref.prefill(rp, {"tokens": jnp.asarray(toks[:, :2], jnp.int32)},
                         max_len=16)
    assert rst["conv"].shape == (2, 1, 2, 128)          # the fault
    with torch.no_grad():
        full, _ = port.logits(tp, {"tokens": torch.from_numpy(toks)})
        lp, st = port.prefill(tp, {"tokens": torch.from_numpy(toks[:, :2])},
                              max_len=16)
        assert tuple(st["conv"].shape) == (2, 1, 3, 128)
        _close(lp[:, 0], full[:, 1].numpy())
        for i in range(2, 8):
            ld, st = port.decode_step(
                tp, torch.from_numpy(toks[:, i:i + 1]), st, torch.tensor(i))
            _close(ld[:, 0], full[:, i].numpy())


def test_c4_chunked_route_names_its_chunk_rule():
    """ROADMAP C4: the chunked scan needs S % min(ssm_chunk, S) == 0. At
    S 200 with ssm_chunk 16 the reference fails in a reshape; the port's
    chunked route raises a ValueError that names the rule, and the pallas
    route serves it, agreeing with the reference run at ssm_chunk 8 (200
    = 25 x 8, the same function)."""
    ref, chunked, rp, tp = _models("chunked")
    toks = np.random.default_rng(7).integers(1, 256, (1, 200))
    batch = {"tokens": torch.from_numpy(toks)}
    with pytest.raises(ValueError, match="ssm_chunk"):
        chunked.prefill(tp, batch, max_len=256)
    with pytest.raises(TypeError, match="reshape"):
        ref.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                    max_len=256)
    ref8 = RefModel(ref.cfg.replace(ssm_chunk=8),
                    RefExecConfig(attn_impl="chunked"))
    rl, rst = ref8.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           max_len=256)
    pallas = Model(chunked.cfg, ExecConfig(attn_impl="pallas"))
    with torch.no_grad():
        tl, tst = pallas.prefill(tp, batch, max_len=256)
    _close(tl, rl)
    for k in ("h", "conv"):
        _close(tst[k], rst[k])


# ------------------------------------------------------------ serving

PROMPTS = [[5, 6, 7, 8, 9], [9, 8, 7, 6, 5], [40, 41, 42],
           [3, 1, 4, 1, 5, 9, 2, 6], [11, 22, 33], [7] * 5, [100, 2]]


def _run(engine_cls, req_cls, model, params, **kw):
    eng = engine_cls(model, params, n_slots=4, max_len=32, **kw)
    for rid, p in enumerate(PROMPTS):
        eng.submit(req_cls(rid=rid, prompt=list(p), max_new_tokens=8))
    return {r.rid: list(r.out) for r in eng.run_until_drained()}, eng


def test_engine_transcripts_match_reference(models):
    """The port's engine on `pallas` (S1's plain version on prefill)
    against the JAX engine on its chunked scan, at n_slots 4 (n_slots ==
    n_layers == 2 would hit C2 in the reference). The 2-token prompt is
    served only by the port: the reference's short conv state (C3) breaks
    its decode step."""
    ref, port, rp, tp = models
    n = len(PROMPTS) - 1
    eng = RefServeEngine(ref, rp, n_slots=4, max_len=32)
    for rid, p in enumerate(PROMPTS[:n]):
        eng.submit(RefRequest(rid=rid, prompt=list(p), max_new_tokens=8))
    want = {r.rid: list(r.out) for r in eng.run_until_drained()}
    got, _ = _run(ServeEngine, Request, port, tp)
    assert {k: got[k] for k in want} == want
    assert len(got[n]) == 9
    assert len({tuple(v) for v in want.values()}) > 1   # not degenerate


def test_engine_state_is_the_ssm_state(models):
    _, port, _, tp = models
    eng = ServeEngine(port, tp, n_slots=3, max_len=32)
    assert {k: tuple(v.shape) for k, v in eng.state.items()} == \
        {"h": (2, 3, 128, 8), "conv": (2, 3, 3, 128)}
    assert all(v.dtype == F32 for v in eng.state.values())


def test_batched_prefill_matches_solo_admission(models):
    """Co-admitted prompts of one length (one prefill call, lane-padded to
    4) decode bit-identically to each prompt served alone."""
    _, port, _, tp = models
    solo = {}
    for rid in range(3):
        eng = ServeEngine(port, tp, n_slots=4, max_len=32, prefill_batch=1)
        eng.submit(Request(rid=rid, prompt=[20 + rid] * 5, max_new_tokens=6))
        r, = eng.run_until_drained()
        solo[rid] = r.out
    eng = ServeEngine(port, tp, n_slots=4, max_len=32)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[20 + rid] * 5, max_new_tokens=6))
    assert {r.rid: r.out for r in eng.run_until_drained()} == solo
    assert eng.prefill_calls == 1


def test_snapshot_restore_is_bit_identical(models):
    """A snapshot mid-decode restored into a new engine gives the straight
    run's transcripts and final {h, conv} state, bit for bit."""
    _, port, _, tp = models
    want, straight = _run(ServeEngine, Request, port, tp)
    first = ServeEngine(port, tp, n_slots=4, max_len=32)
    for rid, p in enumerate(PROMPTS):
        first.submit(Request(rid=rid, prompt=list(p), max_new_tokens=8))
    for _ in range(5):
        first.step()
    snap = first.snapshot()
    assert snap["queue"], "the snapshot should hold queued requests"
    for _ in range(3):          # the live state moves on, in place
        first.step()
    second = ServeEngine(port, tp, n_slots=4, max_len=32)
    second.restore(snap)
    got = {r.rid: list(r.out) for r in second.run_until_drained()}
    assert {**{r.rid: list(r.out) for r in first.completed}, **got} == want
    for k in ("h", "conv"):
        assert torch.equal(second.state[k], straight.state[k])


def test_prefill_cache_reuses_ssm_lanes(models):
    _, port, _, tp = models
    eng = ServeEngine(port, tp, n_slots=2, max_len=32, prefill_cache=4)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[9, 9, 9], max_new_tokens=3))
        eng.run_until_drained()
    outs = [r.out for r in eng.completed]
    assert outs[0] == outs[1] == outs[2]
    assert eng.prefill_calls == 2


@pytest.fixture
def torch_state():
    """The CLI sets global torch state (deterministic algorithms); put it
    back for the tests that run after in this process."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    yield
    torch.use_deterministic_algorithms(deterministic)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def test_serve_cli_serves_falcon_mamba_on_the_cpu(capsys, torch_state):
    import json
    from repro_torch.launch.serve import main
    n = scan_ops.LAUNCHES["selective_scan"]
    assert main(["--device", "cpu", "--reduced", "--arch", "falcon-mamba-7b",
                 "--attn-impl", "pallas", "--requests", "5",
                 "--prompt-len", "12,12,12,2,30", "--max-new", "4",
                 "--max-len", "64", "--snapshot-every", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "falcon-mamba-7b-smoke"
    assert out["completed"] == 5 and out["tokens_generated"] == 20
    assert out["prefill_calls"] == 3 and out["snapshot_taken"]
    assert out["device"] == "cpu" and out["attn_impl"] == "pallas"
    assert scan_ops.LAUNCHES["selective_scan"] == n     # no kernel on a CPU
