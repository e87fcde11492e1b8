"""Prefill, decode and the serving engine of the port against the JAX
package, and the engine's semantics (ported from `tests/test_serve.py`).

Parity runs reduced qwen2-7b in float32 compute with the reference's
parameters (`_torch_serve_model`). Tolerances: prefill and decode logits
and KV caches within 1e-5 of the largest magnitude (sums run in another
order, nothing else differs). The port's engine runs `attn_impl="pallas"`
(kernel F1's plain version on the CPU) against the JAX engine on
`chunked`, the reference's plain path (its Pallas kernel runs outside
interpret mode only on a TPU); greedy transcripts must be equal.

Semantics pinned here, within the port:
  * a request gets exactly max_new_tokens decode-step tokens on top of
    the one token its prefill emits;
  * ragged slot occupancy (per-slot positions) and co-admitted prefill
    decode bit-identically to the same engine serving each request alone;
  * snapshot/restore round-trips the whole churn — state, slot table
    (done flags, emission watermarks) and the pending queue;
  * the emission watermark delivers each token exactly once;
  * repeated prompts reuse their prefill through the LRU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.serve import Request, ServeEngine
from _torch_serve_model import serve_models
from _torch_threads import few_threads  # noqa: F401  (autouse)


def _close(got: torch.Tensor, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ------------------------------------------------ parity with the reference

@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_prefill_and_decode_match_reference(n_kv_heads):
    """Full-sequence logits, prefill logits and KV caches, then decode
    with a scalar and with per-row positions."""
    ref, port, rp, tp = serve_models(n_kv_heads=n_kv_heads)
    toks = np.random.default_rng(3).integers(1, 256, (2, 10))
    rl, _ = ref.logits(rp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tl, _ = port.logits(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, rl)
    rl, rst = ref.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          max_len=16)
    with torch.no_grad():
        tl, tst = port.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               max_len=16)
    assert tuple(tl.shape) == rl.shape == (2, 1, 256)
    _close(tl, rl)
    for k in ("k", "v"):
        assert tuple(tst[k].shape) == rst[k].shape
        _close(tst[k], rst[k])

    # decode with a scalar position, then with per-row positions
    nxt = np.array(jnp.argmax(rl[:, -1], -1))[:, None]
    assert np.array_equal(tl[:, -1].argmax(-1).numpy()[:, None], nxt)
    for pos in (10, np.array([10, 6], np.int32)):
        rl, rst = ref.decode_step(rp, jnp.asarray(nxt, jnp.int32), rst,
                                  jnp.asarray(pos))
        with torch.no_grad():
            tl, tst = port.decode_step(tp, torch.from_numpy(nxt), tst,
                                       torch.as_tensor(pos))
        _close(tl, rl)
        for k in ("k", "v"):
            _close(tst[k], rst[k])
        nxt = np.array(jnp.argmax(rl[:, 0], -1))[:, None]


def test_engine_transcripts_match_reference():
    ref, port, rp, tp = serve_models()
    prompts = [[5, 6, 7, 8, 9], [9, 8, 7, 6, 5], [40, 41, 42],
               [3, 1, 4, 1, 5, 9, 2, 6], [11, 22, 33], [7] * 5]

    def run(engine_cls, req_cls, model, params):
        eng = engine_cls(model, params, n_slots=4, max_len=32)
        for rid, p in enumerate(prompts):
            eng.submit(req_cls(rid=rid, prompt=list(p), max_new_tokens=8))
        return {r.rid: list(r.out) for r in eng.run_until_drained()}

    want = run(RefServeEngine, RefRequest, ref, rp)
    got = run(ServeEngine, Request, port, tp)
    assert got == want
    assert len({tuple(v) for v in want.values()}) > 1   # not degenerate


# ------------------------------------------------------- engine semantics

@pytest.fixture(scope="module")
def setup():
    _, port, _, tp = serve_models(compute_dtype="bfloat16")
    return port, tp


@pytest.mark.parametrize("n_slots,n_req,prompt,max_new", [
    (3, 7, list(range(3, 13)), 5),       # batched requests complete
    (2, 6, [1, 2, 3], 3),                # slot recycling, more than slots
])
def test_requests_complete(setup, n_slots, n_req, prompt, max_new):
    model, params = setup
    eng = ServeEngine(model, params, n_slots=n_slots, max_len=64)
    reqs = [Request(rid=i, prompt=list(prompt), max_new_tokens=max_new)
            for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert all(r.done for r in reqs)
    # prefill emits one token, decode adds exactly max_new_tokens
    assert all(len(r.out) == max_new + 1 for r in reqs)
    assert sorted(r.rid for r in done) == list(range(n_req))


def _solo(model, params, prompt, max_new, **kw):
    eng = ServeEngine(model, params, max_len=64, **kw)
    eng.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=max_new))
    r, = eng.run_until_drained()
    return r.out


def test_ragged_occupancy_matches_solo_decode(setup):
    """Slots admitted at staggered steps each produce exactly what the
    same engine produces serving that request alone."""
    model, params = setup
    solo = {rid: _solo(model, params, [10 + rid] * 4, 6, n_slots=3)
            for rid in range(3)}
    eng = ServeEngine(model, params, n_slots=3, max_len=64,
                      prefill_batch=1)
    eng.submit(Request(rid=0, prompt=[10] * 4, max_new_tokens=6))
    eng.step(); eng.step()
    eng.submit(Request(rid=1, prompt=[11] * 4, max_new_tokens=6))
    eng.step()
    eng.submit(Request(rid=2, prompt=[12] * 4, max_new_tokens=6))
    for r in eng.run_until_drained():
        assert r.out == solo[r.rid], f"rid {r.rid} diverged under raggedness"


def test_batched_prefill_matches_solo_admission(setup):
    """Co-admitted same-length prompts (one prefill call, lane-padded to
    the fixed width) decode identically to solo admission."""
    model, params = setup
    solo = {rid: _solo(model, params, [20 + rid] * 5, 4, n_slots=4,
                       prefill_batch=1) for rid in range(3)}
    eng = ServeEngine(model, params, n_slots=4, max_len=64,
                      prefill_batch=4)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[20 + rid] * 5,
                           max_new_tokens=4))
    for r in eng.run_until_drained():
        assert r.out == solo[r.rid]
    assert eng.prefill_calls == 1


def test_admission_fills_every_layer_of_the_slot(setup):
    """With n_layers == n_slots == prefill_batch (2), the admitted slot's
    KV cache equals a solo prefill's in every layer. The reference finds
    the batch axis by its size and takes the layer axis here (ROADMAP
    C2); the port writes along the batch axis."""
    model, params = setup
    assert model.cfg.n_layers == 2
    prompt = [5, 6, 7, 8, 30, 100]
    _, st = model.prefill(params, {"tokens": torch.tensor([prompt])}, 64)
    eng = ServeEngine(model, params, n_slots=2, max_len=64)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng._admit()
    for k in ("k", "v"):
        assert torch.equal(eng.state[k][:, 0], st[k][:, 0])
        assert not eng.state[k][:, 1].any()


def test_snapshot_restore_into_new_engine(setup):
    model, params = setup
    eng = ServeEngine(model, params, n_slots=2, max_len=64)
    eng.submit(Request(rid=0, prompt=list(range(1, 9)), max_new_tokens=8))
    eng.step(); eng.step()
    snap = eng.snapshot()
    eng.step(); eng.step()
    expected = [s.out for s in eng.slots if s][0]

    eng2 = ServeEngine(model, params, n_slots=2, max_len=64)
    eng2.restore(snap)
    eng2.step(); eng2.step()
    assert [s.out for s in eng2.slots if s][0] == expected


def test_snapshot_mutate_restore_bit_identity(setup):
    """snapshot -> keep decoding -> restore must replay the exact same
    tokens, with the pending queue and done flags intact, twice (the
    snapshot owns copies the in-place decode does not touch)."""
    model, params = setup
    eng = ServeEngine(model, params, n_slots=2, max_len=64)
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=[3, 4, 5 + rid],
                           max_new_tokens=6))
    eng.step(); eng.step(); eng.step()
    snap = eng.snapshot()
    queued_at_snap = [r.rid for r in eng.queue]
    assert queued_at_snap, "test needs a non-empty pending queue"

    expected = {r.rid: list(r.out) for r in eng.run_until_drained()}
    state_after = {k: v.clone() for k, v in eng.state.items()}
    assert len(expected) == 5
    for _ in range(2):
        eng.restore(snap)
        assert [r.rid for r in eng.queue] == queued_at_snap
        eng.completed = []
        replayed = {r.rid: list(r.out) for r in eng.run_until_drained()}
        assert replayed == {k: expected[k] for k in replayed}
        assert sorted(replayed) == list(range(5))
        assert all(torch.equal(eng.state[k], state_after[k])
                   for k in state_after)


def test_restore_roundtrips_done_flag(setup):
    model, params = setup
    eng = ServeEngine(model, params, n_slots=2, max_len=64)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=1))
    eng.run_until_drained()
    snap = eng.snapshot()
    assert snap["slots"] == [None, None]      # finished slots were freed
    done_req = eng.completed[0]
    assert done_req.done
    r = Request.from_dict(done_req.to_dict())
    assert r.done and r.out == done_req.out and r.emitted == done_req.emitted


def test_emission_watermark_exactly_once(setup):
    """Every token reaches the sink exactly once, in order; a watermark
    ahead of `out` (what recovery sets) suppresses re-delivery."""
    model, params = setup
    got = []
    eng = ServeEngine(model, params, n_slots=2, max_len=64,
                      sink=lambda rid, idx, tok: got.append((rid, idx, tok)))
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[7, 8, 9], max_new_tokens=4))
    done = eng.run_until_drained()
    per: dict = {}
    for rid, idx, tok in got:
        assert idx == len(per.setdefault(rid, []))   # in order, no gap
        per[rid].append(tok)
    for r in done:
        assert per[r.rid] == r.out             # every token exactly once

    replay = []
    eng2 = ServeEngine(model, params, n_slots=2, max_len=64,
                       sink=lambda rid, idx, tok: replay.append((idx, tok)))
    req = Request(rid=0, prompt=[7, 8, 9], max_new_tokens=4)
    req.emitted = 3                            # client already holds 3
    eng2.submit(req)
    eng2.run_until_drained()
    assert [i for i, _ in replay] == [3, 4]    # only the tail delivered
    assert [t for _, t in replay] == per[0][3:]


def test_prefill_cache_reuses_repeated_prompts(setup):
    """The prefill LRU kicks in on a prompt's second repeat: the third
    identical submission admits without a model prefill call, and its
    output is unchanged."""
    model, params = setup
    eng = ServeEngine(model, params, n_slots=2, max_len=64,
                      prefill_cache=4)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[9, 9, 9], max_new_tokens=3))
        eng.run_until_drained()
    outs = [r.out for r in eng.completed]
    assert outs[0] == outs[1] == outs[2]
    assert eng.prefill_calls == 2             # third admission hit the LRU


def test_max_len_truncates_generation(setup):
    model, params = setup
    eng = ServeEngine(model, params, n_slots=1, max_len=16)
    eng.submit(Request(rid=0, prompt=[1] * 10, max_new_tokens=50))
    r, = eng.run_until_drained()
    assert r.done
    assert len(r.out) == 16 - 10              # max_len - len(prompt)


def test_submit_rejects_oversized_prompt(setup):
    model, params = setup
    eng = ServeEngine(model, params, n_slots=1, max_len=16)
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=[1] * 15, max_new_tokens=1))


def test_mesh_engine_is_not_ported(setup):
    """The sharded engine is ported (its runs on a mesh are in
    test_torch_sharded.py); a mesh without sharding rules raises the
    reference's ValueError before anything is placed."""
    model, params = setup
    with pytest.raises(ValueError, match="mesh requires sharding rules"):
        ServeEngine(model, params, mesh=object())


# ------------------------------------------------------------ serve CLI

@pytest.fixture
def torch_state():
    """The CLI sets global torch state (deterministic algorithms); put it
    back for the tests that run after in this process."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    yield
    torch.use_deterministic_algorithms(deterministic)
    torch.utils.deterministic.fill_uninitialized_memory = fill


def test_serve_cli_on_the_cpu(capsys, torch_state):
    import json
    from repro.launch.serve import main as ref_main
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", "--reduced", "--arch", "qwen2-7b",
                 "--attn-impl", "pallas", "--requests", "5",
                 "--prompt-len", "12,12,12,7,30", "--max-new", "4",
                 "--max-len", "64", "--snapshot-every", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["completed"] == 5 and out["tokens_generated"] == 20
    assert out["prefill_calls"] == 3 and out["snapshot_taken"]
    assert out["device"] == "cpu" and out["attn_impl"] == "pallas"
    assert ref_main(["--reduced", "--requests", "2", "--prompt-len", "5",
                     "--max-new", "2", "--max-len", "16"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert set(ref) <= set(out)
    with pytest.raises(ValueError, match="2 lengths for 5 requests"):
        main(["--device", "cpu", "--reduced", "--requests", "5",
              "--prompt-len", "4,5"])
