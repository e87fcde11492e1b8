"""The harness with the timed path broken underneath: each fault a
serving cell can have must turn `correct` false. Tiny cells on the CPU,
the same harness as a run on the card (`bench.run`); the card's check is
skipped and the limit is the tiny configuration's own.

The faults: a decode step that returns its state unchanged; half of the
batch left out (the upper half of the decode lanes given the lower
half's logits); a token altered where it is produced (lane 0's token,
every decode step); an answer cut short (a request's last token never
delivered); a token delivered twice; an answer one token too long. One
card runs no exchange between chips."""
import contextlib

import pytest
import torch

from ftbench.harness import bench


@contextlib.contextmanager
def _patched(cls, name, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def state_unchanged():
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    def make(decode):
        def broken(self, params, token, state, pos):
            logits, _ = decode(self, params, token,
                               tree_map(lambda t: t.clone(), state), pos)
            return logits, state
        return broken
    return _patched(Model, "decode_step", make)


def half_batch():
    from repro_torch.models.model import Model

    def make(decode):
        def broken(self, params, token, state, pos):
            logits, state = decode(self, params, token, state, pos)
            h = logits.shape[0] // 2
            return torch.cat([logits[:h], logits[:h]]), state
        return broken
    return _patched(Model, "decode_step", make)


def token_altered():
    from repro_torch.models.model import Model

    def make(decode):
        def broken(self, params, token, state, pos):
            logits, state = decode(self, params, token, state, pos)
            logits = logits.clone()
            a = int(logits[0, 0].argmax())
            logits[0, 0, (a + 1) % logits.shape[-1]] = logits[0, 0, a] + 1e3
            return logits, state
        return broken
    return _patched(Model, "decode_step", make)


def answer_cut():
    from repro_torch.serve.engine import ServeEngine

    def make(flush):
        def broken(self, req):
            if req.rid == 1 and req.done:
                req.out = req.out[:-1]
            return flush(self, req)
        return broken
    return _patched(ServeEngine, "_flush", make)


def token_twice():
    from repro_torch.serve.engine import ServeEngine

    def make(flush):
        def broken(self, req):
            first = req.emitted == 0
            flush(self, req)
            if req.rid == 1 and first and req.emitted:
                self.sink(req.rid, 0, req.out[0])
        return broken
    return _patched(ServeEngine, "_flush", make)


def answer_long():
    from repro_torch.serve.engine import ServeEngine

    def make(flush):
        def broken(self, req):
            if req.rid == 1 and req.done and len(req.out) == \
                    req.max_new_tokens + 1:
                req.out = req.out + req.out[-1:]
            return flush(self, req)
        return broken
    return _patched(ServeEngine, "_flush", make)


FAULTS = {"state_unchanged": (state_unchanged, "max_logit_gap"),
          "half_batch": (half_batch, "max_logit_gap"),
          "token_altered": (token_altered, "max_logit_gap"),
          "answer_cut": (answer_cut, "undelivered"),
          "token_twice": (token_twice, "ledger_faults"),
          "answer_long": (answer_long, "ledger_faults")}


def test_sound_run_is_correct(cells):
    res, _ = bench.run(cells(), 11, 2.0, False, 0.0, device="cpu")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(cells, fault):
    make, number = FAULTS[fault]
    with make():
        res, _ = bench.run(cells(rate=40.0), 11, 2.0, False, 0.0,
                           device="cpu")
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]
