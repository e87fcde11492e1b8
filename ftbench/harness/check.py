"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, a sample of
the requests served in the window (drawn from the seed; the longest
prompt always in it, and requests of the killed rank that were in flight
at the kill) is run through the configuration's plain float32 reference:
the prompt with the served tokens, teacher-forced. At each position that
produced a served token the reference's best logit is compared with its
logit of the served token; the widest gap over the sample is compared
with the cell's limit. The delivery ledger is checked too, in the
benchmark's own sink: every request due in the window delivered whole,
and no token delivered twice, skipped or beyond what the request is owed.
The control puts the tokens that the reference at a lower precision puts
first in the program's place, through the same comparison.
"""
from __future__ import annotations

import numpy as np


def expected_tokens(a, max_len: int) -> int:
    """Tokens a request is owed: the prefill's and max_new decode tokens,
    cut where the engine's max_len guard frees the slot."""
    return min(a.max_new_tokens + 1, max_len - len(a.prompt))


def sample(arrivals, served: dict, kill, last_t: dict, n: int, seed: int
           ) -> list:
    """Up to n rids of fully served requests: the longest prompt, up to a
    quarter of the killed rank's requests in flight at the kill, the rest
    drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    done = [a for a in arrivals if a.rid in served]
    if not done:
        return []
    pick = [max(done, key=lambda a: len(a.prompt)).rid]
    if kill is not None:
        flight = [a.rid for a in done if a.rank == kill["rank"]
                  and a.due_abs <= kill["t"] < last_t.get(a.rid, 0.0)
                  and a.rid not in pick]
        take = min(len(flight), max(1, n // 4))
        pick += [int(r) for r in rng.choice(flight, take, replace=False)] \
            if take else []
    rest = [a.rid for a in done if a.rid not in pick]
    more = min(len(rest), n - len(pick))
    pick += [int(r) for r in rng.choice(rest, more, replace=False)] \
        if more > 0 else []
    return sorted(pick)


def gaps(ref_logits: list, served: list) -> list:
    """Per request, the gap (best reference logit minus the reference's
    logit of the served token) at each served position."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = lg.new_tensor(toks).long()
        best = lg.max(-1).values
        got = lg.gather(-1, t[:, None])[:, 0]
        out.append((best - got).double().cpu().numpy())
    return out


def line(name: str, value, limit) -> str:
    return f"[check] {name} {value!r} (limit {limit!r})"
