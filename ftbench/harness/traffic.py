"""The one traffic generator: a mix file's parameters and a seed ->
the arrivals of one run and its fault.

Open loop: every request has a due time fixed before the run, whatever
the server does. Arrivals are Poisson at the cell's rate; so that every
seed offers the same work in another order, the gaps are the quantiles of
the exponential law at `n` evenly spaced probabilities (n = rate *
seconds) and the lengths the quantiles of their laws, each list put in
the seed's order. That order is stratified over the mix's `blocks`
stretches of the window: each stretch takes one value of every group of
`blocks` neighbouring quantiles, so every stretch carries about the same
arrivals and tokens whatever the seed. Prompt ids are uniform over the
vocabulary from the seed. The fault's rank and its round are the mix's
own, the same in every run.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Arrival:
    rid: int
    rank: int
    due_s: float                 # from the window's start
    prompt: list
    max_new_tokens: int
    due_abs: float = 0.0         # monotonic, set when the window starts


@dataclasses.dataclass
class Fault:
    rank: int
    round: int                   # the cluster's round, from the window's start
    point: str


def _quantiles(law: dict, n: int) -> np.ndarray:
    """The law's quantiles at probabilities (i + 0.5) / n. `log_normal`
    (a median and the log's standard deviation `sigma`) is clipped into
    [min, max]: a longer prompt is cut to the context, a longer answer to
    the tier's limit of new tokens."""
    p = (np.arange(n) + 0.5) / n
    if law["law"] == "log_normal":
        z = np.array([NormalDist().inv_cdf(x) for x in p])
        return np.clip(law["median"] * np.exp(law["sigma"] * z),
                       law["min"], law["max"])
    if law["law"] == "exponential":
        return -np.log1p(-p) / law["rate_per_s"]
    raise ValueError(f"unknown law {law['law']!r}")


def _ordered(values: np.ndarray, blocks: int, rng) -> np.ndarray:
    """`values` in the seed's order, stratified over `blocks` stretches:
    of each group of `blocks` neighbours in sorted order, one value goes
    to each stretch (a last, smaller group to as many stretches, drawn),
    and each stretch is shuffled."""
    values = np.sort(values)
    n = len(values)
    stretch = np.empty(n, dtype=int)
    for s in range(0, n, blocks):
        k = min(blocks, n - s)
        stretch[s:s + k] = rng.permutation(blocks)[:k]
    return np.concatenate([rng.permutation(values[stretch == b])
                           for b in range(blocks)])


def generate(mix: dict, config: dict, seed: int, seconds: float,
             rate: float):
    """(arrivals sorted by due time, fault or None) of one run at `rate`
    requests a second."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(rate * seconds)))
    blocks = min(n, int(mix["arrivals"].get("blocks", 1)))
    gaps = _ordered(_quantiles({"law": "exponential", "rate_per_s": rate},
                               n), blocks, rng)
    # the first request is due at the window's start
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    keep = due < seconds
    lens = _ordered(np.rint(_quantiles(mix["prompt_len"], n)), blocks,
                    rng).astype(int)
    news = _ordered(np.rint(_quantiles(mix["new_tokens"], n)), blocks,
                    rng).astype(int)
    world = mix["cluster"]["world"]
    vocab = config["vocab_size"]
    arrivals = []
    for i in np.flatnonzero(keep):
        prompt = rng.integers(0, vocab, int(lens[i])).tolist()
        arrivals.append(Arrival(rid=len(arrivals), rank=len(arrivals) % world,
                                due_s=float(due[i]), prompt=prompt,
                                max_new_tokens=int(news[i])))
    fault = None
    f = mix.get("fault")
    if f:
        fault = Fault(rank=f["rank"], round=int(f["round"]),
                      point=f["point"])
    return arrivals, fault
