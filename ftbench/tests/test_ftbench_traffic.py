"""The traffic generator: fixed by the seed, the same work for every
seed in another order and in every stretch of the window, the laws of
the mix's source, the kill at the mix's own rank and round."""
import numpy as np
import pytest

from conftest import tiny_config

from ftbench.harness import spec, traffic

MIX = spec._json(f"{spec.FTBENCH}/traffic/docqa-kill.reinit.json")
CFG = dict(tiny_config(), vocab_size=65024)
RATE = 1.1


def _gen(seed, seconds=50.0):
    return traffic.generate(MIX, CFG, seed, seconds, RATE)


def test_same_seed_same_traffic():
    a, fa = _gen(2 ** 31 + 7)
    b, fb = _gen(2 ** 31 + 7)
    assert [(x.due_s, x.prompt, x.max_new_tokens, x.rank) for x in a] == \
        [(x.due_s, x.prompt, x.max_new_tokens, x.rank) for x in b]
    assert fa == fb


def test_seeds_share_the_work_in_another_order():
    a, fa = _gen(1)
    b, fb = _gen(2)
    assert sorted(len(x.prompt) for x in a) == \
        sorted(len(x.prompt) for x in b)
    assert sorted(x.max_new_tokens for x in a) == \
        sorted(x.max_new_tokens for x in b)
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in b]
    q = traffic._quantiles({"law": "exponential", "rate_per_s": RATE},
                           round(RATE * 50.0))
    for arr in (a, b):
        gaps = np.diff([x.due_s for x in arr])
        assert np.isclose(gaps[:, None], q[None, :]).any(1).all()
    assert fa == fb


def test_lengths_follow_the_source():
    """Medians as the trace's; the clipped tails at the context and at
    the tier's limit of new tokens."""
    arr, _ = _gen(3, seconds=1000.0)
    lens = np.array([len(x.prompt) for x in arr])
    news = np.array([x.max_new_tokens for x in arr])
    assert abs(np.median(lens) - 1500) <= 2 and lens.max() == 3840
    assert 0.10 < (lens == 3840).mean() < 0.14
    assert np.median(news) == 13 and news.max() == 32
    assert 0.20 < (news == 32).mean() < 0.26


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 11, 2 ** 40])
def test_laws_and_fault(seed):
    arr, fault = _gen(seed)
    assert len(arr) == round(RATE * 50.0)
    assert all(0 <= x.due_s < 50.0 for x in arr)
    assert arr[0].due_s == 0.0
    assert all(16 <= len(x.prompt) <= 3840 for x in arr)
    assert all(1 <= x.max_new_tokens <= 32 for x in arr)
    assert all(0 <= t < 65024 for x in arr for t in x.prompt)
    assert [x.rank for x in arr] == [i % 2 for i in range(len(arr))]
    assert fault == traffic.Fault(rank=1, round=56,
                                  point="serve.decode.step")


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_every_stretch_carries_the_same_work(seed):
    """Each of the mix's stretches takes one value of every group of
    `blocks` neighbouring quantiles; with a last, smaller group the
    values are still the same set."""
    blocks = MIX["arrivals"]["blocks"]
    rng = np.random.default_rng(seed)
    for n in (5 * blocks, 5 * blocks + 3):
        q = np.sort(traffic._quantiles({"law": "exponential",
                                        "rate_per_s": RATE}, n))
        got = traffic._ordered(q, blocks, rng)
        assert sorted(got) == sorted(q)
        if n % blocks:
            continue
        for k in range(blocks):
            part = np.sort(got[k * 5:(k + 1) * 5])
            assert [np.searchsorted(q, v) // blocks for v in part] == \
                list(range(5)), (k, part)
