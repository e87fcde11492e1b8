"""The port's simulator and scenario engine against the JAX package's.

The simulator is stdlib only and carries the reference's calibration
unchanged, so the two packages must agree EXACTLY (tolerance 0: the same
floats, the same rows, the same resume steps) on every catalog cell under
every strategy, and on every single-failure run over the paper's apps,
rank counts 16-1024, strategies and failure kinds. A strategy that one
package refuses for a cell, the other must refuse the same way.
"""
import dataclasses

import pytest

from repro.scenarios import engine as ref_engine
from repro.scenarios.catalog import CATALOG
from repro.sim import APPS as REF_APPS
from repro.sim import cluster as ref_cluster
from repro_torch.scenarios import engine
from repro_torch.scenarios.catalog import BY_NAME
from repro_torch.scenarios.schema import STRATEGY_KEYS
from repro_torch.sim import APPS, cluster

RANKS = [16, 32, 64, 128, 256, 512, 1024]
KINDS = ["process", "node"]


def _outcome(fn):
    """(outcome fields, None) or (None, the refusal's type and text)."""
    try:
        out = fn()
    except (ValueError, AssertionError, KeyError, RuntimeError) as e:
        return None, (type(e).__name__, str(e))
    return dataclasses.asdict(out), None


@pytest.mark.parametrize("strategy", STRATEGY_KEYS)
@pytest.mark.parametrize("name", [s.name for s in CATALOG])
def test_run_sim_matches_reference(name, strategy):
    ref_sc = next(s for s in CATALOG if s.name == name)
    ours, our_err = _outcome(lambda: engine.run_sim(BY_NAME[name], strategy))
    ref, ref_err = _outcome(lambda: ref_engine.run_sim(ref_sc, strategy))
    assert our_err == ref_err
    assert ours == ref
    if strategy in ref_sc.strategies:       # the cell's own strategies
        assert ours is not None and ours["detail"]["rows"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("strategy", STRATEGY_KEYS)
@pytest.mark.parametrize("app", sorted(REF_APPS))
def test_simulate_run_matches_reference(app, strategy, kind):
    assert dataclasses.asdict(APPS[app]) == dataclasses.asdict(REF_APPS[app])
    for n in RANKS:
        ours = cluster.simulate_run(APPS[app], n, strategy, kind)
        ref = ref_cluster.simulate_run(REF_APPS[app], n, strategy, kind)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), n
        assert ours.total_s == ref.total_s
        assert cluster.recovery_time(strategy, n, kind) == \
            ref_cluster.recovery_time(strategy, n, kind)
        for pipelined in (False, True):
            assert cluster.recovery_e2e(strategy, n, kind, 0.25,
                                        pipelined=pipelined) == \
                ref_cluster.recovery_e2e(strategy, n, kind, 0.25,
                                         pipelined=pipelined)


@pytest.mark.parametrize("app", sorted(REF_APPS))
def test_break_even_oracles_match_reference(app):
    for n in (16, 256, 1024):
        for kind in KINDS:
            assert cluster.replica_break_even(APPS[app], n, kind) == \
                ref_cluster.replica_break_even(REF_APPS[app], n, kind)
        for factor in (1.5, 6.0):
            assert cluster.rehost_break_even(APPS[app], n, factor) == \
                ref_cluster.rehost_break_even(REF_APPS[app], n, factor)


def test_describe_matches_reference():
    for sc in CATALOG:
        assert engine.describe(BY_NAME[sc.name]) == ref_engine.describe(sc)
