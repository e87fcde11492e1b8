"""Real-process cluster failover on the PyTorch port — the paper's
runtime, live.

Drives declarative failure scenarios (repro_torch.scenarios) through the
event-driven root -> daemons (+spare) -> workers tree of actual POSIX
processes, each worker's state on `--device`: SIGKILLs a rank behind the
deterministic FENCE barrier, takes a whole node down, kills
mid-checkpoint-write, and cascades a second failure into an in-flight
recovery — then prints each measured recovery timeline (Algorithm 1 + 2,
pipelined respawn/restore, rollback consensus) and checks the recovered
state is bit-identical to the fault-free run.

    PYTHONPATH=src python examples/torch/cluster_failover.py [--device cpu]

Runs the workers on the card (`--device cuda`, the default) unless asked
for the CPU. Set REPRO_DRYRUN=1 to replay the same scenario definitions
through the calibrated discrete-event simulator instead of spawning
processes.
"""
import argparse
import os
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.scenarios import engine                # noqa: E402
from repro_torch.scenarios.catalog import (fault_free,  # noqa: E402
                                           get_scenario)

SHOWCASE = ["proc-sigkill-midstep", "node-sigkill", "ckpt-midwrite-kill",
            "cascade-respawn-dies"]

DRYRUN = os.environ.get("REPRO_DRYRUN", "") == "1"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if DRYRUN:
        print("== dry run: same scenarios, simulator substrate ==\n")
        for name in SHOWCASE:
            sc = get_scenario(name)
            print(engine.describe(sc))
            for strat in sc.strategies:
                out = engine.run_sim(sc, strat)
                print(f"    {strat:7s} recovery "
                      f"{out.total_s * 1e3:8.1f} ms "
                      f"({out.n_recoveries} recovery event(s))")
            print()
        return

    with tempfile.TemporaryDirectory() as tmp:
        ref = engine.run_real(fault_free(get_scenario(SHOWCASE[0]).topology),
                              "reinit", os.path.join(tmp, "ff"),
                              device=args.device)
        print(f"fault-free reference ({args.device}): "
              f"total={ref.total_s:.2f}s\n")
        for name in SHOWCASE:
            sc = get_scenario(name)
            strat = engine.real_strategies(sc)[0]
            out = engine.run_real(sc, strat, os.path.join(tmp, name),
                                  device=args.device)
            ev = out.detail["events"][-1] if out.detail["events"] else {}
            bit = "bit-identical" if out.checksums == ref.checksums \
                else "DIVERGED"
            print(f"{name:22s} [{strat}] "
                  f"recoveries={out.n_recoveries} "
                  f"resume={out.resume_steps or ['-']} "
                  f"mpi={ev.get('mpi_recovery_s', float('nan')):.2f}s "
                  f"-> {bit}")
        print("\nReinit++ recovers in place (survivors roll back via "
              "SIGREINIT,\nfailed ranks re-spawn — on the spare node for "
              "node failures);\nevery scenario's consistent cut matches "
              "the schema's declarative oracle.")


if __name__ == "__main__":
    main()
