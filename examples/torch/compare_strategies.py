"""Compare CR / ULFM / Reinit++ end to end, on the PyTorch port — the
paper's experiment, small.

Runs the same fault-injected training job under all three recovery
strategies (identical failure, identical data), prints each strategy's
recovery breakdown, and then shows the large-scale picture from the
calibrated simulator (Figures 4/6 reproduction at 16-1024 ranks).

    PYTHONPATH=src python examples/torch/compare_strategies.py [--device cpu]

Runs on the card (`--device cuda`, the default) unless asked for the CPU.
Set REPRO_DRYRUN=1 to print only the calibrated-simulator comparison
(no training).
"""
import argparse
import os
import tempfile

from repro_torch.checkpoint.manifest import tree_digest
from repro_torch.configs import get_config, reduced
from repro_torch.core import FailureType, FaultInjector
from repro_torch.device import set_deterministic
from repro_torch.models.model import Model
from repro_torch.sim import APPS, recovery_time, simulate_run
from repro_torch.train import AdamWConfig, TokenPipeline, TrainConfig, \
    Trainer


def print_recovery_table():
    print(f"{'ranks':>6} {'CR':>8} {'Reinit++':>9} {'ULFM':>8}")
    for n in [16, 64, 256, 1024]:
        ts = [recovery_time(s, n, 'process')['mpi_recovery_s']
              for s in ('cr', 'reinit', 'ulfm')]
        print(f"{n:>6} {ts[0]:>8.2f} {ts[1]:>9.2f} {ts[2]:>8.2f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if os.environ.get("REPRO_DRYRUN", "") == "1":
        print("=== dry run: calibrated simulation only ===")
        print_recovery_table()
        return

    set_deterministic()          # before anything touches CUDA
    cfg = reduced(get_config("paper-demo"))
    model = Model(cfg)
    data = TokenPipeline(cfg.vocab_size, 4, 64, seed=0, device=args.device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)

    print(f"=== this machine ({args.device}): one failure, three "
          f"recoveries ===")
    digests = {}
    for strategy in ["reinit", "ulfm", "cr"]:
        with tempfile.TemporaryDirectory() as d:
            inj = FaultInjector(n_ranks=8, n_steps=20,
                                kind=FailureType.PROCESS, seed=7)
            tr = Trainer(model, data, opt,
                         TrainConfig(total_steps=20, ckpt_dir=d,
                                     strategy=strategy, device=args.device),
                         injector=inj)
            tr.run()
            rep = tr.reports[0]
            digests[strategy] = tree_digest(tr.state["params"])
            print(f"{rep.strategy:9s} recovery {rep.total_s * 1e3:7.1f} ms"
                  f"  (mpi {rep.mpi_recovery_s * 1e3:6.1f} ms, "
                  f"ckpt {rep.ckpt_read_s * 1e3:6.1f} ms, "
                  f"ckpt kind: "
                  f"{tr.strategy.checkpoint_kind(rep.failure.kind)})")
    assert len(set(digests.values())) == 1, "strategies diverged!"
    print("all three strategies converge to the same params ✓")

    print("\n=== calibrated simulation: MPI recovery vs ranks (Fig 6) ===")
    print_recovery_table()

    print("\n=== total time with checkpointing, CoMD proxy (Fig 4) ===")
    for n in [16, 1024]:
        row = [f"{simulate_run(APPS['comd'], n, s).total_s:7.1f}s"
               for s in ("cr", "reinit", "ulfm")]
        print(f"n={n:<5} CR={row[0]} Reinit++={row[1]} ULFM={row[2]}")


if __name__ == "__main__":
    main()
