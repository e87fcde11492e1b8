"""Quickstart, on the PyTorch port: train a small LM with Reinit++ fault
tolerance.

Trains the paper-demo transformer for 30 steps, SIGKILL-emulates a random
rank failure mid-run (fault injection, paper §4), watches Reinit++ recover
from the buddy memory checkpoint, and verifies the final parameters are
bit-identical to an uninterrupted run.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Runs on the card (`--device cuda`, the default) unless asked for the CPU.
Set REPRO_DRYRUN=1 to print the run plan (config + drawn fault) without
training.
"""
import argparse
import os
import tempfile

from repro_torch.checkpoint.manifest import tree_digest
from repro_torch.configs import get_config, reduced
from repro_torch.core import FailureType, FaultInjector
from repro_torch.device import set_deterministic
from repro_torch.models.model import Model
from repro_torch.train import AdamWConfig, TokenPipeline, TrainConfig, \
    Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = reduced(get_config("paper-demo"))
    if os.environ.get("REPRO_DRYRUN", "") == "1":
        inj = FaultInjector(n_ranks=8, n_steps=30,
                            kind=FailureType.PROCESS, seed=42)
        print(f"dry run: {cfg.name}, 30 steps, strategy=reinit, "
              f"device={args.device}")
        print(f"drawn fault: rank {inj.fail_rank} SIGKILL @step "
              f"{inj.fail_step} (scenario: "
              f"{inj.scenario.faults[0].point}/"
              f"{inj.scenario.faults[0].how})")
        return
    set_deterministic()          # before anything touches CUDA
    model = Model(cfg)
    data = TokenPipeline(cfg.vocab_size, global_batch=4, seq_len=64, seed=0,
                         device=args.device)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30)

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        print("=== reference run (no failures) ===")
        ref = Trainer(model, data, opt,
                      TrainConfig(total_steps=30, ckpt_dir=d1,
                                  strategy="reinit", log_every=10,
                                  device=args.device))
        ref_out = ref.run()

        print("\n=== fault-injected run (Reinit++ recovery) ===")
        inj = FaultInjector(n_ranks=8, n_steps=30,
                            kind=FailureType.PROCESS, seed=42)
        tr = Trainer(model, data, opt,
                     TrainConfig(total_steps=30, ckpt_dir=d2,
                                 strategy="reinit", log_every=10,
                                 device=args.device),
                     injector=inj)
        out = tr.run()

        rep = out["reports"][0]
        print(f"\nfailure injected @step {inj.fail_step} (rank "
              f"{inj.fail_rank}); recovered in {rep.total_s * 1e3:.1f} ms "
              f"(detect {rep.detect_s * 1e3:.1f} + mpi "
              f"{rep.mpi_recovery_s * 1e3:.1f} + ckpt "
              f"{rep.ckpt_read_s * 1e3:.1f})")
        d_ref = tree_digest(ref.state["params"])
        d_ft = tree_digest(tr.state["params"])
        print(f"reference params digest: {d_ref}")
        print(f"recovered params digest: {d_ft}")
        assert d_ref == d_ft, "recovery diverged!"
        print("recovery is BIT-IDENTICAL to the uninterrupted run ✓")
        print(f"loss: {ref_out['losses'][0]:.3f} -> "
              f"{ref_out['losses'][-1]:.3f}")


if __name__ == "__main__":
    main()
