"""Training launchers, PyTorch on one device.

    python -m repro_torch.launch.train --arch paper-demo --steps 12 \\
        --fail-kind process --strategy reinit [--device cpu]

Same flags and the same JSON summary as `repro.launch.train`, plus
`--device` (default `cuda`; `cpu` only when asked). Two entry points:

  in-process   the fault-tolerant trainer on one device
  --cluster    the mpirun analogue: deploys the root/daemon/worker tree of
               `repro_torch.runtime` with fault injection, every worker's
               state on `--device` (the root builds the checksum kernel
               library once before it deploys on the card)
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

from repro_torch.core.recovery import STRATEGIES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-demo")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--strategy", default="reinit",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a new one under "
                         "the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--ckpt-delta-every", type=int, default=0,
                    help="K>1: full file snapshot every K-th save, "
                         "dirty-tile delta frames between")
    ap.add_argument("--fail-kind", default="",
                    choices=["", "process", "node"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-size config variant")
    ap.add_argument("--cluster", action="store_true",
                    help="launch the real-process runtime instead")
    ap.add_argument("--report", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu only when asked)")
    args = ap.parse_args(argv)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    if args.cluster:
        from repro_torch.runtime.root import MODES, main as root_main
        # ulfm is sim-only: the cluster path runs it as reinit
        mode = args.strategy if args.strategy in MODES else "reinit"
        rt_args = ["--nodes", "2", "--ranks-per-node", "4", "--spares", "1",
                   "--steps", str(args.steps), "--ckpt-dir", ckpt_dir,
                   "--mode", mode, "--device", args.device]
        if args.fail_kind:
            rt_args += ["--fail-step", str(max(args.steps // 2, 1)),
                        "--fail-rank", "1", "--fail-kind", args.fail_kind]
        if args.report:
            rt_args += ["--report", args.report]
        return root_main(rt_args)

    from repro_torch.device import set_deterministic
    set_deterministic()          # before anything touches CUDA

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import FaultInjector, FailureType
    from repro_torch.models.model import Model
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = Model(cfg)
    data = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed, device=args.device)
    opt = AdamWConfig(total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1))
    tc = TrainConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                     ckpt_every=args.ckpt_every, strategy=args.strategy,
                     ckpt_delta_every=args.ckpt_delta_every,
                     seed=args.seed, log_every=10, device=args.device)
    injector = None
    if args.fail_kind:
        injector = FaultInjector(
            n_ranks=tc.n_nodes * tc.ranks_per_node, n_steps=args.steps,
            kind=FailureType.NODE if args.fail_kind == "node"
            else FailureType.PROCESS, seed=args.seed)
    trainer = Trainer(model, data, opt, tc, injector=injector)
    result = trainer.run()
    summary = {
        "arch": cfg.name, "final_step": result["final_step"],
        "first_loss": result["losses"][0] if result["losses"] else None,
        "last_loss": result["losses"][-1] if result["losses"] else None,
        "recoveries": [
            {"strategy": r.strategy, "total_s": r.total_s,
             "rollback_step": r.rollback_step}
            for r in result["reports"]],
    }
    print(json.dumps(summary, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
