"""Batched serving with mid-flight snapshot/restore fault tolerance, on
the PyTorch port.

Serves 12 requests through a 4-slot continuous-batching engine, kills the
engine mid-decode, restores from the last snapshot, and shows the resumed
outputs match an uninterrupted run.

    PYTHONPATH=src python examples/torch/serve_batch.py [--device cpu]

Runs on the card (`--device cuda`, the default) unless asked for the CPU.
Set REPRO_DRYRUN=1 to print the serve plan without loading the model.
"""
import argparse
import os
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import set_deterministic
from repro_torch.models.model import Model
from repro_torch.serve import Request, ServeEngine


def mk_requests():
    return [Request(rid=i, prompt=list(range(3 + i, 13 + i)),
                    max_new_tokens=8) for i in range(12)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = reduced(get_config("qwen2-7b"))
    if os.environ.get("REPRO_DRYRUN", "") == "1":
        reqs = mk_requests()
        print(f"dry run: {cfg.name}, {len(reqs)} requests through a "
              f"4-slot engine on {args.device}, snapshot/restore "
              f"mid-decode")
        return
    set_deterministic()          # before anything touches CUDA
    model = Model(cfg)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))

    # uninterrupted reference
    eng = ServeEngine(model, params, n_slots=4, max_len=64)
    ref = mk_requests()
    for r in ref:
        eng.submit(r)
    t0 = time.monotonic()
    eng.run_until_drained()
    dt = time.monotonic() - t0
    print(f"reference: {sum(len(r.out) for r in ref)} tokens in "
          f"{dt:.2f}s ({sum(len(r.out) for r in ref) / dt:.1f} tok/s)")

    # failure mid-decode + restore
    eng2 = ServeEngine(model, params, n_slots=4, max_len=64)
    reqs = mk_requests()
    for r in reqs:
        eng2.submit(r)
    for _ in range(5):
        eng2.step()
    snap = eng2.snapshot()           # buddy-style in-memory checkpoint
    print("engine snapshot taken mid-decode; killing engine...")
    del eng2                         # the "process failure"

    eng3 = ServeEngine(model, params, n_slots=4, max_len=64)
    # the snapshot holds the slot table and the pending queue: the
    # restored engine owns every request the killed one had not finished
    eng3.restore(snap)
    done = eng3.run_until_drained()
    print("restored engine drained the remaining work ✓")
    finished = {r.rid: list(r.out) for r in reqs if r.done
                and r.rid not in {d.rid for d in done}}
    got = {**finished, **{r.rid: list(r.out) for r in done}}
    by_rid = {r.rid: list(r.out) for r in ref}
    assert got == by_rid, "divergence after the restore"
    print("every request, in flight or queued at the failure, matches the "
          "uninterrupted run ✓")

if __name__ == "__main__":
    main()
