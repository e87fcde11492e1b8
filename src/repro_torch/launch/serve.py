"""Serving launcher: batched requests through the ServeEngine, PyTorch.

    python -m repro_torch.launch.serve --arch qwen2-7b --attn-impl pallas \\
        --requests 8 --prompt-len 512,512,512,512,384,384,384,77 \\
        --max-new 32 --slots 4 --max-len 1024 [--device cpu --reduced]

The flags and JSON output of `repro.launch.serve`, plus `--device`
(default `cuda`; `cpu` only when asked) and `--attn-impl` (the execution
knob `ExecConfig.attn_impl`). `pallas` runs the port's kernels on
prefill: attention through the CUDA kernel F1 in a dense model (qwen2-7b,
paper-demo) and a moe model (`--arch olmoe-1b-7b`: 64 experts, top-8,
routed in groups of `ExecConfig.moe_group` tokens with the reference's
capacity; the experts are torch products, as the reference computes them
outside Pallas), every layer's selective scan through the CUDA kernel S1
in an ssm model (`--arch falcon-mamba-7b`, Mamba1), and in the hybrid
`--arch zamba2-7b` the shared attention block through F1 (head dim 112,
once per group of 6 layers) while its Mamba2 layers run the chunked SSD,
as under every `--attn-impl` (S % min(ssm_chunk, S) == 0; ssm_chunk is 128
at full width); decode runs no kernel of the port. `--prompt-len` takes
one length for every request or a comma-separated length per request.
Parameters are random, drawn from seed 0 on the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _prompt_lens(text: str, n: int) -> list[int]:
    lens = [int(x) for x in text.split(",")]
    if len(lens) == 1:
        return lens * n
    if len(lens) != n:
        raise ValueError(f"--prompt-len gives {len(lens)} lengths for "
                         f"{n} requests")
    return lens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-demo",
                    help="dense (qwen2-7b, paper-demo), ssm "
                         "(falcon-mamba-7b) or hybrid (zamba2-7b)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", default="16",
                    help="one length for all requests, or one per request "
                         "(comma-separated)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="exercise serving fault tolerance")
    ap.add_argument("--attn-impl", default="chunked",
                    choices=["naive", "chunked", "pallas"],
                    help="pallas: prefill through the port's CUDA kernels "
                         "(attention by F1, zamba2-7b's shared block "
                         "included; an ssm model's selective scan by S1; "
                         "Mamba2 layers stay on the chunked SSD)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu only when asked)")
    args = ap.parse_args(argv)
    lens = _prompt_lens(args.prompt_len, args.requests)

    from repro_torch.device import resolve, set_deterministic
    set_deterministic()          # before anything touches CUDA

    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from repro_torch.serve import Request, ServeEngine

    device = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = Model(cfg, ExecConfig(attn_impl=args.attn_impl))
    params = model.init(torch.Generator(device).manual_seed(0))
    eng = ServeEngine(model, params, n_slots=args.slots,
                      max_len=args.max_len)
    for i, n in enumerate(lens):
        eng.submit(Request(rid=i, prompt=list(range(2, 2 + n)),
                           max_new_tokens=args.max_new))
    t0 = time.monotonic()
    steps = 0
    snap = None
    while any(s is not None for s in eng.slots) or eng.queue:
        eng.step()
        steps += 1
        if args.snapshot_every and steps % args.snapshot_every == 0:
            snap = eng.snapshot()
    dt = time.monotonic() - t0
    # count what the engine actually produced, not the nominal request
    # shape: max_len truncation can cut a generation short
    generated = sum(len(r.out) - 1 for r in eng.completed)
    print(json.dumps({
        "arch": cfg.name, "requests": args.requests,
        "completed": len(eng.completed),
        "engine_steps": steps, "wall_s": round(dt, 3),
        "tokens_generated": generated,
        "tokens_per_s": round(generated / dt, 1),
        "snapshot_taken": snap is not None,
        "prefill_calls": eng.prefill_calls,
        "attn_impl": args.attn_impl, "device": str(device),
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
