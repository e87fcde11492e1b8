"""The benchmark of `repro_torch`'s fault-tolerant serving path.

    python3 ftbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

One run is one process: it sets up the program from the seed (weights
drawn on the card, kernels built or found under build/ in the checkout,
one warm prefill, decode and publish at the cell's shapes), serves the
cell's open-loop traffic through one rank kill for `--seconds`, checks
what was served against the plain reference, and prints one JSON line
last on standard output (with `--trace 0` the cell's end-to-end metrics,
with `--trace 1` its per-layer ones) and the numbers compared, each
beside its limit, last on standard error.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "build", "ftbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from ftbench.harness import bench, spec

    cell = spec.load(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("ftbench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"ftbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, lines = bench.run(cell, args.seed, args.seconds,
                              bool(args.trace), T_START)
    found = bench.forbidden_modules()
    if found:
        print(f"ftbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
