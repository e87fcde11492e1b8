"""Serve a cell's traffic for one window per (rate, seed), in one process,
and print per window whether the queue grew; with `--check`, also the
numbers that `correct` compares for the program and for the control.

    python3 ftbench/tools/sweep.py --workload <cell> --rates 1,1.5,2 \
        --seeds 11,12,13 --seconds 40 [--check]

Each window draws its own weights and traffic from its seed. Per window
one JSON line: requests, TTFT median and p90 of each quarter of the
window (by due time), the requests still without a first token at the
close, the drain's seconds and, with `--check`, the program's and the
control's checks (`bench.verify`). The knee is the highest rate whose
last quarter's TTFT stays near its first's and whose backlog at the
close stays below a few requests. Over many seeds at the cell's own rate
the checks give the lower and upper readings of a limit.
"""
import argparse
import json
import time

import numpy as np

from _common import free, prepare


def stats(rec) -> dict:
    hi = rec.window[1]
    q = []
    for k in range(4):
        lo_s, hi_s = k * rec.seconds / 4, (k + 1) * rec.seconds / 4
        t = [(min(rec.sink.first.get(a.rid, hi), hi) - a.due_abs) * 1e3
             for a in rec.arrivals if lo_s <= a.due_s < hi_s]
        q.append([float(np.median(t)), float(np.percentile(t, 90))]
                 if t else None)
    backlog = sum(1 for a in rec.arrivals
                  if rec.sink.first.get(a.rid, hi + 1) > hi)
    return {"requests": len(rec.arrivals), "ttft_ms_by_quarter": q,
            "backlog_at_close": backlog, "drain_s": rec.t_end - rec.t_close,
            "kill_at_s": rec.kill["t"] - rec.t0 if rec.kill else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    prepare()
    from ftbench.harness import bench, spec, traffic
    cell = spec.load(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(rates) == 1:
        rates *= len(seeds)
    warm = False
    for rate, seed in zip(rates, seeds, strict=True):
        st = bench.make_setup(cell, seed, args.device)
        arrivals, fault = traffic.generate(cell.mix, cell.config, seed,
                                           args.seconds, rate)
        if not warm:
            print(f"[sweep] warm-up {bench.warm_up(st, arrivals):.1f} s",
                  flush=True)
            warm = True
        t = time.monotonic()
        rec = bench.serve_window(st, arrivals, fault, args.seconds, False, t)
        out = dict(stats(rec), rate=rate, seed=seed)
        if args.check:
            for side, quant in (("program", None), ("control", "fp8")):
                out[side] = {k: c["value"] for k, c in
                             bench.verify(st, rec, quant).items()}
                out[side]["check"] = rec.check_info
        free(st)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
