"""Serve one traced window of a cell and print where its time went, by the
program's own spans and counters (`repro_torch.tracing`).

    python3 ftbench/tools/program_spans.py --workload <cell> --seed <n> \
        [--seconds 50] [--out spans.json]

One JSON line on standard output (and in `--out`): for each span name
inside the window its count, seconds, self seconds (less its children's)
and the card's busy share inside it; the window's counts (from the spans
that carry them) beside the run's whole counters; the spans recorded a
round; the ten longest idle gaps of the card named by the innermost span
around each; the share of S1's device time (`selective_scan_fwd`) that
falls inside `engine.prefill` spans, which holds the program's clock to
the device trace's; the queue's three waits (due to submit, submit to
admission, the prefill); and the kill's recovery split into its parts.
The check against the reference is not run.
"""
import argparse
import bisect
import json
import time

import numpy as np

from _common import prepare


def p(values, q):
    return float(np.percentile(values, q)) if len(values) else None


def summary(rec) -> dict:
    from ftbench.harness import bench
    from ftbench.harness.trace import busy_intervals
    from ftbench.metrics._program import busy_within
    lo, hi = rec.t0, rec.t_close
    tracer = rec.program_tracer
    full = [s for s in tracer.spans if s is not None]
    spans = [(n, t0 / 1e9, t1 / 1e9, par, a) for n, t0, t1, par, a in full]
    # spans that overlap the window, clipped to it (the profiler's flush
    # at the close runs inside a round)
    inside = [i for i, s in enumerate(spans) if s[2] > lo and s[1] < hi
              or lo <= s[1] == s[2] < hi]
    clip = {i: (max(spans[i][1], lo), min(spans[i][2], hi)) for i in inside}
    busy = busy_intervals(rec.device.events, lo, hi) if rec.device else []
    child = {}
    for i in inside:
        par = spans[i][3]
        if par is not None:
            child[par] = child.get(par, 0.0) + clip[i][1] - clip[i][0]
    by, named = {}, {}
    for i in inside:
        n, a = spans[i][0], spans[i][4]
        s, e = clip[i]
        d = by.setdefault(n, {"count": 0, "s": 0.0, "self_s": 0.0,
                              "busy_s": 0.0})
        d["count"] += 1
        d["s"] += e - s
        d["self_s"] += e - s - child.get(i, 0.0)
        named.setdefault(n, []).append((n, s, e, a))
    for n, sp in named.items():
        by[n]["busy_s"] = busy_within(busy, sp) if busy else 0.0
    counts = {}
    for i in inside:
        for k, v in spans[i][4].items():
            if "." in k:
                counts[k] = counts.get(k, 0) + v
    rounds = by.get("cluster.round", {}).get("count", 0)
    out = {"window_s": hi - lo, "spans": by, "window_counts": counts,
           "run_counters": dict(tracer.counters),
           "spans_a_round": len(inside) / rounds if rounds else None}
    if rec.device is not None:
        out["breakdown"] = bench.breakdown(rec)
        scan = [(s, e) for n, s, e in rec.device.events
                if "selective_scan_fwd" in n and s < hi and e > lo]
        pre = sorted((s, e) for n, s, e, _, _ in spans
                     if n == "engine.prefill")
        tot = sum(e - s for s, e in scan)
        covered = busy_within([list(x) for x in pre],
                              [("", s, e, None) for s, e in scan])
        out["s1_in_prefill_share"] = covered / tot if tot else None
        out["s1_device_s"] = tot
        # the S1 launches not wholly inside a prefill span, and how far
        # the farthest sticks out of the span it starts in (or next to)
        starts = [a for a, _ in pre]
        past = []
        for s, e in scan:
            j = max(0, bisect.bisect_right(starts, s) - 1)
            a, b = pre[j]
            if s < a or e > b:
                past.append(1e3 * max(a - s, e - b))
        out["s1_outside"] = {"launches": len(past), "of": len(scan),
                             "max_ms_past_edge": max(past, default=0.0)}
    # the queue's waits, by request, for those due in the window
    due = {a.rid: a.due_abs for a in rec.arrivals}
    queued = {}
    for n, s, e, _, a in spans:
        if n == "request.queued" and not a.get("restored"):
            queued.setdefault(a["rid"], (s, e))
    late = [queued[r][0] - due[r] for r in queued if r in due]
    wait = [e - s for s, e in queued.values()]
    pre = [e - s for n, s, e, _, _ in spans if n == "engine.prefill"]
    out["queue_ms"] = {k: [p([v * 1e3 for v in vals], 50),
                           p([v * 1e3 for v in vals], 90)]
                       for k, vals in (("due_to_submit", late),
                                       ("submit_to_admit", wait),
                                       ("prefill", pre))}
    if rec.kill is not None:
        k = rec.kill
        first = next((t for rid, t in zip(rec.sink.order, rec.sink.times)
                      if t > k["t"] and any(a.rid == rid and
                                            a.rank == k["rank"]
                                            for a in rec.arrivals)), None)

        def one(name):
            return next(((s, e, a) for n, s, e, _, a in spans if n == name
                         and a.get("rank") == k["rank"] and s >= k["t"]),
                        None)
        comp, rest, rep = (one(n) for n in ("recover.compose",
                                            "recover.restore",
                                            "recover.replay"))
        start = (comp or rest or (None,))[0]
        out["recovery_s"] = {
            "kill_to_respawn": start - k["t"] if start else None,
            "compose": comp[1] - comp[0] if comp else None,
            "restore": rest[1] - rest[0] if rest else None,
            "replay": rep[1] - rep[0] if rep else None,
            "replayed_tokens": rep[2].get("tokens") if rep else None,
            "kill_to_first_token": first - k["t"] if first else None}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    t_start = time.monotonic()
    prepare()
    from ftbench.harness import bench, spec, traffic
    from ftbench.metrics import _program
    cell = spec.load(args.workload)
    st = bench.make_setup(cell, args.seed, args.device)
    arrivals, fault = traffic.generate(cell.mix, cell.config, args.seed,
                                       args.seconds, cell.rate)
    st.warm_s = bench.warm_up(st, arrivals)
    rec = bench.serve_window(st, arrivals, fault, args.seconds, True,
                             t_start, [_program.instrument])
    out = dict(summary(rec), workload=cell.name, seed=args.seed,
               setup_s=rec.setup_s, warm_s=st.warm_s,
               card=bench.power_limit() if args.device == "cuda" else "none")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
