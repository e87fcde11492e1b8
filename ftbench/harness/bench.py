"""One run of a cell: set up the program from the seed, serve the
cell's open-loop traffic through a rank kill for the measured window,
read the metrics, check the outputs against the plain reference, and
build the result line.

The program under test is `repro_torch`'s fault-tolerant serving path:
`ServeCluster.run` drives `ServeEngine.step` on each rank (admission's
prefill and the decode step of `Model`, which launch F1 or S1), and
`ServeReplicator.publish`/`compose` replicate each rank's state into its
buddy's `BuddyStore`. The benchmark hands it the seeded weights and the
requests, and takes back the delivered tokens (through its own timed
ledger, `LedgerSink`), the cluster's kill record and, in a traced run,
the spans of its own wrappers and the profiler's device trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import resource
import subprocess
import sys
import time

from . import check, spec, traffic
from .spans import Spans
from .trace import DeviceTrace, busy_intervals, device_time_by_name, \
    idle_gaps

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class WindowDone(Exception):
    """Raised from the load's `due` once the window has closed and the
    requests due in it are served (or the drain's time is up)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def model_config(config: dict):
    """The port's ModelConfig of a configuration file (its keys that are
    ModelConfig fields)."""
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config.items() if k in names})


def reference_module(config: dict):
    return importlib.import_module(f"ftbench.reference.{config['reference']}")


@dataclasses.dataclass
class Setup:
    """The program and its inputs, made from the seed."""
    cell: spec.Cell
    seed: int
    device: str
    torch: object
    sizes: object                    # yardstick Sizes of the configuration
    model: object
    params: dict
    ref: object                      # the reference module
    warm_s: float = 0.0


def make_setup(cell: spec.Cell, seed: int, device: str) -> Setup:
    import torch
    from repro_torch.device import set_deterministic
    set_deterministic()
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from ftbench.yardstick.flops import Sizes
    cfg = model_config(cell.config)
    model = Model(cfg, ExecConfig(**cell.config["exec"]))
    sizes = Sizes(dict(cell.config, moe_group=model.ec.moe_group))
    ref = reference_module(cell.config)
    params = ref.make_weights(sizes, seed, device)
    return Setup(cell, seed, device, torch, sizes, model, params, ref)


def cluster_kw(mix: dict, config: dict) -> dict:
    c = mix["cluster"]
    return dict(world=c["world"], n_slots=c["n_slots"],
                max_len=config["assumed"]["max_len"], strategy=c["strategy"],
                publish_every=c["publish_every"],
                respawn_delay=c["respawn_delay"], base_every=c["base_every"],
                prefill_batch=c["prefill_batch"])


class _Frames:
    """A frame store for the warm-up's publishes."""

    def __init__(self):
        self.frames = {}

    def save(self, step, payload):
        self.frames[step] = payload


def warm_up(st: Setup, arrivals) -> float:
    """One prefill at the traffic's longest prompt and a decode step, a
    publish after each (a full frame and a delta), a compose and a
    restore, on an engine of the cell's shape: kernels built, pinned host
    buffers and device memory cached. Returns its seconds."""
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.replicate import ServeReplicator
    t0 = time.monotonic()
    kw = cluster_kw(st.cell.mix, st.cell.config)
    eng = ServeEngine(st.model, st.params, n_slots=kw["n_slots"],
                      max_len=kw["max_len"],
                      prefill_batch=kw["prefill_batch"], name="warm")
    longest = max(arrivals, key=lambda a: len(a.prompt))
    eng.submit(Request(rid=0, prompt=list(longest.prompt), max_new_tokens=3))
    frames = _Frames()
    rep = ServeReplicator(frames, base_every=kw["base_every"])
    for _ in range(2):
        eng.step()
        rep.publish(eng)
    eng.restore(ServeReplicator.compose(frames.frames))
    if st.device == "cuda":
        st.torch.cuda.synchronize()
    del eng, rep, frames
    gc.collect()
    return time.monotonic() - t0


class LedgerSink:
    """The benchmark's own delivery ledger, handed to the cluster in
    place of its `TokenSink` (the same `tokens`, `order` and
    `delivered`). It keeps each request's tokens in index order, the time
    of its first and last token and of every delivery, and every fault:
    an index delivered twice (the token is not kept again) or an index
    skipped (the token is kept, the gap counted)."""

    def __init__(self):
        self.tokens, self.order, self.times = {}, [], []
        self.first, self.last = {}, {}
        self.faults = []                 # (rid, idx, the index expected)

    def __call__(self, rid, idx, tok):
        got = self.tokens.setdefault(rid, [])
        if idx != len(got):
            self.faults.append((rid, idx, len(got)))
            if idx < len(got):
                return
        t = time.monotonic()
        got.append(int(tok))
        self.order.append(rid)
        self.first.setdefault(rid, t)
        self.last[rid] = t
        self.times.append(t)

    def delivered(self, rid) -> int:
        return len(self.tokens.get(rid, ()))


@dataclasses.dataclass
class Record:
    """What one run leaves for the metric readers and the check."""
    cell: spec.Cell
    sizes: object
    seed: int
    seconds: float
    t0: float                        # the window's start (monotonic)
    setup_s: float
    arrivals: list                   # traffic.Arrival, with due_abs
    fault: object
    max_len: int
    sink: object = None
    kill: dict = None                # {"rank", "t"} of the kill
    cluster_metrics: dict = None
    t_close: float = None            # when the window closed
    t_end: float = None              # when the drain ended
    spans: Spans = None
    device: DeviceTrace = None
    launches: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    replicated: int = 0              # bytes published by the live ranks
    check_info: dict = None

    @property
    def window(self) -> tuple:
        return self.t0, self.t0 + self.seconds


class OpenLoop:
    """The cluster's load: arrivals released by the wall clock. `due` is
    called by `ServeCluster.run` for each rank at the start of each
    round; at rank 0 it releases every arrival whose time has come and,
    once the window has closed, ends the run when the requests due in it
    are served or the drain's time is up."""

    def __init__(self, rec: Record, world: int, drain_s: float, on_close):
        from repro_torch.serve.cluster import Arrival
        self.rec, self.drain_s, self.on_close = rec, drain_s, on_close
        self.pending = [Arrival(rid=a.rid, rank=a.rank, round=-1,
                                prompt=a.prompt,
                                max_new_tokens=a.max_new_tokens)
                        for a in rec.arrivals]
        self.arrivals = list(self.pending)
        self.due_at = [a.due_abs for a in rec.arrivals]
        self._i = 0
        self.round = 0                   # the cluster's current round
        self._ready = {r: [] for r in range(world)}
        self._drain_from = None

    def due(self, rnd: int, rank: int):
        rec = self.rec
        self.round = rnd
        if rank == 0:
            now = time.monotonic()
            if rec.t_close is None and now >= rec.t0 + rec.seconds:
                rec.t_close = now
                self.on_close()
                # the drain's time is the server's: it starts once the
                # close's own work (the profiler's flush) is done
                now = self._drain_from = time.monotonic()
            if rec.t_close is not None and (
                    self._served() or now >= self._drain_from + self.drain_s):
                rec.t_end = now
                raise WindowDone
            while self._i < len(self.pending) and self.due_at[self._i] <= now:
                a = self.pending[self._i]
                a.round = rnd
                self._ready[a.rank].append(a)
                self._i += 1
        out, self._ready[rank] = self._ready[rank], []
        return out

    def _served(self) -> bool:
        sink = self.rec.sink
        return all(sink.delivered(a.rid) >= a.expected_tokens(
            self.rec.max_len) for a in self.arrivals)


def serve_window(st: Setup, arrivals, fault, seconds: float, trace: bool,
                 t_start: float, instruments=()) -> Record:
    """Build the cluster, serve the arrivals for `seconds` and drain."""
    torch = st.torch
    from repro_torch.scenarios import hooks
    from repro_torch.serve.cluster import RankKilled, ServeCluster

    kw = cluster_kw(st.cell.mix, st.cell.config)
    spans = Spans() if trace else None
    rec = Record(cell=st.cell, sizes=st.sizes, seed=st.seed, seconds=seconds,
                 t0=0.0, setup_s=0.0, arrivals=arrivals, fault=fault,
                 max_len=kw["max_len"], spans=spans)
    with contextlib.ExitStack() as stack:
        if spans is not None:
            stack.enter_context(spans.installed(torch))
        for inst in instruments:
            stack.enter_context(inst(rec))
        cluster = ServeCluster(st.model, st.params, **kw)
        sink = LedgerSink()
        cluster.sink = sink
        for eng in cluster.engines.values():
            eng.sink = sink
        rec.sink = sink
        fired = [False]

        def inject(point, **ctx):
            if fired[0] or fault is None or point != fault.point:
                return
            eng = ctx.get("engine")
            if eng is None or eng.name != f"rank{fault.rank}":
                return
            if load.round < fault.round:
                return
            fired[0] = True
            rec.kill = {"rank": fault.rank, "t": time.monotonic()}
            raise RankKilled(fault.rank)

        dev = DeviceTrace(torch) if trace and st.device == "cuda" else None
        rec.device = dev
        if st.device == "cuda":
            torch.cuda.synchronize()
        if dev is not None:
            dev.start()
        rec.t0 = time.monotonic()
        rec.setup_s = rec.t0 - t_start
        for a in arrivals:
            a.due_abs = rec.t0 + a.due_s
        load = OpenLoop(rec, kw["world"], st.cell.mix["check"]["drain_s"],
                        on_close=(dev.stop if dev is not None else
                                  (lambda: None)))
        hooks.install(inject)
        try:
            cluster.run(load, rounds=1 << 62, drain_rounds=0)
        except WindowDone:
            pass
        finally:
            hooks.clear()
        if st.device == "cuda":
            torch.cuda.synchronize()
            rec.peak_bytes = int(torch.cuda.max_memory_allocated())
        rec.cluster_metrics = cluster.metrics
        rec.replicated = sum(r.bytes_published for r in cluster.reps.values())
        del cluster, load
    gc.collect()
    if st.device == "cuda":
        torch.cuda.empty_cache()
    if dev is not None:
        dev.collect()
    return rec


def served(rec: Record) -> dict:
    """rid -> delivered tokens of every request served whole: exactly the
    tokens it is owed."""
    out = {}
    for a in rec.arrivals:
        toks = rec.sink.tokens.get(a.rid, [])
        if len(toks) == check.expected_tokens(a, rec.max_len):
            out[a.rid] = list(toks)
    return out


def reference_logits(st: Setup, requests: list, quant=None) -> list:
    lanes = st.cell.mix["cluster"]["prefill_batch"]
    return st.ref.logits_at(st.params, st.sizes, requests, lanes=lanes,
                            quant=quant)


def verify(st: Setup, rec: Record, quant=None) -> dict:
    """The numbers compared, each {"value", "limit"}. With `quant`, the
    control: at each served position of the sample, the token that the
    reference computed at that precision puts first stands in the
    program's place."""
    got = served(rec)
    owed = {a.rid: check.expected_tokens(a, rec.max_len)
            for a in rec.arrivals}
    short = sum(rec.sink.delivered(r) < n for r, n in owed.items())
    surplus = sum(rec.sink.delivered(r) > n for r, n in owed.items())
    rids = check.sample(rec.arrivals, got, rec.kill, rec.sink.last,
                        st.cell.mix["check"]["requests"], rec.seed)
    by = {a.rid: a for a in rec.arrivals}
    reqs = [(by[r].prompt, got[r]) for r in rids]
    t0 = time.monotonic()
    gap = 0.0
    if reqs:
        toks = [s for _, s in reqs]
        if quant is not None:
            toks = [lo.argmax(-1).tolist()
                    for lo in reference_logits(st, reqs, quant)]
        logits = reference_logits(st, reqs)
        gap = float(max(g.max() for g in check.gaps(logits, toks)))
        del logits
    rec.check_info = {"requests": len(reqs),
                      "tokens": sum(len(s) for _, s in reqs),
                      "reference_s": time.monotonic() - t0}
    return {"undelivered": {"value": short, "limit": 0},
            "ledger_faults": {"value": len(rec.sink.faults) + surplus,
                              "limit": 0},
            "max_logit_gap": {"value": gap,
                              "limit": st.cell.limits["max_logit_gap"]}}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return out


def breakdown(rec: Record) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host span around each."""
    lo, hi = rec.t0, rec.t_close
    ops = sorted(device_time_by_name(rec.device.events, lo, hi).items(),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(busy_intervals(rec.device.events, lo, hi), lo,
                            hi), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        around = [sp for sp in rec.spans.spans if sp[1] <= mid <= sp[2]]
        name = min(around, key=lambda sp: sp[2] - sp[1])[0] if around \
            else "no host span (between rounds)"
        named.append([name, e - s])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> tuple:
    """One run -> (result dict, lines for standard error)."""
    st = make_setup(cell, seed, device)
    arrivals, fault = traffic.generate(cell.mix, cell.config, seed, seconds,
                                       cell.rate)
    st.warm_s = warm_up(st, arrivals)
    readers = cell.per_layer if trace else cell.end_to_end
    instruments = [cell.readers[m["name"]].instrument for m in readers
                   if hasattr(cell.readers[m["name"]], "instrument")]
    rec = serve_window(st, arrivals, fault, seconds, trace, t_start,
                       instruments)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    metrics = {}
    for m in readers:
        v = cell.readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    err = []
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": st.torch.cuda.get_device_name(0) if device == "cuda"
           else device, "count": cell.chips,
           "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": False, "attempted": len(arrivals), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and rec.device is not None:
        busy = busy_intervals(rec.device.events, rec.t0, rec.t_close)
        dev["busy_s"] = sum(e - s for s, e in busy)
        dev["window_s"] = rec.t_close - rec.t0
        result["breakdown"] = breakdown(rec)
        rec.device.events = []
    checks = verify(st, rec)
    result["failed"] = checks["undelivered"]["value"]
    result["correct"] = passes(checks)
    kill = dict(rec.kill or {})
    km = (rec.cluster_metrics or {}).get("kills") or [{}]
    info = {"setup_s": rec.setup_s, "warm_s": st.warm_s,
            "card": power_limit() if device == "cuda" else "none",
            "kill": {"rank": kill.get("rank"),
                     "at_s": kill["t"] - rec.t0 if kill else None,
                     **{k: km[0].get(k) for k in
                        ("round", "rounds_down", "replayed_tokens")}},
            "tokens_delivered": len(rec.sink.order),
            "bytes_published": rec.replicated,
            "drain_s": rec.t_end - rec.t_close,
            "host_rss_peak_bytes":
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "check": rec.check_info}
    if rec.sink.faults:
        info["ledger_faults"] = rec.sink.faults[:10]
    result["info"] = info
    result["checks"] = checks
    for name, c in checks.items():
        err.append(check.line(name, c["value"], c["limit"]))
    return result, err
