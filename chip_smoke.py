"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the checksum kernels (K1 tile digests, K2 whole-leaf digest,
     K3 dirty-tile gather) from `src/repro_torch/kernels/checksum/csrc`;
  2. hold each kernel bit for bit against its plain PyTorch version at the
     main path's shapes (the paper-demo embedding table (32768, 768) fp32,
     a bf16 leaf, an odd-length leaf, a bool leaf, a 5 %-dirty tile set),
     and time kernel, plain version and, for K3, `torch.index_select`;
  3. the main path at full width: `repro_torch.launch.train --arch
     paper-demo` (batch 8, seq 256) twice with a fault and twice without —
     full saves + a process fault under reinit, and delta saves
     (--ckpt-delta-every 4) + a node fault under cr, which reloads from
     files — each faulted run's final state bit-identical to its twin's;
  4. a sparse-dirt checkpoint: FileCheckpointer(delta_every=4) on the
     full paper-demo train state with a 5 % window of every leaf changed
     between saves, so the delta save gathers dirty tiles on the card;
  5. the kernel report. Launches are counted per path: the counts are
     set to 0 just before each train CLI run and each sparse save and
     read just after it. K2 must launch on the full-save runs, K1 on the
     delta-cadence runs, and K3 (which training never reaches: AdamW
     dirties every tile) on the sparse-dirt saves.

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository around it, the script fails before printing any result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK = os.path.join(HERE, "build", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
INT32_OPS_PER_S = 67e12       # the guide's non-tensor 32-bit rate (fp32)
STEPS = 6


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def timed(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """Mean milliseconds per call of back-to-back calls: on the card, by
    CUDA events, and on the host, to issue them. Where the two are close
    the host's per-call cost, not the kernel, sets the event time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def max_abs_err(a, b) -> int:
    """Largest difference of two int32 tensors read as uint32 values."""
    m = 0xFFFFFFFF
    d = (a.to("cpu").long() & m) - (b.to("cpu").long() & m)
    return int(d.abs().max()) if d.numel() else 0


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, ops):
    """Phase 2: every kernel against its plain version; timings."""
    from repro_torch.kernels.checksum.ref import TILE_WORDS, n_tiles
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((32768, 768), generator=g, device="cuda")
    leaves = {
        "embedding table (32768, 768) float32": table,
        "bf16 leaf (8, 768, 3072)": torch.randn(
            (8, 768, 3072), generator=g, device="cuda").to(torch.bfloat16),
        "odd-length float16 (769769,)": torch.randn(
            769769, generator=g, device="cuda").to(torch.float16),
        "bool (4096003,)": torch.rand(4096003, generator=g,
                                      device="cuda") > 0.5,
    }
    for name, x in leaves.items():
        b = ops.byte_stream(x)
        nt = n_tiles(b.numel())
        errs = [
            max_abs_err(ops.tile_checksums_kernel(b),
                        ops.tile_checksums_plain(b)),
            max_abs_err(ops.checksum_words_kernel(b),
                        ops.checksum_words_plain(b)),
        ]
        idx = torch.arange(0, nt, 7, dtype=torch.int32, device="cuda")
        errs.append(max_abs_err(ops.gather_tiles_kernel(b, idx),
                                ops.gather_tiles_plain(b, idx)))
        torch.cuda.synchronize()
        print(f"[kernels] {name}: max_abs_err K1 {errs[0]} K2 {errs[1]} "
              f"K3 {errs[2]}")
        if any(errs):
            fail(f"kernel disagrees with its plain version on {name}")

    # timings at the main path's largest leaf, the embedding table
    b = ops.byte_stream(table)
    n_words = b.numel() // 4
    nt = n_tiles(b.numel())
    perm = torch.randperm(nt, generator=g, device="cuda")
    idx = perm[:nt // 20].sort().values.to(torch.int32)      # 5 % dirty
    tiles2d = b.view(torch.int32).reshape(nt, TILE_WORDS)
    idx_long = idx.long()
    k = idx.numel()
    rows = {}
    for name, kern, plain, nbytes, n_ops, lib in (
            ("tile_checksums", lambda: ops.tile_checksums_kernel(b),
             lambda: ops.tile_checksums_plain(b),
             4 * n_words + 12 * nt, 9 * n_words, None),
            ("checksum_words", lambda: ops.checksum_words_kernel(b),
             lambda: ops.checksum_words_plain(b),
             4 * n_words + 8, 6 * n_words, None),
            ("gather_tiles", lambda: ops.gather_tiles_kernel(b, idx),
             lambda: ops.gather_tiles_plain(b, idx),
             2 * k * 4 * TILE_WORDS + 4 * k, 0,
             lambda: torch.index_select(tiles2d, 0, idx_long))):
        err = max_abs_err(kern(), plain())
        if err:
            fail(f"{name} disagrees with its plain version")
        ms, host_ms = timed(kern)
        plain_ms = timed(plain, iters=5, warmup=1)[0]
        lib_ms = timed(lib)[0] if lib is not None else None
        bms, by = bound_ms(nbytes, n_ops)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        print(f"[kernels] {name} at {tuple(table.shape)} float32"
              + (f", {k} of {nt} tiles" if name == "gather_tiles" else "")
              + f": {ms:.4f} ms (host issue {host_ms:.4f} ms/call, plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by}"
              + (f", index_select {lib_ms:.4f} ms" if lib_ms else "") + ")")
    return rows


def final_digests(ckpt_dir: str) -> dict:
    """Leaf digests of the newest checkpoint, after a verified load (the
    host-side numpy digest re-checks what the kernels wrote)."""
    from repro_torch.checkpoint import FileCheckpointer
    ck = FileCheckpointer(ckpt_dir)
    man, _ = ck.load(ck.steps()[-1], verify=True)
    return {"step": man.step,
            "digests": {k: m["digest"] for k, m in man.leaves.items()}}


def phase_train(torch, ops) -> dict:
    """Phase 3: the main path at full width, each fault run vs its twin.
    Returns {run name: kernel launches over its fault and twin runs}."""
    from repro_torch.launch.train import main
    runs = {   # name: (checkpoint and strategy flags, fault flags)
        "reinit-process-full": (["--strategy", "reinit"],
                                ["--fail-kind", "process"]),
        "cr-node-delta4": (["--strategy", "cr", "--ckpt-delta-every", "4"],
                           ["--fail-kind", "node"]),
    }
    launches = {}
    for name, (flags, fault) in runs.items():
        out = {}
        launches[name] = {k: 0 for k in ops.LAUNCHES}
        for twin in (False, True):
            tag = f"{name}-{'twin' if twin else 'fault'}"
            d = os.path.join(WORK, tag)
            args = ["--arch", "paper-demo", "--steps", str(STEPS),
                    "--ckpt-dir", d, "--report", d + ".json", "--seed", "0",
                    *flags, *([] if twin else fault)]
            t0 = time.monotonic()
            ops.reset_launches()
            if main(args) != 0:
                fail(f"{tag}: train CLI failed")
            torch.cuda.synchronize()
            for k, n in ops.LAUNCHES.items():
                launches[name][k] += n
            wall = time.monotonic() - t0
            with open(d + ".json") as f:
                summary = json.load(f)
            out[twin] = final_digests(d)
            print(f"[train] {tag}: {wall:.1f} s, first_loss "
                  f"{summary['first_loss']:.4f} last_loss "
                  f"{summary['last_loss']:.4f} recoveries "
                  f"{summary['recoveries']}")
            if summary["final_step"] != STEPS:
                fail(f"{tag}: final_step {summary['final_step']}")
            if not twin and len(summary["recoveries"]) != 1:
                fail(f"{tag}: expected one recovery")
            shutil.rmtree(d)
        if out[False] != out[True]:
            fail(f"{name}: final state differs from the fault-free twin")
        print(f"[train] {name}: final state bit-identical to its twin "
              f"({len(out[True]['digests'])} leaves); launches "
              f"{launches[name]}")
    return launches


def phase_sparse_dirt(torch, ops) -> dict:
    """Phase 4: delta saves of the full train state with 5 % dirt.
    Returns the kernel launches of the three saves."""
    from repro_torch.checkpoint import FileCheckpointer, flatten_leaves
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = Model(get_config("paper-demo")).init(gen)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    state_bytes = sum(v.nbytes for v in flatten_leaves(state).values())

    def mutate(tree, step, frac=0.05):
        if isinstance(tree, dict):
            return {k: mutate(v, step, frac) for k, v in tree.items()}
        flat = tree.reshape(-1).clone()
        n = flat.numel()
        if n < 2 or not flat.is_floating_point():
            return tree
        w = max(1, int(n * frac))
        start = (step * w) % max(1, n - w)
        flat[start:start + w] += 1.0
        return flat.reshape(tree.shape)

    d = os.path.join(WORK, "sparse")
    ck = FileCheckpointer(d, n_shards=4, delta_every=4, keep=4)
    launches = {k: 0 for k in ops.LAUNCHES}
    for step in (1, 2, 3):
        if step > 1:
            state = mutate(state, step)
        t0 = time.monotonic()
        ops.reset_launches()
        ck.save(step, state)
        torch.cuda.synchronize()
        for k, n in ops.LAUNCHES.items():
            launches[k] += n
        w = ck.last_write
        print(f"[sparse] save {step}: {w['kind']}, {time.monotonic() - t0:.2f}"
              f" s, d2h_bytes / state_bytes = "
              f"{w['d2h_bytes'] / state_bytes:.4f}")
        if step > 1 and w["kind"] != "delta":
            fail("a 5 %-dirty save did not write a delta")
    man, loaded = ck.load(3, verify=True)
    flat = flatten_leaves(state)
    got = flatten_leaves(loaded)
    for k, v in flat.items():
        if not torch.equal(torch.from_numpy(got[k].copy()).to("cuda"), v):
            fail(f"sparse-dirt chain restored {k} wrong")
    print(f"[sparse] chain full+2 deltas loaded and verified "
          f"({len(flat)} leaves, {state_bytes} bytes)")
    ck.close()
    shutil.rmtree(d)
    print(f"[sparse] launches {launches}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.device import set_deterministic
    set_deterministic()              # before CUDA initialises
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from repro_torch.kernels.checksum import _build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.monotonic()
    _build.lib()
    print(f"[build] {time.monotonic() - t0:.1f} s "
          f"({_build.build_info['path']})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rows = phase_kernels(torch, ops)

    by_path = phase_train(torch, ops)
    by_path["sparse-dirt"] = phase_sparse_dirt(torch, ops)
    shutil.rmtree(WORK, ignore_errors=True)
    # the path each kernel must launch on
    required = {"checksum_words": "reinit-process-full",
                "tile_checksums": "cr-node-delta4",
                "gather_tiles": "sparse-dirt"}
    for name, path in required.items():
        if by_path[path][name] <= 0:
            fail(f"kernel {name} never launched on the {path} path")

    src = "src/repro_torch/kernels/checksum/csrc/checksum.cu"
    replaces = {"tile_checksums": "src/repro/kernels/checksum/kernel.py:79",
                "checksum_words": "src/repro/kernels/checksum/kernel.py:142",
                "gather_tiles": "src/repro/kernels/checksum/kernel.py:121"}
    report = [{"name": name, "route": "cuda", "source": src,
               "replaces": replaces[name],
               "launches": sum(c[name] for c in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               **rows[name]} for name in ("tile_checksums",
                                          "checksum_words", "gather_tiles")]
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
