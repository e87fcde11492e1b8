"""Multi-pod dry run: trace every (arch × shape × mesh) cell at production
scale without a device (the counterpart of the JAX package's
`launch/dryrun.py`).

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k \\
        --mesh pod --out DIR
    python -m repro_torch.launch.dryrun --arch all --mesh multipod --out DIR

The reference lowers and compiles each cell's step for a 256- or
512-device mesh of fake host devices and reads XLA's analyses. The port
runs the step itself, once, on fake tensors (`FakeTensorMode`: shapes,
dtypes and devices, no storage) under a fake process group of the
mesh's world (`make_production_mesh`: 16×16 `pod`, 2×16×16 `multipod`),
every leaf a DTensor placed by the reference's rules, and
`launch/trace_analysis.StepTrace` watches what one device does. Each cell
writes one JSON artifact with the reference's keys (`benchmarks/
roofline.py` reads `chips`, `analytic.*` and `collective_bytes.total`):

  - memory: argument/output/temp/alias bytes of one device (proves fit);
  - cost_analysis: the FLOPs and bytes of one device's local ops;
  - collective_bytes: each collective kind's result bytes on one device;
  - analytic: `models/flops.cell_cost` (totals across the mesh);
  - trace_s, the wall time of the trace (in place of the reference's
    lower_s and compile_s), and the device the tensors claim.

The traced tensors claim the device a production run uses (`--device`,
`cuda` unless named). They are fake, so the dry run needs no card. A
torch built without CUDA cannot index a CUDA tensor, fake or not (Python
indexing takes a CUDA device guard such a build does not have), so there
the tensors and the mesh take `cpu` instead, and the artifact says so;
the ops, shapes, placements and counts are the same.

Serving cells (prefill, decode) hold their parameters in bfloat16, train
cells in the config's dtype. A train step accumulates gradients over
`--microbatches` (each device splits its own rows of the batch), runs
AdamW and, with `--with-buddy`, the buddy memory checkpoint
(`checkpoint.memory_ckpt.buddy_exchange`: each data shard sent to the
next rank of the data axis, the reference's collective-permute). A decode
step is traced at position S - 1: the port takes a scalar position as a
Python int, and the step's work does not depend on it. What the port
does not have: `--no-scan` (the layer loop is Python, so the trace is
always unrolled) and `--no-donate` (a decode step writes its state in
place, a train step returns new leaves; `memory.alias_bytes` reads which)
are accepted and change nothing; `--remat` takes "none" and "full", as
`ExecConfig` does; `--save-hlo FILE` writes the traced collectives, one
line each.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config, shape_applicable
from repro_torch.models.config import ShapeConfig
from repro_torch.models.flops import cell_cost
from repro_torch.models.model import Model, _fake_mode
from repro_torch.models.transformer import ExecConfig
from repro_torch.sharding.partition import (NamedSharding, _divisible,
                                            batch_spec, constraint_scope,
                                            distribute_tree, named,
                                            state_shardings)
from repro_torch.sharding.rules import PRESETS
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.trace_analysis import StepTrace


def trace_device(device=None) -> torch.device:
    """The device the traced tensors claim: `device` (`cuda` unless
    named), or `cpu` for `cuda` on a torch built without CUDA."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("cpu")
    return dev


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of `world` ranks, this process rank 0: every
    collective is a no-op that returns tensors of the right shapes."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def batch_shardings(mesh, rules, batch):
    """NamedShardings for the input dict (tokens/labels/embeddings…): the
    batch dim over the rules' batch axes where it divides."""
    return {k: named(mesh, _divisible(batch_spec(rules), v.shape, mesh))
            for k, v in batch.items()}


def build_cell(arch: str, shape, multi_pod: bool, ec: ExecConfig, *,
               device=None, mesh_shape=None):
    """(cfg, shape, model, mesh, rules), "" for a cell, or None and why
    `shape_applicable` refuses it. `shape` is a name of `SHAPES` or a
    ShapeConfig; `mesh_shape` a (data, model) mesh in place of the
    production one. The mesh needs a process group of its size
    (`fake_world`)."""
    cfg = get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, why
    if shape.kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")    # serving dtype
    model = Model(cfg, ec)
    dev = trace_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev) \
        if mesh_shape is None else \
        make_host_mesh(tuple(mesh_shape), ("data", "model"), device=dev)
    return (cfg, shape, model, mesh, cell_rules(cfg, shape, mesh,
                                                multi_pod)), ""


def cell_rules(cfg, shape: ShapeConfig, mesh, multi_pod: bool):
    """The sharding rules of a cell: the pod or multipod preset, its
    serving variant for prefill and decode."""
    if shape.kind == "train":
        rules = PRESETS["multipod" if multi_pod else "pod"]
    else:
        rules = PRESETS["multipod_serve" if multi_pod else "pod_serve"]
    # kv heads shard over the model axis only when they divide it evenly
    # (olmoe/seamless: 16 kv heads on a 16-way axis); otherwise they stay
    # replicated and the GQA expansion is local (rules.py comment).
    model_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    if (shape.kind == "train" and cfg.n_kv_heads
            and cfg.n_kv_heads % model_size == 0):
        rules = dataclasses.replace(rules, kv_heads="model")
    return rules


def _microbatches(batch: dict, M: int) -> list:
    """M microbatches of a batch of DTensors, each device taking its own
    rows in M slices (each stays placed as it was, with 1/M of the
    batch)."""
    from torch.distributed.tensor import DTensor

    def cut(t, i):
        local = t.to_local().chunk(M)[i]
        shape = (t.shape[0] // M, *t.shape[1:])
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(local, t.device_mesh, t.placements,
                                  run_check=False, shape=shape,
                                  stride=tuple(stride))

    return [{k: cut(v, i) for k, v in batch.items()} for i in range(M)]


def _train_step(model: Model, mesh, rules, with_buddy: bool):
    opt_cfg = AdamWConfig()
    M = model.ec.microbatches

    def grad_of(params, batch):
        loss, _ = model.loss_fn(params, batch)
        return loss, torch.autograd.grad(loss, tree_leaves(params))

    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        if M > 1:
            # gradient accumulation: activation live-set shrinks by M,
            # FSDP weight gathers repeat per microbatch (the classic
            # memory ↔ collective trade)
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in tree_leaves(params)]
            lsum = 0.0
            for mb in _microbatches(batch, M):
                loss, g = grad_of(params, mb)
                gsum = [a + b for a, b in zip(gsum, g)]
                lsum = lsum + loss.detach()
            grads, loss = [g / M for g in gsum], lsum / M
        else:
            loss, grads = grad_of(params, batch)
            loss = loss.detach()
        with torch.no_grad():
            new_p, new_opt, _ = adamw_update(
                state["params"], tree_unflatten(params, list(grads)),
                state["opt"], opt_cfg)
        new = {"params": new_p, "opt": new_opt, "step": state["step"] + 1}
        # laid out as the input was (a replicated leaf's update comes
        # back as a pending sum), as the sharded trainer does
        new = tree_map(lambda a, s: a.redistribute(s.mesh, s.placements),
                       new, state_shardings(mesh, new, rules))
        if not with_buddy:
            return new, loss
        from repro_torch.checkpoint.memory_ckpt import buddy_exchange
        return new, (loss, buddy_exchange(new, mesh, rules))

    return train_step


def lower_cell(cfg, shape: ShapeConfig, model: Model, mesh, rules,
               donate: bool = True, with_buddy: bool = False, *,
               device=None) -> tuple[StepTrace, dict]:
    """Trace the cell's step once on fake tensors placed on `mesh`:
    (the StepTrace, {"trace_s"}). with_buddy=True (train cells) fuses the
    paper's buddy memory checkpoint into the step: the post-update state
    is sent one step along the data axis and returned as a second output
    (the redundant copy lives on the neighbour device). `donate` is
    accepted for the reference's signature and changes nothing."""
    dev = trace_device(device)
    mode = _fake_mode()
    params = model.abstract_params(device=dev, mode=mode)
    with mode:
        specs = model.input_specs(shape, device=dev, mode=mode)
        if shape.kind == "train":
            state = {"params": params, "opt": adamw_init(params),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)}
            args = (distribute_tree(state, state_shardings(mesh, state, rules)),
                    distribute_tree(specs, batch_shardings(mesh, rules, specs)))
            fn = _train_step(model, mesh, rules, with_buddy)
        elif shape.kind == "prefill":
            args = (distribute_tree(params, state_shardings(mesh, params, rules)),
                    distribute_tree(specs, batch_shardings(mesh, rules, specs)))

            def fn(params, batch):
                with torch.no_grad():
                    return model.prefill(params, batch, max_len=shape.seq_len)
        else:  # decode
            state = specs["state"]
            s_sh = tree_map(
                lambda leaf, s: NamedSharding(mesh, _divisible(
                    s, leaf.shape, mesh)),
                state, model.decode_state_specs(rules))
            token = {"token": specs["token"]}
            args = (distribute_tree(params, state_shardings(mesh, params, rules)),
                    distribute_tree(token, batch_shardings(mesh, rules, token))
                    ["token"], distribute_tree(state, s_sh))

            def fn(params, token, state):
                with torch.no_grad():
                    return model.decode_step(params, token, state,
                                             shape.seq_len - 1)
        trace = StepTrace(args)
        with constraint_scope(mesh, rules):
            t0 = time.monotonic()
            with trace:
                out = fn(*args)
            t_trace = time.monotonic() - t0
        trace.finish(out)
    return trace, {"trace_s": t_trace}


def run_cell(arch: str, shape, multi_pod: bool,
             out_path: str | None = None, ec: ExecConfig | None = None,
             donate: bool = True, save_hlo: str | None = None,
             with_buddy: bool = False, *, device=None,
             mesh_shape=None) -> dict:
    """Trace one cell under a fake world of its mesh's size and return
    (and write to `out_path`) its artifact. `shape` is a name of `SHAPES`
    or a ShapeConfig, `mesh_shape` a (data, model) mesh in place of the
    production one (`multi_pod` then only picks the rules)."""
    ec = ec or ExecConfig()
    shape_name = shape if isinstance(shape, str) else shape.name
    mesh_name = "multipod" if multi_pod else "pod"
    if mesh_shape is not None:
        mesh_name = "x".join(map(str, mesh_shape))
    world = 1
    for n in (mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))):
        world *= n
    with fake_world(world):
        built, why = build_cell(arch, shape, multi_pod, ec, device=device,
                                mesh_shape=mesh_shape)
        if built is None:
            result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                      "skipped": why}
        else:
            cfg, shape, model, mesh, rules = built
            trace, meta = lower_cell(
                cfg, shape, model, mesh, rules, donate=donate,
                with_buddy=with_buddy and shape.kind == "train",
                device=device)
            ac = cell_cost(cfg, shape, flash=(ec.attn_impl == "pallas"),
                           moe_group=ec.moe_group)
            result = {
                "arch": arch, "shape": shape_name, "mesh": mesh_name,
                "chips": mesh.size(),
                "device": trace_device(device).type,
                "exec_config": dataclasses.asdict(ec),
                "trace_s": meta["trace_s"],
                "memory": trace.memory(),
                "cost_analysis": {
                    "flops_per_device": trace.flops,
                    "bytes_per_device": trace.bytes_accessed,
                },
                "collective_bytes": trace.collective_summary(),
                "analytic": {
                    "flops_total": ac.flops,
                    "hbm_bytes_total": ac.hbm_bytes,
                    "model_flops": ac.details["model_flops"],
                },
            }
            if save_hlo:
                with open(save_hlo, "w") as f:
                    for kind, nbytes in trace.collectives:
                        f.write(f"{kind} {nbytes}\n")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default="")
    ap.add_argument("--attn-impl", default="chunked")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--no-scan", action="store_true",
                    help="accepted; the port's trace is always unrolled")
    ap.add_argument("--no-donate", action="store_true",
                    help="accepted; changes nothing in the port")
    ap.add_argument("--with-buddy", action="store_true",
                    help="fuse the buddy memory checkpoint (the train "
                         "state's shards sent along the data axis) into "
                         "the traced step")
    ap.add_argument("--save-hlo", default="",
                    help="write the traced collectives to this file")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim")
    args = ap.parse_args(argv)

    ec = ExecConfig(attn_impl=args.attn_impl, remat_policy=args.remat,
                    microbatches=args.microbatches)
    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    failures = []
    for arch in archs:
        for shape in shapes:
            out = None
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                out = os.path.join(
                    args.out, f"{arch}__{shape}__{args.mesh}.json")
            try:
                r = run_cell(arch, shape, args.mesh == "multipod",
                             out_path=out, ec=ec,
                             donate=not args.no_donate,
                             save_hlo=args.save_hlo or None,
                             with_buddy=args.with_buddy,
                             device=args.device)
                if "skipped" in r:
                    print(f"[dryrun] {arch} × {shape} × {args.mesh}: "
                          f"SKIP ({r['skipped']})")
                else:
                    print(f"[dryrun] {arch} × {shape} × {args.mesh}: OK "
                          f"trace={r['trace_s']:.1f}s "
                          f"coll={r['collective_bytes']['total']/1e9:.2f}GB "
                          f"arg={r['memory']['argument_bytes']/1e9:.2f}GB",
                          flush=True)
            except Exception as e:      # noqa: BLE001
                failures.append((arch, shape, str(e)))
                print(f"[dryrun] {arch} × {shape} × {args.mesh}: "
                      f"FAIL {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
