"""The cases the port's sharded tests run in a process world
(`_torch_mesh_worlds.spawn`): each is `case(rank, world, args)`, runs
on every rank, and returns what rank 0 reports. Nothing here imports jax
or the JAX package: the tests compare these results with the reference
in their own process."""
import dataclasses
import os
import shutil

import torch


def _np(t):
    return t.detach().cpu().numpy()


def _full_t(t):
    """A DTensor's whole value (every rank calls it)."""
    from repro_torch.sharding.partition import gather
    return gather(t)


def _full(t):
    return _np(_full_t(t))


# ------------------------------------------------------------- trainer

def trainer(rank, world, args):
    """The sharded trainer on a `world`-way data mesh: a fault-free run
    and a run with an injected process failure, both resumed from the
    step-0 checkpoint in args["ckpt0"], and one sharded save's files
    beside an unsharded save of the same values."""
    from repro_torch.checkpoint import FileCheckpointer
    from repro_torch.checkpoint.manifest import tree_digest
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import FailureType, FaultInjector
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding.partition import gather_tree
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)

    mesh = make_host_mesh((world,), ("data",), device="cpu")
    rules = ShardingRules(batch="data", embed="data")
    cfg = reduced(get_config("paper-demo")).replace(compute_dtype="float32")
    steps = args["steps"]
    data = TokenPipeline(cfg.vocab_size, args["batch"], args["seq"],
                         seed=args["seed"], device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    root = args["dir"]

    def run(tag, injector=None):
        d = os.path.join(root, tag)
        if rank == 0:
            shutil.copytree(args["ckpt0"], d)
        torch.distributed.barrier()
        tr = Trainer(Model(cfg), data, opt,
                     TrainConfig(total_steps=steps, ckpt_dir=d,
                                 strategy="reinit", device="cpu"),
                     mesh=mesh, rules=rules, injector=injector)
        res = tr.run()
        full = gather_tree(tr.state)
        return tr, res, full, d

    tr, ref, full, d_ref = run("fault_free")
    inj = FaultInjector(n_ranks=8, n_steps=steps, kind=FailureType.PROCESS,
                        seed=5)
    ft, res, ft_full, _ = run("fault", injector=inj)
    table = tr.state["params"]["embedding"]["table"]
    out = {
        "losses": ref["losses"], "ft_losses": res["losses"],
        "digest": tree_digest(full["params"]),
        "ft_digest": tree_digest(ft_full["params"]),
        "rollbacks": [r.rollback_step for r in res["reports"]],
        "fail_step": inj.fail_step,
        "table_placements": [str(p) for p in table.placements],
        "table_local_shape": tuple(table.to_local().shape),
        "final_step": int(full["step"]),
    }
    if rank == 0:
        # the files of one sharded save against an unsharded save of the
        # same values
        step_dir = f"step_{steps:010d}"
        plain = os.path.join(root, "plain")
        FileCheckpointer(plain, n_shards=TrainConfig().ckpt_shards).save(
            steps, full)
        names = sorted(os.listdir(os.path.join(d_ref, step_dir)))
        out["frame_files"] = names
        out["frames_equal"] = names == sorted(os.listdir(
            os.path.join(plain, step_dir))) and all(
            open(os.path.join(d_ref, step_dir, n), "rb").read()
            == open(os.path.join(plain, step_dir, n), "rb").read()
            for n in names)
    return out


# -------------------------------------------------------------- engine

def engine(rank, world, args):
    """The sharded engine on a (data, model) mesh with pod_serve: two
    runs of args["prompts"], each with a snapshot and restore after
    args["snap_after"] steps; the KV cache's layout."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sharding.rules import PRESETS

    mesh = make_host_mesh(args["mesh"], ("data", "model"), device="cpu")
    rules = PRESETS["pod_serve"]
    model = Model(args["cfg"], ExecConfig(attn_impl="pallas"))
    params = torch.load(args["params"])

    def run():
        eng = ServeEngine(model, params, n_slots=args["n_slots"],
                          max_len=args["max_len"], mesh=mesh, rules=rules)
        for rid, prompt in enumerate(args["prompts"]):
            eng.submit(Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=args["max_new"]))
        for _ in range(args["snap_after"]):
            eng.step()
        eng.restore(eng.snapshot())
        done = eng.run_until_drained()
        return eng, {r.rid: list(r.out) for r in done}

    eng, out1 = run()
    k = eng.state["k"]
    _, out2 = run()
    return {"out1": out1, "out2": out2,
            "k_placements": [str(p) for p in k.placements],
            "k_mesh": (tuple(k.device_mesh.mesh_dim_names),
                       int(k.device_mesh.size())),
            "k_shape": tuple(k.shape),
            "k_local_shape": tuple(k.to_local().shape)}


# ------------------------------------------------------------ sharding

def sharding(rank, world, args):
    """On 4 ranks: the buddy ring on a (4,) data mesh and on a (2, 2)
    (pod, data) mesh, the multipod batch split's shard order, the
    constraint scope, and F1's and S1's local calls against their plain
    versions; args["prefill"] names reduced configs whose prefill runs
    under a (2, 2) pod_serve mesh against the same model unsharded."""
    from repro_torch.checkpoint import buddy_exchange, restore_from_buddy
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import (
        batch_spec, constraint_scope, distribute, distribute_tree,
        local_offsets, named, shard_constraint, state_shardings)
    from repro_torch.sharding.rules import P, PRESETS, ShardingRules

    out = {}
    # --- buddy ring over a (4,) data mesh: table rows (vocab) and the
    # embed dim sharded over data, a norm scale replicated
    mesh = make_host_mesh((world,), ("data",), device="cpu")
    rules = ShardingRules(batch="data", vocab="data")
    g = torch.Generator().manual_seed(0)
    state = {"embedding": {"table": torch.randn(4 * world, 3, generator=g)},
             "ln_f": {"scale": torch.randn(5, generator=g)},
             "stack": {"layers": {"mlp": {"wo": torch.randn(
                 2, 6, 2 * world, generator=g)}}}}
    rules_e = ShardingRules(batch="data", vocab="data", embed="data")
    for name, r in (("vocab", rules), ("vocab_embed", rules_e)):
        placed = distribute_tree(state, state_shardings(mesh, state, r))
        buddy = buddy_exchange(placed, mesh, r)
        back = restore_from_buddy(buddy, mesh, r)
        out[name] = {
            "table": (_full(buddy["embedding"]["table"]),
                      _full(back["embedding"]["table"])),
            "scale": (_full(buddy["ln_f"]["scale"]),
                      _full(back["ln_f"]["scale"])),
            "wo": (_full(buddy["stack"]["layers"]["mlp"]["wo"]),
                   _full(back["stack"]["layers"]["mlp"]["wo"])),
            "scale_same_object": buddy["ln_f"]["scale"] is
            placed["ln_f"]["scale"],
            "placements": [str(p) for p in
                           placed["stack"]["layers"]["mlp"]["wo"].placements],
        }
    out["state"] = {k: _np(v) for k, v in {
        "table": state["embedding"]["table"], "scale": state["ln_f"]["scale"],
        "wo": state["stack"]["layers"]["mlp"]["wo"]}.items()}
    try:
        buddy_exchange(state, mesh, rules)        # never distributed
        out["plain_raises"] = None
    except ValueError as e:
        out["plain_raises"] = str(e)

    # --- (pod, data) mesh: the multipod batch split, major to minor, and
    # the ring along data within each pod
    mesh2 = make_host_mesh((2, 2), ("pod", "data"), device="cpu")
    mp = PRESETS["multipod"]
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    xb = distribute(x, named(mesh2, batch_spec(mp)))
    coord = mesh2.get_coordinate()
    out["multipod"] = {"coord": tuple(coord), "local": _np(xb.to_local()),
                       "offsets": local_offsets(xb),
                       "placements": [str(p) for p in xb.placements]}
    st = {"embedding": {"table": x}}
    rp = ShardingRules(batch=("pod", "data"), vocab=("pod", "data"))
    placed = distribute_tree(st, state_shardings(mesh2, st, rp))
    out["multipod"]["buddy"] = _full(buddy_exchange(placed, mesh2, rp,
                                                    axis="data")
                                     ["embedding"]["table"])

    # --- the constraint scope: identity outside, a redistribution
    # inside, and a plain tensor inside raises
    mesh22 = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    ps = PRESETS["pod_serve"]
    y = torch.randn(4, 6, 8, generator=g)
    out["scope"] = {"outside_is_identity":
                    shard_constraint(y, "batch", None, "heads") is y}
    with constraint_scope(mesh22, ps):
        yd = distribute(y, named(mesh22, P()))
        z = shard_constraint(yd, "batch", None, "heads")
        out["scope"]["placements"] = [str(p) for p in z.placements]
        out["scope"]["value_kept"] = bool(torch.equal(_full_t(z), y))
        odd = shard_constraint(distribute(torch.randn(3, 5, generator=g),
                                          named(mesh22, P())),
                               "batch", "heads")
        out["scope"]["odd_placements"] = [str(p) for p in odd.placements]
        try:
            shard_constraint(y, "batch", None, "heads")
            out["scope"]["plain_raises"] = None
        except TypeError as e:
            out["scope"]["plain_raises"] = str(e)

        # --- F1 and S1 through local_call: the GQA groups whole on a
        # rank (H 8, Hkv 2 on a 2-way model axis) and cut across ranks
        # (H 4, Hkv 2 on a 4-way axis)
        flash = {}
        for name, m, H, Hkv in (("whole", mesh22, 8, 2),
                                ("cut", make_host_mesh(
                                    (1, 4), ("data", "model"),
                                    device="cpu"), 4, 2)):
            q = torch.randn(2, 7, H, 16, generator=g)
            k = torch.randn(2, 7, Hkv, 16, generator=g)
            v = torch.randn(2, 7, Hkv, 16, generator=g)
            want = flash_attention_ref(q, k, v, causal=True)
            with constraint_scope(m, ps):
                qd, kd, vd = (distribute(t, named(m, P())) for t in (q, k, v))
                got = flash_attention(qd, kd, vd, causal=True)
                flash[name] = {
                    "max_abs_err": float((_full_t(got) - want).abs().max()),
                    "placements": [str(p) for p in got.placements]}
        out["flash"] = flash
        b, S, di, ds = 4, 9, 6, 8
        xs = torch.randn(b, S, di, generator=g)
        dt = torch.rand(b, S, di, generator=g) * 0.1
        Bm = torch.randn(b, S, ds, generator=g)
        Cm = torch.randn(b, S, ds, generator=g)
        A = -torch.rand(di, ds, generator=g)
        wy, wh = selective_scan_ref(xs, dt, Bm, Cm, A)
        ins = [distribute(t, named(mesh22, P())) for t in (xs, dt, Bm, Cm, A)]
        gy, gh = mamba_scan(*ins)
        out["scan"] = {"y_err": float((_full_t(gy) - wy).abs().max()),
                       "h_err": float((_full_t(gh) - wh).abs().max()),
                       "placements": [[str(p) for p in t.placements]
                                      for t in (gy, gh)]}

    # --- whole prefills under the (2, 2) pod_serve mesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from repro_torch.sharding.partition import tree_shardings
    out["prefill"] = {}
    for case in args.get("prefill", ()):
        # "<arch>+sp": a dense block's residual stream sequence-sharded
        # over the model axis between its sublayers
        arch, sp = case.removesuffix("+sp"), case.endswith("+sp")
        r = dataclasses.replace(ps, seq="model") if sp else ps
        cfg = reduced(get_config(arch)).replace(compute_dtype="float32")
        model = Model(cfg, ExecConfig(attn_impl="pallas", seq_parallel=sp))
        params = model.init(torch.Generator().manual_seed(1))
        toks = torch.randint(0, cfg.vocab_size, (4, 16),
                             generator=torch.Generator().manual_seed(2))
        want, _ = model.prefill(params, {"tokens": toks}, max_len=32)
        dp = distribute_tree(params, tree_shardings(mesh22, params, r))
        with constraint_scope(mesh22, r):
            got, st = model.prefill(
                dp, {"tokens": distribute(toks, named(mesh22,
                                                      batch_spec(r)))},
                max_len=32)
        out["prefill"][case] = float((_full_t(got) - want).abs().max()
                                     / want.abs().max())
    return out


def zero_grad(rank, world, args):
    """One step of the sharded trainer on a reduced vlm model, whose
    `frontend_proj` the token batch never reaches: the gradient the step
    hands to AdamW for that leaf (zeros, as jax.grad gives) and the leaf's
    own placements."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)
    from repro_torch.train import trainer as trainer_mod

    mesh = make_host_mesh((world,), ("data",), device="cpu")
    cfg = reduced(get_config("llava-next-34b")).replace(
        compute_dtype="float32")
    seen = []
    update = trainer_mod.adamw_update

    def spy(params, grads, opt_state, cfg_):
        seen.append(grads["frontend_proj"]["w"])
        return update(params, grads, opt_state, cfg_)

    trainer_mod.adamw_update = spy
    try:
        tr = Trainer(Model(cfg),
                     TokenPipeline(cfg.vocab_size, 8, 16, seed=3,
                                   device="cpu"),
                     AdamWConfig(warmup_steps=1, total_steps=1),
                     TrainConfig(total_steps=1, ckpt_dir=os.path.join(
                         args["dir"], "zero_grad"), device="cpu"),
                     mesh=mesh, rules=ShardingRules(batch="data",
                                                    embed="data"))
        res = tr.run()
    finally:
        trainer_mod.adamw_update = update
    g = seen[0]
    w = tr.state["params"]["frontend_proj"]["w"]
    return {"final_step": res["final_step"],
            "grad_type": type(g).__name__,
            "grad_placements": [str(p) for p in g.placements],
            "param_placements": [str(p) for p in w.placements],
            "grad_local_shape": tuple(g.to_local().shape),
            "param_local_shape": tuple(w.to_local().shape),
            "grad_abs_max": float(_full_t(g).abs().max())}


def sharded(rank, world, args):
    """test_torch_sharded.py's world: the trainer on a (4,) data mesh, the
    engine on a (2, 2) (data, model) mesh of the same 4 ranks, and a vlm
    step's zero gradient on the (4,) mesh."""
    return {"trainer": trainer(rank, world, args["trainer"]),
            "engine": engine(rank, world, args["engine"]),
            "zero_grad": zero_grad(rank, world, args["zero_grad"])}
