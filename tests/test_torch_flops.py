"""The port's FLOP accounting against the JAX package: `models/flops.py`
(a stdlib copy, so equal on every cell), `Model.abstract_params` and
`Model.input_specs` (the same leaves, shapes and dtypes as the
reference's, as fake tensors), the count `torch.utils.flop_counter` reads
off the port's loss on the reduced configs of
`tests/test_roofline_model.py` (within the reference's 0.7–1.1 band of
`forward_flops`), and F1's and S1's torch operators: the fake outputs'
shapes and dtypes, the flop formulas against `flops.py`, and on CPU
tensors the plain versions' outputs bit for bit.

Tolerances: none but the band; every other comparison is exact.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import flops as ref_flops
from repro.models.model import Model as RefModel
from repro.models.transformer import ExecConfig as RefExecConfig

from repro_torch.configs import ASSIGNED, SHAPES, get_config, reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.models import flops
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import ExecConfig

from _torch_threads import few_threads  # noqa: F401  (autouse)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _sig(leaf) -> tuple:
    """(shape, dtype name) of a JAX ShapeDtypeStruct or a torch tensor."""
    dt = leaf.dtype
    name = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name
    return tuple(leaf.shape), name


def test_assigned_archs_match_reference():
    assert ASSIGNED == REF_ASSIGNED


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_flops_equal_reference(arch, shape, flash):
    """cell_cost, forward_flops, decode_flops and kv_cache_bytes: the
    reference's numbers on every assigned arch × shape × flash."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    sh = SHAPES[shape]
    B, S = sh.global_batch, sh.seq_len
    got = flops.cell_cost(cfg, sh, flash=flash)
    want = ref_flops.cell_cost(ref_cfg, sh, flash=flash)
    assert (got.flops, got.hbm_bytes, got.details) == \
        (want.flops, want.hbm_bytes, want.details)
    assert flops.forward_flops(cfg, B, S, flash=flash) == \
        ref_flops.forward_flops(ref_cfg, B, S, flash=flash)
    assert flops.decode_flops(cfg, B, S, flash=flash) == \
        ref_flops.decode_flops(ref_cfg, B, S, flash=flash)
    assert flops.kv_cache_bytes(cfg, B, S) == \
        ref_flops.kv_cache_bytes(ref_cfg, B, S)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_abstract_params_match_reference(arch):
    """Leaf for leaf, the reference's parameter shapes and dtypes, as
    fake tensors on the device named (no storage)."""
    got = Model(get_config(arch)).abstract_params(device="cpu")
    want = RefModel(ref_get_config(arch)).abstract_params()
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    assert {k: _sig(v) for k, v in g.items()} == \
        {k: _sig(v) for k, v in w.items()}
    assert all(isinstance(v, FakeTensor) and v.device.type == "cpu"
               for v in g.values())


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_match_reference(arch, shape):
    """The step's inputs of every cell (the decode state included), leaf
    for leaf, as fake tensors; `abstract=False` gives the same as zeros."""
    sh = SHAPES[shape]
    model = Model(get_config(arch))
    got = _flat(model.input_specs(sh, device="cpu"))
    want = _flat(RefModel(ref_get_config(arch)).input_specs(sh))
    assert sorted(got) == sorted(want)
    assert {k: _sig(v) for k, v in got.items()} == \
        {k: _sig(v) for k, v in want.items()}
    assert all(isinstance(v, FakeTensor) for v in got.values())
    # zeros of the same leaves, at a reduced size
    small = Model(reduced(get_config(arch)))
    tiny = ShapeConfig(shape, 8, 2, sh.kind)
    real = _flat(small.input_specs(tiny, abstract=False, device="cpu"))
    fake = _flat(small.input_specs(tiny, device="cpu"))
    assert {k: _sig(v) for k, v in real.items()} == \
        {k: _sig(v) for k, v in fake.items()}
    assert not any(isinstance(v, FakeTensor) for v in real.values())
    assert all(not v.any() for v in real.values())


def _roofline_cfg(get, red, arch):
    """tests/test_roofline_model.py's reduced config of `arch`."""
    return red(get(arch)).replace(
        d_model=128, d_ff=256, n_layers=2, vocab_size=512, n_heads=4,
        n_kv_heads=2 if arch != "olmoe-1b-7b" else 4, head_dim=32)


def _xla_ratio(arch) -> float:
    """The reference's ratio, forward_flops over XLA's cost analysis."""
    from repro.launch.hlo_analysis import compiled_cost_analysis
    cfg = _roofline_cfg(ref_get_config, ref_reduced, arch)
    model = RefModel(cfg, RefExecConfig(scan_layers=False,
                                        remat_policy="none", xent_chunks=1,
                                        attn_impl="naive"))
    batch = {k: jax.ShapeDtypeStruct((2, 128), jnp.int32)
             for k in ("tokens", "labels")}
    comp = jax.jit(lambda p, b: model.loss_fn(p, b)[0]).lower(
        model.abstract_params(), batch).compile()
    return ref_flops.forward_flops(cfg, 2, 128, flash=False) / \
        compiled_cost_analysis(comp)["flops"]


@pytest.mark.parametrize("arch", ["qwen2-7b", "olmoe-1b-7b",
                                  "falcon-mamba-7b"])
def test_analytic_flops_vs_flop_counter(arch):
    """forward_flops over FlopCounterMode's count of the port's loss on
    the reference's reduced config: within the reference's 0.7–1.1 band
    (the analytic model counts matmuls only)."""
    cfg = _roofline_cfg(get_config, reduced, arch)
    model = Model(cfg, ExecConfig(remat_policy="none", xent_chunks=1,
                                  attn_impl="naive"))
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.loss_fn(params, batch)
    ratio = flops.forward_flops(cfg, 2, 128, flash=False) / \
        fc.get_total_flops()
    assert 0.7 < ratio < 1.1, \
        f"port {ratio} (the reference's XLA ratio: {_xla_ratio(arch)})"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(2, 8, 8, 4, 2, 16), (1, 6, 10, 4, 4, 16)])
def test_flash_op_fake_and_flops(dims, causal):
    """F1's operator: a fake input gets the output's shape and dtype, the
    flop counter charges the core of `flops.attn_flops` with flash (a
    config with d_model 0 has no projections), and a CPU tensor gets the
    plain version bit for bit."""
    B, Sq, Sk, H, Hkv, hd = dims
    g = torch.Generator().manual_seed(2)
    q = torch.randn(B, Sq, H, hd, generator=g)
    k, v = (torch.randn(B, Sk, Hkv, hd, generator=g) for _ in range(2))
    with FlopCounterMode(display=False) as fc:
        out = fa_ops.flash_attention(q, k, v, causal=causal)
    cfg = get_config("qwen2-7b").replace(d_model=0, n_heads=H,
                                         n_kv_heads=Hkv, head_dim=hd)
    assert fc.get_total_flops() == flops.attn_flops(
        cfg, B, Sq, Sk, causal=causal, flash=True)
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=causal))
    with FakeTensorMode():
        f = fa_ops.flash_attention(*(torch.empty(t.shape, dtype=torch.bfloat16)
                                     for t in (q, k, v)), causal=causal)
    assert isinstance(f, FakeTensor)
    assert (tuple(f.shape), f.dtype) == ((B, Sq, H, hd), torch.bfloat16)


def test_scan_op_fake_and_flops():
    """S1's operator: fake outputs y (b, S, di) in x's dtype and h (b, di,
    ds) float32; the counter charges 8·b·S·di·ds, the scan term of
    `flops.mamba_flops` (its other terms do not depend on the scan); a
    CPU tensor gets the plain version bit for bit."""
    b, S, di, ds = 2, 7, 12, 8
    g = torch.Generator().manual_seed(3)
    x = torch.randn(b, S, di, generator=g)
    dt = torch.rand(b, S, di, generator=g)
    Bm, Cm = (torch.randn(b, S, ds, generator=g) for _ in range(2))
    A = -torch.rand(di, ds, generator=g)
    with FlopCounterMode(display=False) as fc:
        y, h = scan_ops.mamba_scan(x, dt, Bm, Cm, A)
    cfg = get_config("falcon-mamba-7b")
    wide = cfg.replace(ssm_state=2 * cfg.ssm_state)
    # 8·B·S·di·ds is the only term of mamba_flops that grows with ds
    # beyond the x_proj's 4·B·S·di·ds
    grow = flops.mamba_flops(wide, 1, 1) - flops.mamba_flops(cfg, 1, 1)
    assert grow == (8 + 4) * cfg.d_inner * cfg.ssm_state
    assert fc.get_total_flops() == 8 * b * S * di * ds
    yr, hr = selective_scan_ref(x, dt, Bm, Cm, A)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    with FakeTensorMode():
        fy, fh = scan_ops.mamba_scan(*(torch.empty(t.shape)
                                       for t in (x, dt, Bm, Cm, A)))
    assert (tuple(fy.shape), fy.dtype) == ((b, S, di), torch.float32)
    assert (tuple(fh.shape), fh.dtype) == ((b, di, ds), torch.float32)


@pytest.mark.parametrize("which", ["flash", "scan"])
def test_ops_route_by_device(which):
    """The operators' routing raises for a device without a kernel (meta
    here); a meta tensor given to the operator itself gets the fake
    implementation, which torch registers as the operator's meta kernel."""
    if which == "flash":
        t = torch.empty(1, 4, 2, 16, device="meta")
        args, route = (t, t, t, True), fa_ops._route
        call = lambda: fa_ops.flash_attention(t, t, t)
    else:
        x = torch.empty(1, 4, 8, device="meta")
        Bm = torch.empty(1, 4, 8, device="meta")
        args = (x, x, Bm, Bm, torch.empty(8, 8, device="meta"))
        route, call = scan_ops._route, lambda: scan_ops.mamba_scan(*args)
    with pytest.raises(RuntimeError, match="kernel for device meta"):
        route(*args)
    out = call()
    assert all(t.device.type == "meta" for t in
               (out if isinstance(out, tuple) else (out,)))


def test_flops_copy_is_stdlib_only():
    """models/flops.py imports nothing but the standard library and the
    port's config."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(flops))
    mods = {n.module if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(tree) if isinstance(n, (ast.Import,
                                                       ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [None])}
    assert mods <= {"__future__", "dataclasses", "repro_torch.models.config"}
