"""What one device does in a step traced on fake tensors: the port's
counterpart of the JAX package's `launch/hlo_analysis.py`.

The reference compiles a step for a mesh and reads XLA's optimized HLO:
each collective with the bytes of its result, each while loop's trip
count, and XLA's cost and memory analyses. The port has no compiler
between the step and the device, so it runs the step itself on fake
tensors (`FakeTensorMode`: shapes, dtypes and devices, no storage) under
a fake process group, and `StepTrace`, a dispatch mode, watches every op
that one device runs:

  - collectives: each `c10d_functional` collective that DTensor issues
    (all-gather, reduce-scatter, all-reduce, all-to-all) and each
    point-to-point receive of the buddy ring (the reference's
    collective-permute), with the bytes of its result on one device, as
    the reference reads them off the HLO shapes (`collective_summary`);
  - FLOPs: each local op counted by `torch.utils.flop_counter`'s
    formulas at the shapes of one device's shards (F1 and S1 by their
    own formulas, `kernels/*/ops.py`). A DTensor op is counted by the
    local ops it runs: `FlopCounterMode` reads it at its global shape,
    the whole mesh's work;
  - bytes accessed: the bytes each local op that computes (not a view,
    not a collective) reads and writes: the traffic of eager execution,
    which fuses nothing;
  - memory: the fake storages of one device, as arguments (the step's
    inputs), outputs, aliases (outputs that are inputs' storage, the
    reference's donated buffers) and the peak of temporaries (live
    storages that are neither). A storage lives until the last tensor
    that holds it is freed; autograd's saved tensors keep theirs.

What has no counterpart: `while_report` and the trip-count correction.
The port's loops (layers, microbatches, chunks) are Python, so a trace
runs every trip and counts it once per trip; there is no loop body whose
count is to be multiplied. `compiled_cost_analysis` normalises XLA's
return type; here the counts are this module's own. `shape_bytes` parses
an HLO shape string; its counterpart is `tensor_bytes`.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: c10d op name -> the reference's HLO collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "recv_": "collective-permute",     # the buddy ring's receives
}
#: c10d ops that move no bytes of their own (a send is counted at its
#: receive, a wait completes a collective already counted)
_QUIET = {"wait_tensor", "send", "barrier"}

_META_OPS = {"size", "sym_size", "stride", "sym_stride", "numel",
             "sym_numel", "dim", "storage_offset", "sym_storage_offset",
             "is_contiguous", "sym_is_contiguous", "layout", "device",
             "is_strides_like_format", "is_non_overlapping_and_dense"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements (a DTensor's: its local shard's)."""
    t = _local(t)
    return t.numel() * t.element_size()


def _local(t):
    from repro_torch.device import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _storage_bytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


class StepTrace(TorchDispatchMode):
    """Watch one device's ops while a step runs on fake tensors.

        trace = StepTrace(args)       # the step's inputs (tensors, DTensors)
        with trace:
            out = step(*args)
        trace.finish(out)

    then `flops`, `bytes_accessed`, `collective_summary()` and
    `memory()`."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: list = []      # (kind, result bytes)
        self._args: Dict[int, int] = {}
        for t in _tensors(args):
            t = _local(t)
            self._args[_key(t)] = _storage_bytes(t)
        self._live: Dict[int, int] = {}  # storage -> its tensors alive
        self._events: list = []          # (+1 | -1, storage, bytes)
        self._bytes: Dict[int, int] = {}
        self._held: set = set()          # ids of the tensors tracked
        self._paused = 0
        self._depth = 0
        self._memory = None
        self._unpatch = None

    # ------------------------------------------------------ dispatch

    def __enter__(self):
        self._depth += 1
        if self._depth == 1:
            self._unpatch = _quiet_sharding_propagation(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._unpatch()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs it: its local ops come back through this mode
            return NotImplemented
        if self._paused or func._overloadpacket.__name__ in _META_OPS:
            return func(*args, **kwargs)
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            self._collective(packet.__name__, args, out)
        else:
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if not getattr(func, "is_view", False):
                self.bytes_accessed += sum(
                    tensor_bytes(t) for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out

    def _collective(self, name: str, args, out) -> None:
        if name in _QUIET:
            return
        if name == "recv_":
            nbytes = sum(tensor_bytes(t) for t in _tensors(args[0]))
        else:
            nbytes = sum(tensor_bytes(t) for t in _tensors(out))
        self.collectives.append((_KINDS.get(name, name), nbytes))

    # -------------------------------------------------------- memory

    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._held:
            return
        k = _key(t)
        if k in self._args:
            return
        self._held.add(id(t))
        if k not in self._live:
            self._live[k] = 0
            self._bytes[k] = _storage_bytes(t)
            self._events.append((1, k, self._bytes[k]))
        self._live[k] += 1
        weakref.finalize(t, self._release, k, id(t))

    def _release(self, k: int, i: int) -> None:
        self._held.discard(i)
        self._live[k] -= 1
        if self._live[k] == 0:
            del self._live[k]
            self._events.append((-1, k, self._bytes[k]))

    def finish(self, out) -> None:
        """Close the trace on the step's outputs `out`."""
        outs = {}
        for t in _tensors(out):
            t = _local(t)
            outs[_key(t)] = _storage_bytes(t)
        live = peak = 0
        for sign, k, nbytes in self._events:
            if k in outs:
                continue
            live += sign * nbytes
            peak = max(peak, live)
        self._memory = {
            "argument_bytes": sum(self._args.values()),
            "output_bytes": sum(outs.values()),
            "temp_bytes": peak,
            "alias_bytes": sum(n for k, n in outs.items() if k in self._args),
        }

    def memory(self) -> dict:
        """Bytes on one device: {argument, output, temp, alias}_bytes."""
        if self._memory is None:
            raise RuntimeError("StepTrace.finish(out) was not called")
        return dict(self._memory)

    def collective_summary(self) -> Dict[str, int]:
        """kind -> bytes of the results on one device (plus 'total')."""
        out: Dict[str, int] = defaultdict(int)
        for kind, nbytes in self.collectives:
            out[kind] += nbytes
        out["total"] = sum(out.values())
        return dict(out)


def _quiet_sharding_propagation(trace: StepTrace):
    """While DTensor works out placements, pause `trace` and lift the fake
    mode: DTensor derives an op's output shape by running it on fake
    tensors of the global shapes (work no device does), and computes the
    rows of a strided shard (a dim flattened from two split dims) and the
    cost of a redistribution with small index tensors whose values it
    reads. Returns the undo. The entry points differ between torch
    versions: each one present is wrapped (the propagator's cached entry
    holds its own reference to the uncached one)."""
    from torch.distributed.tensor import DTensor, placement_types
    prop = DTensor._op_dispatcher.sharding_propagator
    targets = [(prop, n) for n in ("propagate", "propagate_op_sharding",
                                   "propagate_op_sharding_non_cached",
                                   "_propagate_tensor_meta",
                                   "_propagate_tensor_meta_non_cached")
               if hasattr(prop, n)]
    if not targets:
        raise RuntimeError("DTensor's sharding propagator has no entry "
                           "point this trace knows")
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in vars(strided):
        targets.append((strided, "local_shard_size_and_offset"))
    own = [(obj, n, vars(obj).get(n), getattr(obj, n)) for obj, n in targets]
    for obj, n, _, fn in own:
        setattr(obj, n, _quiet(trace, fn))
    # DTensor takes any active fake mode for a compiler's trace with
    # symbolic shapes and then caches no placement and no redistribution
    # plan (tenfold the time of a train step here); the shapes here are
    # plain ints, so its caches hold
    import importlib
    tracing = []
    for mod in ("_dispatch", "_sharding_prop", "_redistribute"):
        m = importlib.import_module(f"torch.distributed.tensor.{mod}")
        if hasattr(m, "_are_we_tracing"):
            tracing.append((m, m._are_we_tracing))
            m._are_we_tracing = _not_tracing

    def undo():
        for obj, n, fn, _ in own:
            if fn is None:
                delattr(obj, n)
            else:
                setattr(obj, n, fn)
        for m, fn in tracing:
            m._are_we_tracing = fn
    return undo


def _not_tracing() -> bool:
    from torch.compiler import is_compiling
    return is_compiling()


def _quiet(trace: StepTrace, fn):
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def run(*args, **kwargs):
        trace._paused += 1
        try:
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            trace._paused -= 1
    return run
