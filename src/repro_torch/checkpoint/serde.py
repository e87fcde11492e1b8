"""Zero-copy framed binary serialization for checkpoint payloads.

Replaces np.savez (zip framing, per-entry CRC, mandatory copies) on the
file path and the ad-hoc `step || raw bytes` payloads on the buddy/TCP
path with one self-describing frame:

    offset 0      magic       8 bytes   b"RPROCKP1"
    offset 8      header_len  u32 LE    byte length of the JSON header
    offset 12     reserved    u32 LE    0 (format flags, future use)
    offset 16     header      UTF-8 JSON, header_len bytes
    ...           zero pad to the next 64-byte boundary
    data          raw little-endian C-contiguous leaf bytes, each leaf
                  starting on a 64-byte boundary, in header order

    header JSON: {"version": 1,
                  "extra":  {...user metadata...},
                  "leaves": [{"path", "dtype", "shape",
                              "offset", "nbytes"}, ...]}

Design points:

  - *Writes are gather-free*: `write_file` streams each leaf's uint8 view
    straight into the file and `to_bytes` fills one preallocated buffer
    through memoryviews — no per-leaf `tobytes()`, no zip deflate/CRC.
  - *Reads are zero-copy*: `from_bytes`/`open_file` return ndarray views
    into the source buffer; `open_file(mmap=True)` backs them with
    np.memmap so `load_latest` maps shards instead of reading them, and
    pages fault in lazily as verification/restore touches them.
  - 64-byte alignment keeps every leaf cache-line- and SIMD-aligned and
    lets a future device DMA consume the mapping directly.
  - dtype names are numpy's names (torch tensors included, so frames
    and manifests match the JAX package byte for byte). numpy has no
    bfloat16: a bfloat16 leaf is held on the host as a CPU tensor, and a
    frame's bfloat16 leaf is read back as one.

Integrity is *not* this layer's job — digests live in manifest.json
(file path) or the control message (buddy path), so corruption checks
can run per-shard in parallel against the mapped views.

Delta frames
------------

A *delta frame* records only the byte ranges of a state that changed
since a parent frame, at 4 KB tile granularity (the tile of
`kernels.checksum` — dirtiness is decided by comparing per-tile
(s0, s1, mix) digest rows, which on accelerators are computed on device
so only 12 bytes per tile ever cross to the host):

    offset 0      magic       8 bytes   b"RPROCKD1"
    offset 8      header_len  u32 LE    byte length of the JSON header
    offset 12     reserved    u32 LE    0 (format flags, future use)
    offset 16     header      UTF-8 JSON, header_len bytes
    ...           zero pad to the next 64-byte boundary
    data          dirty-range bytes, every range starting on a 64-byte
                  boundary, in header order

    header JSON: {"version": 1,
                  "kind":   "delta",
                  "base":   {"step": <int>},   # parent frame of the chain
                  "extra":  {...user metadata...},
                  "leaves": [{"path", "dtype", "shape", "full",
                              "ranges": [[leaf_off, nbytes, frame_off],
                                         ...]}, ...]}

Semantics:

  - `base.step` names the immediate parent (deltas chain; a restore
    walks down to the nearest full frame and re-applies upward).
  - A leaf with `full: true` carries its complete byte stream (new leaf,
    or shape/dtype changed) as a single range.
  - Leaves whose tiles all match the parent are omitted entirely — a
    clean snapshot's delta is just the header.
  - `ranges` entries are [offset-in-leaf-bytes, length, offset-in-frame];
    dirty tiles are merged into maximal runs and the final range is
    clipped to the leaf's byte length (partial trailing tile).
  - Composition (`apply_delta`/`compose`) is bit-exact: base + deltas
    reproduces the full snapshot byte-for-byte, enforced downstream by
    manifest digests over the composed state.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.checksum.ops import byte_stream, tile_checksums
from repro_torch.kernels.checksum.ref import TILE_BYTES, byte_view

MAGIC = b"RPROCKP1"
DELTA_MAGIC = b"RPROCKD1"
ALIGN = 64
_FIXED = struct.Struct("<8sII")      # magic, header_len, reserved
VERSION = 1


def dtype_name(v) -> str:
    """numpy's name for a leaf's dtype: `float32`, `bfloat16`, `bool`...
    (`str(torch.float32)` is `torch.float32`, which would change every
    frame header and digest string)."""
    dt = getattr(v, "dtype", None)
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(dt if dt is not None else np.asarray(v).dtype)


def _leaf(raw: np.ndarray, name: str, shape) -> Any:
    """A host leaf of dtype `name` over the uint8 array `raw`: a numpy
    view, or for bfloat16 a CPU tensor (copied, since a mapped frame is
    read-only)."""
    if name == "bfloat16":
        return torch.from_numpy(np.array(raw)).view(torch.bfloat16) \
            .reshape(shape)
    return raw.view(np.dtype(name)).reshape(shape)


def _leaf_bytes(arr) -> np.ndarray:
    """Flat uint8 view of a host leaf (copies only if non-contiguous)."""
    if isinstance(arr, torch.Tensor):
        return byte_stream(arr.cpu()).numpy()
    return byte_view(np.asarray(arr))


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _layout(flat: Dict[str, Any], extra: dict | None
            ) -> Tuple[bytes, list, int]:
    """Returns (prefix_bytes, [(path, uint8_view, offset)], frame_size).

    prefix = fixed header + JSON + pad; offsets are absolute in-frame.
    """
    views = {k: _leaf_bytes(v) for k, v in flat.items()}
    entries = [{"path": k,
                "dtype": dtype_name(flat[k]),
                "shape": list(np.shape(flat[k])),
                "offset": 0, "nbytes": int(views[k].size)}
               for k in flat]
    # Offsets depend on the header's byte length, which depends on the
    # offsets' digit counts — iterate to a fixpoint. Offsets (and hence
    # the header length) only ever grow, so this converges in a couple
    # of rounds; the loop exits with `header` serialized from exactly
    # the offsets the data will be written at.
    while True:
        header = json.dumps({"version": VERSION, "extra": extra or {},
                             "leaves": entries},
                            separators=(",", ":")).encode()
        off = _align(_FIXED.size + len(header))
        changed = False
        for e in entries:
            if e["offset"] != off:
                e["offset"] = off
                changed = True
            off += _align(e["nbytes"])
        if not changed:
            break
    data_start = _align(_FIXED.size + len(header))
    prefix = _FIXED.pack(MAGIC, len(header), 0) + header
    prefix += b"\0" * (data_start - len(prefix))
    placed = [(e["path"], views[e["path"]], e["offset"]) for e in entries]
    return prefix, placed, off


def frame_size(flat: Dict[str, Any], extra: dict | None = None) -> int:
    return _layout(flat, extra)[2]


def to_bytes(flat: Dict[str, Any], extra: dict | None = None) -> bytes:
    """Serialize {path: array} into one frame (single preallocated buffer,
    leaves copied in via memoryview — no intermediate tobytes)."""
    prefix, placed, size = _layout(flat, extra)
    buf = bytearray(size)
    buf[:len(prefix)] = prefix
    mv = memoryview(buf)
    for _, view, off in placed:
        mv[off:off + view.size] = memoryview(view)
    return bytes(buf)


def write_file(path: str, flat: Dict[str, Any],
               extra: dict | None = None) -> int:
    """Stream a frame to `path`; returns bytes written. Leaf bytes go
    straight from the array's buffer to the file."""
    prefix, placed, size = _layout(flat, extra)
    with open(path, "wb") as f:
        f.write(prefix)
        pos = len(prefix)
        for _, view, off in placed:
            if off > pos:
                f.write(b"\0" * (off - pos))
            f.write(memoryview(view))
            pos = off + view.size
        if size > pos:
            f.write(b"\0" * (size - pos))
    return size


def _parse(buf) -> Tuple[dict, Dict[str, np.ndarray]]:
    """buf: bytes / bytearray / memmap. Returns (extra, {path: view})."""
    head = bytes(buf[:_FIXED.size])
    if len(head) < _FIXED.size:
        raise IOError("serde frame truncated (no fixed header)")
    magic, hlen, _ = _FIXED.unpack(head)
    if magic != MAGIC:
        raise IOError(f"bad serde magic {magic!r}")
    try:
        header = json.loads(bytes(buf[_FIXED.size:_FIXED.size + hlen]))
    except ValueError as e:
        raise IOError(f"serde header corrupt: {e}") from None
    is_arr = isinstance(buf, np.ndarray)
    mv = buf if is_arr else memoryview(buf)      # slices stay zero-copy
    flat: Dict[str, np.ndarray] = {}
    for e in header["leaves"]:
        off, n = e["offset"], e["nbytes"]
        raw = mv[off:off + n]
        if len(raw) != n:
            raise IOError(f"serde frame truncated at leaf {e['path']}")
        if not is_arr:                           # memmap slice: stay mapped
            raw = np.frombuffer(raw, dtype=np.uint8)
        flat[e["path"]] = _leaf(raw, e["dtype"], e["shape"])
    return header.get("extra", {}), flat


def from_bytes(buf: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Parse a frame into (extra, {path: ndarray view}). Views are
    read-only windows onto `buf` — np.array(view) to get writable."""
    return _parse(buf)


def open_file(path: str, *, mmap: bool = True
              ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Map (default) or read a frame file. With mmap, leaves are memmap
    views — the OS pages them in on first touch, so restore cost is paid
    only for the bytes actually consumed."""
    if mmap:
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        return _parse(mm)
    with open(path, "rb") as f:
        return _parse(f.read())


# --------------------------------------------------------------- deltas

def peek_kind(buf) -> str:
    """'full' | 'delta' for a serde frame, 'raw' for anything else."""
    head = bytes(buf[:8])
    if head == MAGIC:
        return "full"
    if head == DELTA_MAGIC:
        return "delta"
    return "raw"


class LeafTiles(NamedTuple):
    """Per-leaf tile digests plus the identity (byte length, dtype,
    shape) they were taken over — a leaf reshaped or reinterpreted to
    the same bytes must never be mistaken for a patchable one."""
    nbytes: int
    dtype: str
    shape: tuple
    rows: np.ndarray        # (n_tiles, 3) uint32


def _leaf_tiles(v, rows=None) -> LeafTiles:
    meta = v if hasattr(v, "nbytes") else np.asarray(v)
    return LeafTiles(int(meta.nbytes), dtype_name(meta),
                     tuple(np.shape(v)),
                     tile_checksums(v) if rows is None else rows)


def tile_digests(flat: Dict[str, Any]) -> Dict[str, LeafTiles]:
    """Per-leaf LeafTiles — device arrays are digested on device, host
    arrays by the vectorized numpy reference."""
    return {k: _leaf_tiles(v) for k, v in flat.items()}


class DeltaPlan:
    """Outcome of diffing a snapshot against its parent's tile digests.

    entries: {path: None (full leaf) | [(leaf_off, nbytes), ...]}; clean
    leaves are absent. `feasible` is False when the leaf *set* changed in
    a way a delta cannot express (a leaf disappeared)."""

    def __init__(self, entries, new_tiles, dirty_bytes, total_bytes,
                 feasible):
        self.entries = entries
        self.new_tiles = new_tiles
        self.dirty_bytes = dirty_bytes
        self.total_bytes = total_bytes
        self.feasible = feasible

    @property
    def dirty_fraction(self) -> float:
        if not self.feasible:
            return 1.0
        return self.dirty_bytes / self.total_bytes if self.total_bytes \
            else 0.0


def delta_plan(flat: Dict[str, Any],
               prev_tiles: Dict[str, LeafTiles],
               new_tiles: Dict[str, LeafTiles] | None = None) -> DeltaPlan:
    """Diff `flat` against the parent snapshot's per-tile digests
    ({path: LeafTiles} as produced by `tile_digests`).

    `new_tiles` short-circuits digesting when the caller already computed
    (or enqueued on device) this snapshot's tiles."""
    if new_tiles is None:
        new_tiles = tile_digests(flat)
    entries: Dict[str, Any] = {}
    dirty = total = 0
    for k, v in flat.items():
        cur = new_tiles[k]
        nbytes = int(cur.nbytes)
        nt = np.asarray(cur.rows)
        total += nbytes
        prev = prev_tiles.get(k)
        if (prev is None or prev[:3] != cur[:3]    # nbytes/dtype/shape
                or np.asarray(prev.rows).shape != nt.shape):
            entries[k] = None    # new / reshaped / recast: full leaf
            dirty += nbytes
            continue
        changed = np.any(np.asarray(prev.rows) != nt, axis=1)
        if not changed.any():
            continue                               # clean leaf: omitted
        idx = np.flatnonzero(changed)
        # merge consecutive dirty tiles into maximal runs
        splits = np.flatnonzero(np.diff(idx) > 1) + 1
        ranges = []
        for run in np.split(idx, splits):
            off = int(run[0]) * TILE_BYTES
            end = min((int(run[-1]) + 1) * TILE_BYTES, nbytes)
            ranges.append((off, end - off))
            dirty += end - off
        entries[k] = ranges
    feasible = all(k in flat for k in prev_tiles)
    return DeltaPlan(entries, new_tiles, dirty, total, feasible)


class ChainPlanner:
    """The base/delta cadence policy, shared by every delta producer
    (FileCheckpointer shards, worker buddy pushes): a full frame every
    `base_every`-th snapshot, tile-range deltas between, degrading to a
    full frame when the dirty fraction exceeds `max_dirty`, the leaf set
    changed, or the chain would not anchor (non-monotonic step; with
    `contiguous`, a parent other than step-1 — the BuddyStore retention
    walk assumes step-1 chains).

    `decide` is pure; call `commit` only after the frame is durably
    written so a failed write never corrupts the chain state."""

    def __init__(self, base_every: int, max_dirty: float = 0.5, *,
                 contiguous: bool = False):
        self.base_every = base_every
        self.max_dirty = max_dirty
        self.contiguous = contiguous
        self.prev: tuple | None = None        # (step, tiles)
        self.since_base = 0

    def predict_full(self, step: int) -> bool:
        """True when `decide(step)` cannot return "delta" regardless of
        how dirty the snapshot turns out to be (cadence says base, no
        parent, non-anchoring step). The async gather path uses this at
        submit time: only when the full bytes will certainly be needed
        does it kick the whole-state D2H drain early."""
        prev = self.prev
        return (self.base_every <= 1 or prev is None or prev[0] >= step
                or self.since_base >= self.base_every - 1
                or (self.contiguous and prev[0] != step - 1))

    def decide(self, flat: Dict[str, Any], step: int,
               new_tiles: Dict[str, tuple] | None = None):
        """-> (kind, plan-or-None, tiles, base_step-or-None)."""
        if new_tiles is None:
            new_tiles = tile_digests(flat)
        if self.predict_full(step):
            return "full", None, new_tiles, None
        plan = delta_plan(flat, self.prev[1], new_tiles)
        if not plan.feasible or plan.dirty_fraction > self.max_dirty:
            return "full", None, new_tiles, None
        return "delta", plan, new_tiles, self.prev[0]

    def commit(self, step: int, tiles: Dict[str, tuple], kind: str):
        self.prev = (step, tiles)
        self.since_base = self.since_base + 1 if kind == "delta" else 0


class GatherLeaf(NamedTuple):
    """One leaf of a *gathered* delta: its identity plus the dirty byte
    runs, each run carrying its own uint8 view of the bytes to emit.

    This is the representation every delta frame is built from. The
    views may point anywhere byte-identical to the leaf's dirty ranges:
    slices of the full host array (`gather_host`, the CPU path), or
    slices of a compact device-gathered tile buffer that is the *only*
    bulk payload ever copied D2H (FileCheckpointer's gather path) — the
    frame writer cannot tell the difference and the frame bytes are
    identical either way (tested)."""
    dtype: str
    shape: tuple
    full: bool
    runs: list              # [(leaf_off, nbytes, uint8_view)]


def range_tiles(ranges) -> np.ndarray:
    """Ascending tile indices covered by a plan entry's byte ranges
    (each range is a maximal run of dirty 4 KB tiles, possibly clipped
    at the leaf's end) — the index the device gather kernel consumes."""
    idx = []
    for off, n in ranges:
        t0 = off // TILE_BYTES
        idx.extend(range(t0, t0 + (-(-(n) // TILE_BYTES))))
    return np.asarray(idx, np.int32)


def gather_host(flat: Dict[str, Any], plan: DeltaPlan
                ) -> Dict[str, GatherLeaf]:
    """Gathered representation of `plan` over host-resident leaves: the
    run views are zero-copy slices of the arrays themselves. The worker's
    buddy PUSH_CKPT frames and the CPU-backend file path both ride
    this."""
    out: Dict[str, GatherLeaf] = {}
    for k in flat:
        if k not in plan.entries:
            continue
        v = flat[k]
        bv = _leaf_bytes(v)
        dt = dtype_name(v)
        rng = plan.entries[k]
        if rng is None:
            out[k] = GatherLeaf(dt, tuple(np.shape(v)), True,
                                [(0, int(bv.size), bv)])
        else:
            out[k] = GatherLeaf(dt, tuple(np.shape(v)), False,
                                [(o, n, bv[o:o + n]) for o, n in rng])
    return out


def _delta_layout_gathered(gathered: Dict[str, GatherLeaf],
                           base_step: int, extra: dict | None):
    """(prefix, [(uint8_view, frame_off)], frame_size) for a gathered
    delta. Each placed view is exactly one run's bytes."""
    entries = []
    for k, g in gathered.items():
        entries.append({"path": k, "dtype": g.dtype,
                        "shape": list(g.shape), "full": g.full,
                        "ranges": [[o, n, 0] for o, n, _ in g.runs]})
    while True:     # same offset/header fixpoint as _layout
        header = json.dumps({"version": VERSION, "kind": "delta",
                             "base": {"step": int(base_step)},
                             "extra": extra or {}, "leaves": entries},
                            separators=(",", ":")).encode()
        off = _align(_FIXED.size + len(header))
        changed = False
        for e in entries:
            for r in e["ranges"]:
                if r[2] != off:
                    r[2] = off
                    changed = True
                off += _align(r[1])
        if not changed:
            break
    data_start = _align(_FIXED.size + len(header))
    prefix = _FIXED.pack(DELTA_MAGIC, len(header), 0) + header
    prefix += b"\0" * (data_start - len(prefix))
    placed = [(run[2], r[2])
              for e, (_, g) in zip(entries, gathered.items())
              for run, r in zip(g.runs, e["ranges"])]
    return prefix, placed, off


def to_delta_bytes_gathered(gathered: Dict[str, GatherLeaf], *,
                            base_step: int,
                            extra: dict | None = None) -> bytes:
    prefix, placed, size = _delta_layout_gathered(gathered, base_step,
                                                  extra)
    buf = bytearray(size)
    buf[:len(prefix)] = prefix
    mv = memoryview(buf)
    for view, frame_off in placed:
        mv[frame_off:frame_off + view.size] = memoryview(view)
    return bytes(buf)


def write_delta_file_gathered(path: str, gathered: Dict[str, GatherLeaf],
                              *, base_step: int,
                              extra: dict | None = None) -> int:
    prefix, placed, size = _delta_layout_gathered(gathered, base_step,
                                                  extra)
    with open(path, "wb") as f:
        f.write(prefix)
        pos = len(prefix)
        for view, frame_off in placed:
            if frame_off > pos:
                f.write(b"\0" * (frame_off - pos))
            f.write(memoryview(view))
            pos = frame_off + view.size
        if size > pos:
            f.write(b"\0" * (size - pos))
    return size


def to_delta_bytes(flat: Dict[str, Any], plan: DeltaPlan, *,
                   base_step: int, extra: dict | None = None) -> bytes:
    """Delta frame from full host leaves — gathers (zero-copy slices)
    then serializes; kept as the convenience entry point."""
    return to_delta_bytes_gathered(gather_host(flat, plan),
                                   base_step=base_step, extra=extra)


def write_delta_file(path: str, flat: Dict[str, Any], plan: DeltaPlan, *,
                     base_step: int, extra: dict | None = None) -> int:
    return write_delta_file_gathered(path, gather_host(flat, plan),
                                     base_step=base_step, extra=extra)


class FramePublisher:
    """One-call publish side of a delta stream: decide base-vs-delta via
    a ChainPlanner, gather only the dirty byte runs, encode the frame,
    and advance the chain. The subscribe side is `composable_steps` +
    `compose`, unchanged.

    Shared by every in-memory delta producer — the runtime worker's
    buddy pushes and the serve replicator's state stream — so the frame
    format and cadence policy cannot drift between them. `last_kind`
    reports what the most recent publish emitted ("full"/"delta"),
    which is what O(dirt) tests and replication telemetry key on."""

    def __init__(self, base_every: int, max_dirty: float = 0.5, *,
                 contiguous: bool = False):
        self.chain = ChainPlanner(base_every, max_dirty,
                                  contiguous=contiguous)
        self.last_kind: str | None = None

    def publish(self, flat: Dict[str, Any], step: int,
                extra: dict | None = None) -> bytes:
        """Frame bytes for `flat` at `step` — a tile-range delta against
        the previous frame when the chain allows it and the state is
        sparse-dirty, a full frame otherwise. The chain is committed
        before returning; in-memory pushes have no partial-write failure
        mode (a crashed push loses the whole frame and the next decide
        sees a non-anchoring parent, degrading to a full frame)."""
        ex = dict(extra or {})
        ex.setdefault("step", step)
        with tracing.span("replicate.digest"):
            tiles = tile_digests(flat)
            tracing.count("replicate.bytes_digested",
                          sum(t.nbytes for t in tiles.values()))
        with tracing.span("replicate.plan"):
            kind, plan, tiles, base = self.chain.decide(flat, step, tiles)
        with tracing.span("replicate.encode", kind=kind):
            if kind == "delta":
                # gathered representation: the frame is assembled from
                # zero-copy slices of the dirty ranges only — same bytes
                # as the full-drain path, without re-touching clean pages
                payload = to_delta_bytes_gathered(gather_host(flat, plan),
                                                  base_step=base, extra=ex)
            else:
                payload = to_bytes(flat, extra=ex)
            tracing.count("replicate.bytes_framed", len(payload))
        self.chain.commit(step, tiles, kind)
        self.last_kind = kind
        return payload

    def rebase(self):
        """Restart the chain: the next publish emits a full frame. Call
        when the consumer of the stream lost its history — e.g. the
        buddy holding the held frames died and respawned empty — so a
        delta against a frame nobody holds is never emitted."""
        self.chain.prev = None
        self.chain.since_base = 0


def _parse_delta(buf) -> Tuple[dict, Any]:
    head = bytes(buf[:_FIXED.size])
    if len(head) < _FIXED.size:
        raise IOError("delta frame truncated (no fixed header)")
    magic, hlen, _ = _FIXED.unpack(head)
    if magic != DELTA_MAGIC:
        raise IOError(f"bad delta magic {magic!r}")
    try:
        header = json.loads(bytes(buf[_FIXED.size:_FIXED.size + hlen]))
    except ValueError as e:
        raise IOError(f"delta header corrupt: {e}") from None
    mv = buf if isinstance(buf, np.ndarray) else memoryview(buf)
    return header, mv


def delta_base_step(buf) -> int:
    header, _ = _parse_delta(buf)
    return int(header["base"]["step"])


def apply_delta(flat: Dict[str, np.ndarray], buf,
                writable: set | None = None
                ) -> Tuple[dict, int, Dict[str, np.ndarray]]:
    """Patch one delta frame onto `flat` (a parsed parent snapshot).

    Returns (extra, base_step, new_flat). Untouched leaves pass through
    as-is (memmap views stay mapped); `full` leaves become views into
    `buf`; range-patched leaves are materialized copies. Bit-exact.

    `writable` (chain-compose optimization) names leaves the caller
    already owns as writable copies: those are patched in place instead
    of re-copied, so a K-link chain materializes each dirty leaf once,
    not K times. Paths this call materializes are added to the set."""
    header, mv = _parse_delta(buf)
    is_arr = isinstance(buf, np.ndarray)
    out = dict(flat)
    for e in header["leaves"]:
        if e["full"]:
            [[_, n, off]] = e["ranges"]
            raw = mv[off:off + n]
            if len(raw) != n:
                raise IOError(f"delta truncated at leaf {e['path']}")
            if not is_arr:
                raw = np.frombuffer(raw, dtype=np.uint8)
            out[e["path"]] = _leaf(raw, e["dtype"], e["shape"])
            if writable is not None:
                writable.discard(e["path"])    # back to a read-only view
            continue
        cur = out.get(e["path"])
        if cur is None:
            raise IOError(f"delta patches unknown leaf {e['path']}")
        if dtype_name(cur) != e["dtype"]:
            raise IOError(f"delta dtype mismatch at leaf {e['path']}: "
                          f"{dtype_name(cur)} vs {e['dtype']}")
        if writable is None or e["path"] not in writable:
            # writable materialized
            cur = cur.clone() if isinstance(cur, torch.Tensor) \
                else np.array(cur)
            if writable is not None:
                writable.add(e["path"])
        bv = _leaf_bytes(cur)                  # a view: patches land in cur
        for leaf_off, n, frame_off in e["ranges"]:
            raw = mv[frame_off:frame_off + n]
            if len(raw) != n:
                raise IOError(f"delta truncated at leaf {e['path']}")
            bv[leaf_off:leaf_off + n] = np.frombuffer(raw, np.uint8) \
                if not is_arr else raw
        out[e["path"]] = cur.reshape(e["shape"])
    return header.get("extra", {}), int(header["base"]["step"]), out


def chain_steps(frames: Dict[int, Any], step: int) -> list:
    """Frame steps [base, ..., step] needed to compose `step`; raises
    KeyError when the chain is broken."""
    chain = [step]
    while True:
        buf = frames.get(chain[-1])
        if buf is None:
            raise KeyError(f"missing frame for step {chain[-1]}")
        if peek_kind(buf) != "delta":
            return list(reversed(chain))
        chain.append(delta_base_step(buf))


def composable_steps(frames: Dict[int, Any]) -> list:
    """Steps whose full state is reconstructible from `frames` alone."""
    out = []
    for s in frames:
        try:
            chain_steps(frames, s)
            out.append(s)
        except (KeyError, IOError):
            pass
    return sorted(out)


def compose(frames: Dict[int, Any], step: int
            ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Reconstruct the full snapshot at `step` from a {step: frame-bytes}
    map by walking the delta chain down to its base full frame and
    re-applying patches upward. Returns (extra of the target frame,
    flat). Raises KeyError on a broken chain."""
    chain = chain_steps(frames, step)
    extra, flat = from_bytes(frames[chain[0]])
    writable: set = set()
    for s in chain[1:]:
        extra, _, flat = apply_delta(flat, frames[s], writable)
    return extra, flat
