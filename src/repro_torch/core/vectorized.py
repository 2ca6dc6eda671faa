"""HGum decode on the card: numpy structure pass + torch payload pass.

The structure pass (``DecodePlan``, ``build_plan``, ``plan_from_wire``,
``BatchedDecodePlan``, ``stack_wires``, ``batch_plans``) is numpy and is a
copy of ``repro.core.vectorized``: the host walks the schema once and
records the byte offset of every instance of every leaf.  The payload pass
(``decode_leaf``, ``decode_batch``, ``decode_message``) is written in torch:
one gather per leaf path moves every payload byte at once.  It is the
counterpart of the reference's jnp payload pass and equals it bit for bit.
It is not what the CUDA kernels of ``repro_torch.kernels.phit_unpack`` are
held to: each kernel is held to its own plain version in that module.  The
two differ past the end of a wire (this gather clips to the last byte, the
kernels and their plain versions read zeros), so they agree only on rows
that lie inside the wire.

Lane carrier: token lanes are little-endian u32 words.  torch's ``uint32``
has no shifts or comparisons on the CPU, so the port carries every u32 lane
in an ``int32`` tensor holding the same bit pattern; arithmetic on lanes is
done in ``int64``.  :func:`lanes_u32` views lanes as ``np.uint32`` for
comparisons and :func:`lanes_to_int`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, default_device
from .idl import Array, Bytes, ListT, Schema, StructRef, TypeNode, ELEM
from .schema_tree import COUNT_BYTES

_CONTAINER = (Array, ListT)


# ---------------------------------------------------------------------------
# Decode plan (structure pass)
# ---------------------------------------------------------------------------


@dataclass
class DecodePlan:
    """Byte offsets of every instance of every field path, padded to caps."""

    offsets: Dict[str, np.ndarray]  # path -> int32[cap] byte offsets (pad = 0)
    counts: Dict[str, int]  # path -> true instance count
    nbytes: Dict[str, int]  # path -> field width (COUNT_BYTES for containers)
    is_container: Dict[str, bool]
    wire_len: int

    def cap(self, path: str) -> int:
        return int(self.offsets[path].shape[0])


def _walk_paths(schema: Schema) -> List[Tuple[str, TypeNode]]:
    """All (path, type) pairs of the flattened schema in traversal order."""
    out: List[Tuple[str, TypeNode]] = []

    def walk(t: TypeNode, path: str) -> None:
        if isinstance(t, Bytes):
            out.append((path, t))
        elif isinstance(t, StructRef):
            for f, ft in schema.structs[t.name]:
                walk(ft, f"{path}.{f}" if path else f)
        elif isinstance(t, _CONTAINER):
            out.append((path, t))
            walk(t.elem, f"{path}.{ELEM}")
        else:  # pragma: no cover
            raise TypeError(f"bad type {t!r}")

    for f, ft in schema.structs[schema.top]:
        walk(ft, f)
    return out


def build_plan(
    schema: Schema, msg: dict, caps: Optional[Dict[str, int]] = None
) -> DecodePlan:
    """Host-side structure pass over a message (SW->HW wire format)."""
    offs: Dict[str, List[int]] = {p: [] for p, _ in _walk_paths(schema)}
    widths: Dict[str, int] = {}
    is_cont: Dict[str, bool] = {}
    for p, t in _walk_paths(schema):
        widths[p] = t.n if isinstance(t, Bytes) else COUNT_BYTES
        is_cont[p] = isinstance(t, _CONTAINER)
    pos = 0

    def walk(t: TypeNode, v, path: str) -> None:
        nonlocal pos
        if isinstance(t, Bytes):
            offs[path].append(pos)
            pos += t.n
        elif isinstance(t, StructRef):
            for f, ft in schema.structs[t.name]:
                walk(ft, v[f], f"{path}.{f}" if path else f)
        elif isinstance(t, _CONTAINER):
            offs[path].append(pos)
            pos += COUNT_BYTES
            for e in v:
                walk(t.elem, e, f"{path}.{ELEM}")
        else:  # pragma: no cover
            raise TypeError(f"bad type {t!r}")

    for f, ft in schema.structs[schema.top]:
        walk(ft, msg[f], f)

    out_offs, out_counts = {}, {}
    for p, lst in offs.items():
        cap = (caps or {}).get(p, max(1, len(lst)))
        if len(lst) > cap:
            raise ValueError(f"{p}: {len(lst)} instances exceed cap {cap}")
        arr = np.zeros(cap, np.int32)
        arr[: len(lst)] = lst
        out_offs[p] = arr
        out_counts[p] = len(lst)
    return DecodePlan(out_offs, out_counts, widths, is_cont, wire_len=pos)


def _static_size(schema: Schema, t: TypeNode) -> Optional[int]:
    """Wire bytes of `t` if fixed-size (containers are dynamic -> None)."""
    if isinstance(t, Bytes):
        return t.n
    if isinstance(t, StructRef):
        tot = 0
        for _, ft in schema.structs[t.name]:
            s = _static_size(schema, ft)
            if s is None:
                return None
            tot += s
        return tot
    return None


def plan_from_wire(
    schema: Schema,
    wire: bytes,
    caps: Optional[Dict[str, int]] = None,
    record_paths: Optional[List[str]] = None,
) -> DecodePlan:
    """Structure pass over a received wire (no values needed, counts only).

    Cost is O(#container instances + #recorded instances): when
    `record_paths` restricts recording, fixed-size unrecorded subtrees are
    skipped by multiplication instead of being walked element by element.
    """
    paths = _walk_paths(schema)
    wanted = set(record_paths) if record_paths is not None else {p for p, _ in paths}
    offs: Dict[str, List[int]] = {p: [] for p, _ in paths if p in wanted}
    widths = {p: (t.n if isinstance(t, Bytes) else COUNT_BYTES) for p, t in paths}
    is_cont = {p: isinstance(t, _CONTAINER) for p, t in paths}

    pos = 0

    def walk(t: TypeNode, path: str) -> None:
        nonlocal pos
        if isinstance(t, Bytes):
            if path in offs:
                offs[path].append(pos)
            pos += t.n
        elif isinstance(t, StructRef):
            for f, ft in schema.structs[t.name]:
                walk(ft, f"{path}.{f}" if path else f)
        elif isinstance(t, _CONTAINER):
            if path in offs:
                offs[path].append(pos)
            n = int.from_bytes(wire[pos : pos + COUNT_BYTES], "little")
            pos += COUNT_BYTES
            es = _static_size(schema, t.elem)
            epath = f"{path}.{ELEM}"
            recorded_below = any(p.startswith(epath) for p in offs)
            if es is not None and not recorded_below:
                pos += n * es  # skip the whole fixed-size run
            elif es is not None and recorded_below and _only_leaf(t.elem):
                # uniform run: offsets are an arithmetic sequence (prefix-sum
                # fast path — this is the TPU-native container decode)
                offs[epath].extend(range(pos, pos + n * es, es))
                pos += n * es
            else:
                for _ in range(n):
                    walk(t.elem, epath)
        else:  # pragma: no cover
            raise TypeError(f"bad type {t!r}")

    def _only_leaf(t: TypeNode) -> bool:
        return isinstance(t, Bytes)

    for f, ft in schema.structs[schema.top]:
        walk(ft, f)

    out_offs, out_counts = {}, {}
    for p, lst in offs.items():
        cap = (caps or {}).get(p, max(1, len(lst)))
        if len(lst) > cap:
            raise ValueError(f"{p}: {len(lst)} instances exceed cap {cap}")
        arr = np.zeros(cap, np.int32)
        arr[: len(lst)] = lst
        out_offs[p] = arr
        out_counts[p] = len(lst)
    return DecodePlan(out_offs, out_counts, widths, is_cont, wire_len=pos)


# ---------------------------------------------------------------------------
# Batched structure pass: one schema walk shared by N wires
# ---------------------------------------------------------------------------


@dataclass
class BatchedDecodePlan:
    """A :class:`DecodePlan` with a leading message axis.

    ``offsets[path]`` is int32[N, cap] (pad = 0), ``counts[path]`` is
    int64[N].  One plan drives one gather per leaf path for *all* messages
    (see :func:`decode_batch`), which is how the message plane amortizes the
    structure pass across a serving batch.
    """

    offsets: Dict[str, np.ndarray]  # path -> int32[N, cap]
    counts: Dict[str, np.ndarray]  # path -> int64[N] true instance counts
    nbytes: Dict[str, int]
    is_container: Dict[str, bool]
    wire_lens: np.ndarray  # int64[N] consumed bytes per wire

    @property
    def n_messages(self) -> int:
        return int(self.wire_lens.shape[0])

    def cap(self, path: str) -> int:
        return int(self.offsets[path].shape[1])

    def plan_for(self, i: int) -> DecodePlan:
        """Slice out message `i` as a plain single-message DecodePlan."""
        return DecodePlan(
            offsets={p: o[i].copy() for p, o in self.offsets.items()},
            counts={p: int(c[i]) for p, c in self.counts.items()},
            nbytes=dict(self.nbytes),
            is_container=dict(self.is_container),
            wire_len=int(self.wire_lens[i]),
        )


def stack_wires(wires: List[bytes], pad_to: Optional[int] = None) -> np.ndarray:
    """Stack N wires into a zero-padded uint8[N, L] matrix."""
    L = max([len(w) for w in wires] + [1])
    if pad_to is not None:
        if pad_to < L:
            raise ValueError(f"pad_to {pad_to} < longest wire {L}")
        L = pad_to
    buf = np.zeros((len(wires), L), np.uint8)
    for i, w in enumerate(wires):
        buf[i, : len(w)] = np.frombuffer(w, np.uint8)
    return buf


def batch_plans(
    schema: Schema,
    wires: List[bytes],
    caps: Optional[Dict[str, int]] = None,
    record_paths: Optional[List[str]] = None,
) -> BatchedDecodePlan:
    """Vectorized :func:`plan_from_wire` across N wires of one schema.

    The schema is walked *once*; every step of the walk operates on a column
    of per-message cursors (`pos[N]`) with an activity mask, so the Python
    recursion depth is bounded by the largest message's structure, not the
    sum over messages.  Fixed-size element runs are recorded as arithmetic
    sequences per message (the same prefix-sum fast path as the scalar walk)
    without touching the wire bytes at all.

    Raises ``ValueError`` if any message overflows a cap (default cap per
    path = max instance count over the batch).
    """
    N = len(wires)
    if N == 0:
        raise ValueError("batch_plans: empty wire list")
    # COUNT_BYTES of zero padding so masked-out count reads never index OOB.
    buf = stack_wires(wires, pad_to=max(len(w) for w in wires) + COUNT_BYTES)
    paths = _walk_paths(schema)
    wanted = set(record_paths) if record_paths is not None else {p for p, _ in paths}
    widths = {p: (t.n if isinstance(t, Bytes) else COUNT_BYTES) for p, t in paths}
    is_cont = {p: isinstance(t, _CONTAINER) for p, t in paths}
    # Recording log per path: ("one", mask, pos) appends one instance to every
    # active message; ("run", mask, start, n, stride) appends n[m] instances
    # at start[m] + stride*k.  Assembled into (N, cap) arrays at the end.
    recs: Dict[str, List[tuple]] = {p: [] for p, _ in paths if p in wanted}

    pos = np.zeros(N, np.int64)
    wlens = np.array([len(w) for w in wires], np.int64)

    def read_counts(mask: np.ndarray) -> np.ndarray:
        """Little-endian COUNT_BYTES at pos[m] for active messages, else 0."""
        n = np.zeros(N, np.int64)
        idx = np.nonzero(mask)[0]
        # A corrupted count earlier in a wire can push its cursor past the
        # end; fail that message loudly instead of indexing OOB.
        bad = idx[pos[idx] + COUNT_BYTES > wlens[idx]]
        if bad.size:
            m = int(bad[0])
            raise ValueError(
                f"message {m}: count field at byte {int(pos[m])} overruns "
                f"wire of {int(wlens[m])} bytes (truncated or corrupt)"
            )
        for k in range(COUNT_BYTES):
            n[idx] |= buf[idx, pos[idx] + k].astype(np.int64) << (8 * k)
        return n

    def walk(t: TypeNode, path: str, mask: np.ndarray) -> None:
        nonlocal pos
        if isinstance(t, Bytes):
            if path in recs:
                recs[path].append(("one", mask, pos.copy()))
            pos = pos + t.n * mask
        elif isinstance(t, StructRef):
            for f, ft in schema.structs[t.name]:
                walk(ft, f"{path}.{f}" if path else f, mask)
        elif isinstance(t, _CONTAINER):
            if path in recs:
                recs[path].append(("one", mask, pos.copy()))
            n = read_counts(mask)
            pos = pos + COUNT_BYTES * mask
            es = _static_size(schema, t.elem)
            epath = f"{path}.{ELEM}"
            recorded_below = any(p.startswith(epath) for p in recs)
            if es is not None and not recorded_below:
                pos = pos + n * es  # skip the whole fixed-size run
            elif es is not None and isinstance(t.elem, Bytes):
                recs[epath].append(("run", mask, pos.copy(), n, es))
                pos = pos + n * es
            else:
                for k in range(int(n.max())):
                    walk(t.elem, epath, mask & (k < n))
        else:  # pragma: no cover
            raise TypeError(f"bad type {t!r}")

    all_on = np.ones(N, bool)
    for f, ft in schema.structs[schema.top]:
        walk(ft, f, all_on)
    over = np.nonzero(pos > wlens)[0]
    if over.size:
        m = int(over[0])
        raise ValueError(
            f"message {m}: structure pass consumed {int(pos[m])} bytes but "
            f"wire has {int(wlens[m])} (truncated or corrupt)"
        )

    out_offs: Dict[str, np.ndarray] = {}
    out_counts: Dict[str, np.ndarray] = {}
    for p, log in recs.items():
        counts = np.zeros(N, np.int64)
        for rec in log:
            if rec[0] == "one":
                counts += rec[1]
            else:
                _, mask, _, n, _ = rec
                counts += np.where(mask, n, 0)
        cap = (caps or {}).get(p, max(1, int(counts.max())))
        over = np.nonzero(counts > cap)[0]
        if over.size:
            m = int(over[0])
            raise ValueError(
                f"{p}: message {m} has {int(counts[m])} instances, exceeds cap {cap}"
            )
        offs = np.zeros((N, cap), np.int32)
        cur = np.zeros(N, np.int64)
        for rec in log:
            if rec[0] == "one":
                _, mask, at = rec
                idx = np.nonzero(mask)[0]
                offs[idx, cur[idx]] = at[idx]
                cur[idx] += 1
            else:
                _, mask, start, n, stride = rec
                idx = np.nonzero(mask & (n > 0))[0]
                if not idx.size:
                    continue
                reps = n[idx]
                rows = np.repeat(idx, reps)
                # per-row 0..n[m]-1 ramp without a Python loop
                ramp = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
                offs[rows, np.repeat(cur[idx], reps) + ramp] = (
                    np.repeat(start[idx], reps) + stride * ramp
                )
                cur[idx] += reps
        out_offs[p] = offs
        out_counts[p] = counts
    return BatchedDecodePlan(out_offs, out_counts, widths, is_cont, wire_lens=pos)


# ---------------------------------------------------------------------------
# Lane carrier helpers
# ---------------------------------------------------------------------------

_U32 = 1 << 32


def u32_to_lanes(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 lanes holding the same bits."""
    return torch.where(v >= _U32 // 2, v - _U32, v).to(torch.int32)


def lanes_to_i64(lanes: torch.Tensor) -> torch.Tensor:
    """int32 lanes -> int64 values in [0, 2**32)."""
    return lanes.to(torch.int64) & (_U32 - 1)


def lanes_u32(lanes) -> np.ndarray:
    """int32 lanes (any device) -> the same bits as an ``np.uint32`` array."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.detach().cpu().numpy()
    lanes = np.ascontiguousarray(lanes)
    if lanes.dtype in (np.int32, np.uint32):
        return lanes.view(np.uint32)
    return lanes.astype(np.uint32)


# ---------------------------------------------------------------------------
# Payload pass (vectorized gather) — counterpart of the jnp payload pass
# ---------------------------------------------------------------------------


def wire_to_u8(wire: bytes, device: DeviceLike = None) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(wire, dtype=np.uint8).copy()).to(
        default_device(device)
    )


def decode_leaf(
    wire_u8: torch.Tensor, offsets: torch.Tensor, nbytes: int
) -> torch.Tensor:
    """Gather all instances of one leaf field: (cap,) byte offsets ->
    (cap, ceil(nbytes/4)) u32 little-endian lanes (int32 carrier).

    Byte indices past the wire clip to its last byte, as the reference
    ``decode_leaf`` does; rows that lie inside the wire are exact."""
    nlanes = (nbytes + 3) // 4
    dev = wire_u8.device
    offsets = offsets.to(device=dev, dtype=torch.int64)
    byte_idx = offsets[:, None] + torch.arange(nbytes, device=dev)[None, :]
    byte_idx = byte_idx.clamp(0, wire_u8.shape[0] - 1)
    b = wire_u8[byte_idx].to(torch.int64)  # (cap, nbytes)
    pad = nlanes * 4 - nbytes
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(offsets.shape[0], nlanes, 4)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=dev)
    return u32_to_lanes((b << shifts).sum(dim=-1))


def decode_batch(
    wires_u8: torch.Tensor,  # (N, L) uint8, zero-padded (see stack_wires)
    bplan: BatchedDecodePlan,
    paths: Optional[List[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Batched payload pass: ONE gather per leaf path moves every instance of
    every message.  Returns path -> int32 lanes [N, cap, nlanes] (rows past
    ``bplan.counts[path][m]`` are padding).  The counterpart of the
    reference's jnp ``decode_batch``; ``kernels.ops.decode_batch_kernel``
    equals it on every row that lies inside its wire (past the wire this
    gather clips to the last byte, the kernels read zeros)."""
    N, L = wires_u8.shape
    flat = wires_u8.reshape(-1)
    base = (np.arange(N, dtype=np.int64) * L)[:, None]
    out = {}
    for p in paths or bplan.offsets.keys():
        cap = bplan.cap(p)
        offs = torch.from_numpy((bplan.offsets[p] + base).reshape(-1))
        lanes = decode_leaf(flat, offs, bplan.nbytes[p])
        out[p] = lanes.reshape(N, cap, lanes.shape[-1])
    return out


def decode_message(
    wire_u8: torch.Tensor, plan: DecodePlan, paths: Optional[List[str]] = None
) -> Dict[str, torch.Tensor]:
    """Decode every requested path into padded int32-lane buffers."""
    out = {}
    for p in paths or plan.offsets.keys():
        offs = torch.from_numpy(plan.offsets[p].astype(np.int64))
        out[p] = decode_leaf(wire_u8, offs, plan.nbytes[p])
    return out


def lanes_to_int(lanes, nbytes: int) -> np.ndarray:
    """u32 lanes (tensor or array) -> python-int object array (test helper)."""
    lanes = lanes_u32(lanes).astype(np.uint64)
    out = np.zeros(lanes.shape[0], dtype=object)
    for j in range(lanes.shape[1]):
        out = out + (lanes[:, j].astype(object) << (32 * j))
    mask = (1 << (8 * nbytes)) - 1
    return np.array([int(v) & mask for v in out], dtype=object)
