"""HGum-framed checkpoint store, counterpart of ``repro.checkpoint.store``.

The on-disk format *is* the paper's HW-to-HW framing protocol (§IV-C)
applied at bulk rate, with one documented extension — a CRC32 word in each
frame header for fault tolerance:

    file   := magic "HGCK" | version u32 | frame*
    frame  := header | payload (padded to phit)
    header := size u32 | list_level u32 | crc32 u32 | reserved u32
              (one 16-byte phit, like the paper's §V configuration)

Stream structure (framing rules verbatim from the paper):
  * level-1 frame: the JSON meta message (leaf paths, shapes, dtypes, step).
  * per tensor, in meta order: level-2 data frames (bounded payload,
    512 phits * 16 B), then an *empty* level-2 frame = end-of-list.
  * an empty level-1 frame terminates the checkpoint (used to detect
    truncated writes in addition to the CRCs).

A port checkpoint of a state is byte for byte the reference's file of the
same state: tensors are named by the reference's pytree paths
(``jax.tree_util.keystr``) in its flatten order — dict keys sorted,
dataclass fields (``OptState``) in order, a module's parameters under
their names read as a path (``layers.0.attn.wq`` ->
``['layers'][0]['attn']['wq']``), and so are the name-keyed dicts of the
optimizer state.  bfloat16 is written as its raw 2 bytes under the dtype
name ``bfloat16`` and read back as ``<u2`` (no ``ml_dtypes`` here), which
:func:`restore_into` views as ``torch.bfloat16``.  Saves are atomic (tmp +
rename); ``CheckpointManager`` keeps the newest K, and a save may
supersede earlier checkpoints (the train loop's straggler checkpoints).
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.common import keystr, path_parts

MAGIC = b"HGCK"
VERSION = 2
PHIT = 16
HEADER = 16
FRAME_PAYLOAD = 512 * PHIT  # paper §IV-C: 512-deep block RAM sizing

PyTree = Any


def _pad(n: int) -> int:
    return (-n) % PHIT


def _header(size: int, level: int, crc: int) -> bytes:
    return np.array([size, level, crc, 0], "<u4").tobytes()


def _write_frames(f, payload: memoryview, level: int) -> None:
    n = len(payload)
    off = 0
    while off < n:
        chunk = payload[off : off + FRAME_PAYLOAD]
        crc = zlib.crc32(chunk)
        f.write(_header(len(chunk), level, crc))
        f.write(chunk)
        f.write(b"\0" * _pad(len(chunk)))
        off += len(chunk)
    # empty frame = end of this list level (paper: "an empty frame always
    # represents the end of a list")
    f.write(_header(0, level, 0))


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path suffix, child) of a container in the reference's flatten
    order; None for a leaf."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: path_parts(str(k)))
        return [(keystr(path_parts(str(k))), tree[k]) for k in keys]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _leaf_paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [leaf for k, v in kids for leaf in _leaf_paths(v, prefix + k)]


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """A leaf's bytes as a numpy array, and its dtype name."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, a.dtype.name


def save_checkpoint(path: str, tree: PyTree, meta: Optional[Dict] = None) -> str:
    """Atomically write `tree` (+user meta) to `path`."""
    leaves = _leaf_paths(tree)
    arrays = [_to_numpy(x) for _, x in leaves]
    meta_obj = {
        "version": VERSION,
        "user": meta or {},
        "tensors": [
            {"path": p, "shape": list(a.shape), "dtype": dt}
            for (p, _), (a, dt) in zip(leaves, arrays)
        ],
    }
    meta_bytes = json.dumps(meta_obj).encode()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(VERSION).tobytes())
        f.write(b"\0" * _pad(len(MAGIC) + 4))
        _write_frames(f, memoryview(meta_bytes), level=1)
        for a, _ in arrays:
            buf = np.ascontiguousarray(a)
            _write_frames(f, memoryview(buf.view(np.uint8).reshape(-1)), level=2)
        f.write(_header(0, 1, 0))  # end of checkpoint
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class CorruptCheckpoint(ValueError):
    pass


def _read_frames(buf: bytes, pos: int, level: int) -> Tuple[bytes, int]:
    """Read data frames at `level` until its empty terminator frame."""
    out = bytearray()
    while True:
        if pos + HEADER > len(buf):
            raise CorruptCheckpoint("truncated: missing frame header")
        size, lvl, crc, rsv = np.frombuffer(buf[pos : pos + HEADER], "<u4")
        pos += HEADER
        if int(rsv) != 0:
            raise CorruptCheckpoint("nonzero reserved header word")
        if int(lvl) != level:
            raise CorruptCheckpoint(f"frame level {lvl}, expected {level}")
        if size == 0:
            return bytes(out), pos
        chunk = buf[pos : pos + int(size)]
        if len(chunk) != int(size):
            raise CorruptCheckpoint("truncated frame payload")
        if zlib.crc32(chunk) != int(crc):
            raise CorruptCheckpoint("CRC mismatch")
        out.extend(chunk)
        pos += int(size) + _pad(int(size))


def load_checkpoint(path: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Returns (meta_json, {leaf_path: np.ndarray}); bfloat16 leaves come
    back as ``<u2`` arrays of their raw bits."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != MAGIC:
        raise CorruptCheckpoint("bad magic")
    pos = 4 + 4 + _pad(8)
    meta_bytes, pos = _read_frames(buf, pos, level=1)
    meta = json.loads(meta_bytes.decode())
    tensors: Dict[str, np.ndarray] = {}
    for t in meta["tensors"]:
        raw, pos = _read_frames(buf, pos, level=2)
        np_dt = np.dtype("<u2") if t["dtype"] == "bfloat16" else np.dtype(t["dtype"])
        tensors[t["path"]] = np.frombuffer(raw, np_dt).reshape(t["shape"])
    # final empty level-1 frame proves the file is complete
    if pos + HEADER > len(buf):
        raise CorruptCheckpoint("missing end-of-checkpoint frame")
    size, lvl, _, _ = np.frombuffer(buf[pos : pos + HEADER], "<u4")
    if int(size) != 0 or int(lvl) != 1:
        raise CorruptCheckpoint("missing end-of-checkpoint frame")
    return meta, tensors


def _as_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A loaded array as a tensor of ``like``'s dtype, on its device."""
    if like.dtype == torch.bfloat16 and a.dtype == np.dtype("<u2"):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a)).to(like.dtype)
    return t.to(like.device)


def restore_into(
    template: PyTree,
    tensors: Dict[str, np.ndarray],
    place: Optional[Callable[[str, np.ndarray], Any]] = None,
) -> PyTree:
    """Rebuild a tree shaped like ``template`` from loaded tensors.

    A module's parameters are overwritten in place and the module comes
    back; dicts, lists and dataclasses come back new.  ``place(path,
    array)`` builds a leaf (default: a tensor of the template leaf's dtype
    on its device)."""

    def build(node, prefix: str):
        if isinstance(node, torch.nn.Module):
            named = dict(node.named_parameters())
            new = build(named, prefix)
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(new[n])
            return node
        if _children(node) is None:
            if prefix not in tensors:
                raise KeyError(f"checkpoint missing leaf {prefix}")
            a = tensors[prefix]
            arr = place(prefix, a) if place else _as_tensor(a, node)
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"{prefix}: shape {tuple(arr.shape)} != template "
                                 f"{tuple(node.shape)}")
            return arr
        if isinstance(node, dict):
            return {k: build(v, prefix + keystr(path_parts(str(k)))) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}[{i}]") for i, v in enumerate(node))
        return dataclasses.replace(node, **{
            f.name: build(getattr(node, f.name), f"{prefix}.{f.name}")
            for f in dataclasses.fields(node)})

    return build(template, "")


# ---------------------------------------------------------------------------
# Manager: step-numbered files, keep-K, resume latest
# ---------------------------------------------------------------------------


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    prefix: str = "ckpt"

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}.hgck")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith(self.prefix + "_") and fn.endswith(".hgck"):
                try:
                    out.append(int(fn[len(self.prefix) + 1 : -5]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, step: int, tree: PyTree, meta: Optional[Dict] = None,
             supersede: Sequence[int] = ()) -> str:
        """Write the checkpoint of ``step``, then remove the checkpoints of
        the steps in ``supersede`` (which this one replaces), then keep the
        newest K.  Removing before pruning keeps a replaced checkpoint from
        taking the place of one that is kept."""
        meta = dict(meta or {})
        meta["step"] = step
        p = save_checkpoint(self.path(step), tree, meta)
        for s in supersede:
            self._remove(s)
        self._gc()
        return p

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(
        self, template: PyTree, place=None
    ) -> Tuple[Optional[int], PyTree]:
        """Restore the newest valid checkpoint; skip corrupt ones."""
        for step in reversed(self.all_steps()):
            try:
                meta, tensors = load_checkpoint(self.path(step))
            except (CorruptCheckpoint, OSError):
                continue
            return step, restore_into(template, tensors, place)
        return None, template

    def _remove(self, step: int) -> None:
        try:
            os.remove(self.path(step))
        except OSError:
            pass

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            self._remove(s)
