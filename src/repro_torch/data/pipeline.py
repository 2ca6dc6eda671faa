"""Host->device input pipeline over the HGum wire (SW->HW direction).

Counterpart of ``repro.data.pipeline``.  Host side (software,
store-and-forward, paper §IV-A1): documents -> packed rows -> Batch
message -> wire bytes; ``SyntheticCorpus``, ``pack_documents``,
``serialize_batch`` and ``batch_plan`` are numpy, copied from the
reference.  Device side (streaming DES, §IV-A2): wire -> static plan ->
``kernels.ops.decode_message_kernel`` per leaf -> (tokens, segment_ids,
positions, labels, loss_mask).  A Batch wire of two or more rows puts a
row boundary inside each element leaf (a jump of ``4 * seq + 12`` bytes
against a stride of 4), so both leaves go through the gather kernel (B3),
one launch each; one row is one run (B1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..core.schema_tree import COUNT_BYTES
from ..core.vectorized import DecodePlan
from ..device import DeviceLike, default_device
from ..kernels.ops import decode_message_kernel, wire_to_u32
from .schemas import TOKEN_BYTES


# ---------------------------------------------------------------------------
# Synthetic corpus (documents with power-law lengths)
# ---------------------------------------------------------------------------


class SyntheticCorpus:
    """Reproducible stream of documents; stands in for a tokenized dataset."""

    def __init__(self, vocab: int, seed: int = 0, mean_len: int = 512):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.mean_len = mean_len

    def next_doc(self) -> np.ndarray:
        n = int(np.clip(self.rng.pareto(2.0) * self.mean_len / 2 + 8, 8, 8 * self.mean_len))
        # markov-ish tokens so loss can actually fall
        base = self.rng.integers(2, self.vocab, 4)
        toks = base[self.rng.integers(0, 4, n)]
        noise = self.rng.integers(2, self.vocab, n)
        keep = self.rng.random(n) < 0.8
        return np.where(keep, toks, noise).astype(np.uint32)

    def docs(self) -> "Iterator[np.ndarray]":
        while True:
            yield self.next_doc()


def pack_documents(
    docs: Iterator[np.ndarray], batch: int, seq: int, eod: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy sequence packing: (tokens, segids) both (batch, seq) uint32."""
    tokens = np.zeros((batch, seq), np.uint32)
    segids = np.zeros((batch, seq), np.uint32)
    for b in range(batch):
        pos, seg = 0, 1
        while pos < seq:
            d = next(docs)
            take = min(len(d), seq - pos)
            tokens[b, pos : pos + take] = d[:take]
            segids[b, pos : pos + take] = seg
            pos += take
            seg += 1
            if pos < seq:
                tokens[b, pos] = eod
                segids[b, pos] = 0
                pos += 1
    return tokens, segids


# ---------------------------------------------------------------------------
# Bulk software SER of a Batch message (vectorized; byte-identical to
# ser_sw_to_hw on the Batch schema)
# ---------------------------------------------------------------------------


def serialize_batch(tokens: np.ndarray, segids: np.ndarray) -> bytes:
    B, S = tokens.shape
    row_bytes = 2 * (COUNT_BYTES + S * TOKEN_BYTES)
    out = np.zeros(COUNT_BYTES + B * row_bytes, np.uint8)
    out[:COUNT_BYTES] = np.frombuffer(np.uint32(B).tobytes(), np.uint8)
    rows = out[COUNT_BYTES:].reshape(B, row_bytes)
    cnt = np.frombuffer(np.uint32(S).tobytes(), np.uint8)
    tok_end = COUNT_BYTES + S * TOKEN_BYTES
    rows[:, :COUNT_BYTES] = cnt
    rows[:, COUNT_BYTES:tok_end] = (
        tokens.astype("<u4").view(np.uint8).reshape(B, S * TOKEN_BYTES)
    )
    rows[:, tok_end : tok_end + COUNT_BYTES] = cnt
    rows[:, tok_end + COUNT_BYTES :] = (
        segids.astype("<u4").view(np.uint8).reshape(B, S * TOKEN_BYTES)
    )
    return out.tobytes()


def batch_plan(batch: int, seq: int) -> DecodePlan:
    """Static DecodePlan for a (batch, seq) Batch wire (offsets are affine)."""
    row_bytes = 2 * (COUNT_BYTES + seq * TOKEN_BYTES)
    base = COUNT_BYTES
    rows = np.arange(batch, dtype=np.int64) * row_bytes
    tok0 = base + COUNT_BYTES
    seg0 = tok0 + seq * TOKEN_BYTES + COUNT_BYTES
    elem = np.arange(seq, dtype=np.int64) * TOKEN_BYTES
    offs = {
        "rows": np.zeros(1, np.int32),
        "rows.elem.tokens": (base + rows).astype(np.int32),
        "rows.elem.tokens.elem": (tok0 + rows[:, None] + elem[None, :]).reshape(-1).astype(np.int32),
        "rows.elem.segids": (seg0 - COUNT_BYTES + rows).astype(np.int32),
        "rows.elem.segids.elem": (seg0 + rows[:, None] + elem[None, :]).reshape(-1).astype(np.int32),
    }
    counts = {p: len(v) for p, v in offs.items()}
    nbytes = {p: (COUNT_BYTES if "elem" != p.split(".")[-1] else TOKEN_BYTES) for p in offs}
    nbytes["rows"] = COUNT_BYTES
    is_cont = {p: not p.endswith(".elem") or p in ("rows",) for p in offs}
    wire_len = COUNT_BYTES + batch * row_bytes
    return DecodePlan(offs, counts, nbytes, is_cont, wire_len)


# ---------------------------------------------------------------------------
# Device-side decode -> training batch dict
# ---------------------------------------------------------------------------


def decode_batch(
    wire: bytes, batch: int, seq: int, interpret: bool = True, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """The training batch of one Batch wire, decoded on ``device`` (the
    card by default, raising without one) by the DES kernels.
    ``interpret`` is the reference's Pallas switch, accepted and ignored."""
    plan = batch_plan(batch, seq)
    w32 = wire_to_u32(wire, device)
    dec = decode_message_kernel(
        w32, plan, paths=["rows.elem.tokens.elem", "rows.elem.segids.elem"],
        interpret=interpret,
    )
    # int32 lanes carry the u32 words: the reference's astype(int32)
    tokens = dec["rows.elem.tokens.elem"][:, 0].reshape(batch, seq)
    segids = dec["rows.elem.segids.elem"][:, 0].reshape(batch, seq)
    return finalize_batch(tokens, segids)


def finalize_batch(tokens: torch.Tensor, segids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Shift labels within segments; positions restart per segment."""
    B, S = tokens.shape
    dev = tokens.device
    labels = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype, device=dev)], 1)
    next_seg = torch.cat([segids[:, 1:], torch.zeros((B, 1), dtype=segids.dtype, device=dev)], 1)
    loss_mask = ((segids == next_seg) & (segids > 0)).float()
    idx = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    is_start = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev), segids[:, 1:] != segids[:, :-1]],
        dim=1,
    )
    seg_start = torch.where(is_start, idx, 0)
    seg_start = torch.cummax(seg_start, dim=1).values  # jax.lax.cummax
    positions = idx - seg_start
    return {
        "tokens": tokens,
        "labels": labels,
        "loss_mask": loss_mask,
        "segment_ids": segids,
        "positions": positions,
    }


# ---------------------------------------------------------------------------
# Pipeline object
# ---------------------------------------------------------------------------


@dataclass
class HGumBatchPipeline:
    """End-to-end: corpus -> pack -> HGum wire -> device decode -> batch.

    ``device`` (the card by default, raising without one) is where
    ``next()`` decodes; ``host_make_wire`` touches no device."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    interpret: bool = True
    use_kernel: bool = True
    device: DeviceLike = None

    def __post_init__(self):
        self.device = default_device(self.device)
        self.corpus = SyntheticCorpus(self.vocab, self.seed)
        self._docs = self.corpus.docs()

    def host_make_wire(self) -> bytes:
        tokens, segids = pack_documents(self._docs, self.batch, self.seq)
        return serialize_batch(tokens, segids)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        wire = self.host_make_wire()
        return decode_batch(wire, self.batch, self.seq, interpret=self.interpret,
                            device=self.device)
