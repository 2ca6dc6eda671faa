"""Deterministic chaos injection for the message fabric.

A :class:`FaultPlan` is a *seeded, stateless* description of link faults —
drop, payload corruption, header corruption, duplication, reordering, and
rank blackout windows — that both fabric tick engines (the fused
single-jit tick and the three-program tick) consume at the same logical
point: after frames are framed and laid out for transmission, before the
routed scan sees them.  Every fault decision is a pure function of
``(seed, tick, src, dst, seq)``, so

* the same plan produces the same faults on the fused and three-program
  paths (the engine-parity regression gate in ``tests/test_reliability.py``
  relies on this),
* a retransmitted frame gets a *fresh* tick value and therefore an
  independent fault roll — recovery is possible, and
* any recovery claim in a test or CI log is reproducible from the seed.

The plan operates on **logical frames**: each dispatch presents its
per-rank ordered frame list as ``(src, dst, seq, frame_index_in_message)``
tuples and receives back an ordered list of :class:`FrameOp`\\ s — keep,
drop, xor-a-word, duplicate — plus an optional permutation.  The engines
map ops back onto their own memory layouts; relative order per rank is
preserved, so injection dynamics (and the router's counters) match
bit-for-bit across engines.

Header corruption flips the ``list_level`` header word — guaranteed CRC
failure *without* touching the route word (a corrupted destination could
leave the mesh and abort the whole tick instead of exercising recovery).

``parse_chaos("drop=0.02,corrupt=0.01")`` builds a plan from the CLI
syntax used by ``--chaos`` on the serve entry points.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from .frames import HDR_LEVEL, HDR_WORDS

__all__ = ["FaultPlan", "FrameOp", "parse_chaos"]


def _mix(*vals: int) -> int:
    """Stateless 64-bit integer hash (splitmix64 finalizer over a fold)."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h ^= (v & 0xFFFFFFFFFFFFFFFF) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 30
        h *= 0x94D049BB133111EB
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h


def _unit(*vals: int) -> float:
    """Deterministic uniform float in [0, 1) from the hashed key."""
    return (_mix(*vals) >> 11) / float(1 << 53)


@dataclass(frozen=True)
class FrameOp:
    """One fault decision on one logical frame.

    ``kind``: ``"keep"`` | ``"drop"`` | ``"corrupt"`` | ``"dup"``.
    ``word``/``xor`` describe the corruption (word index into the frame,
    value XORed in); a ``dup`` keeps the original AND inserts a copy
    immediately after it.
    """

    kind: str
    index: int  # position in the rank's pre-fault ordered frame list
    word: int = 0
    xor: int = 0


@dataclass(frozen=True)
class FaultPlan:
    """Seeded per-link fault rates.  All rates are per-frame probabilities
    in [0, 1]; decisions are independent per (tick, src, dst, seq) so a
    retransmit re-rolls.  ``blackout_rank`` drops every frame to or from
    that rank while ``blackout_from <= tick < blackout_from +
    blackout_ticks`` — the "rank goes dark for k ticks" scenario the
    failure-aware serve plane must survive.

    ``link_rates`` / ``rank_rates`` override the global ``drop`` rate for
    specific ``(src, dst)`` links / source ranks (the starved-link and
    flaky-link benchmarks use these).
    """

    seed: int = 0
    drop: float = 0.0
    corrupt: float = 0.0  # payload word XOR -> CRC failure
    corrupt_header: float = 0.0  # list_level word XOR -> CRC failure
    duplicate: float = 0.0
    reorder: float = 0.0  # probability a rank's tick frame list is shuffled
    blackout_rank: Optional[int] = None
    blackout_from: int = 0
    blackout_ticks: int = 0
    link_rates: Dict[Tuple[int, int], float] = field(default_factory=dict)
    rank_rates: Dict[int, float] = field(default_factory=dict)

    def with_seed(self, seed: int) -> "FaultPlan":
        return replace(self, seed=seed)

    # -- per-frame decisions ------------------------------------------------

    def _blacked_out(self, tick: int, src: int, dst: int) -> bool:
        if self.blackout_rank is None or self.blackout_ticks <= 0:
            return False
        if not (self.blackout_from <= tick < self.blackout_from + self.blackout_ticks):
            return False
        return src == self.blackout_rank or dst == self.blackout_rank

    def _drop_rate(self, src: int, dst: int) -> float:
        r = self.link_rates.get((src, dst))
        if r is None:
            r = self.rank_rates.get(src)
        return self.drop if r is None else r

    def frame_ops(
        self,
        tick: int,
        frames: Sequence[Tuple[int, int, int, int]],
        dup_budget: int = 0,
    ) -> Tuple[List[FrameOp], Optional[List[int]]]:
        """Fault decisions for ONE rank's ordered tick frame list.

        ``frames`` is the rank's pre-fault transmit order as ``(src, dst,
        seq, frame_idx)`` tuples.  Returns ``(ops, perm)``: one op per
        input frame in order (``dup`` ops insert after their original),
        and ``perm`` — a seeded permutation of the *post-fault* list when
        this rank's tick reorders, else None.  ``dup_budget`` caps how many
        duplicates may be inserted (the engines pass their spare transmit
        rows; 0 disables duplication for this rank's tick).
        """
        ops: List[FrameOp] = []
        dups = 0
        words = 0  # post-fault frame count, for the permutation below
        for i, (src, dst, seq, fidx) in enumerate(frames):
            key = (self.seed, tick, src, dst, seq, fidx)
            if self._blacked_out(tick, src, dst):
                ops.append(FrameOp("drop", i))
                continue
            if _unit(*key, 1) < self._drop_rate(src, dst):
                ops.append(FrameOp("drop", i))
                continue
            if _unit(*key, 2) < self.corrupt:
                # flip a payload word; which one is itself seeded
                w = HDR_WORDS + _mix(*key, 3) % 4
                ops.append(FrameOp("corrupt", i, word=w,
                                   xor=0x5A5A0000 | (_mix(*key, 4) & 0xFFFF)))
            elif _unit(*key, 5) < self.corrupt_header:
                ops.append(FrameOp("corrupt", i, word=HDR_LEVEL,
                                   xor=0x00A50000))
            elif self.duplicate and dups < dup_budget \
                    and _unit(*key, 6) < self.duplicate:
                ops.append(FrameOp("dup", i))
                dups += 1
                words += 1
            else:
                ops.append(FrameOp("keep", i))
            words += 1
        perm: Optional[List[int]] = None
        if self.reorder and words > 1 and frames:
            src0 = frames[0][0]
            if _unit(self.seed, tick, src0, 0, 0, 0, 7) < self.reorder:
                # seeded Fisher-Yates over the post-fault positions
                perm = list(range(words))
                for j in range(words - 1, 0, -1):
                    k = _mix(self.seed, tick, src0, j, 8) % (j + 1)
                    perm[j], perm[k] = perm[k], perm[j]
        return ops, perm

    @property
    def active(self) -> bool:
        """False when the plan can never produce a fault (all rates 0)."""
        return bool(
            self.drop or self.corrupt or self.corrupt_header
            or self.duplicate or self.reorder or self.link_rates
            or self.rank_rates
            or (self.blackout_rank is not None and self.blackout_ticks > 0)
        )


_CHAOS_KEYS = {
    "drop": float, "corrupt": float, "corrupt_header": float,
    "duplicate": float, "reorder": float,
    "blackout_rank": int, "blackout_from": int, "blackout_ticks": int,
}


def parse_chaos(spec: str, seed: int = 0) -> FaultPlan:
    """Parse the ``--chaos`` CLI syntax: ``"drop=0.02,corrupt=0.01"``.

    Keys: drop, corrupt, corrupt_header, duplicate, reorder (rates in
    [0, 1]); blackout_rank, blackout_from, blackout_ticks (ints).
    """
    kwargs: Dict[str, object] = {"seed": seed}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"chaos spec entry {part!r} is not key=value")
        k, v = (s.strip() for s in part.split("=", 1))
        if k not in _CHAOS_KEYS:
            raise ValueError(
                f"unknown chaos key {k!r} (known: {sorted(_CHAOS_KEYS)})"
            )
        kwargs[k] = _CHAOS_KEYS[k](v)
    return FaultPlan(**kwargs)
