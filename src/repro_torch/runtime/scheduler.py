"""Continuous-batching serve scheduler: fixed KV slots, admit/evict per step.

Counterpart of ``repro.runtime.scheduler``.  A :class:`ContinuousBatcher`
owns

* a **slot cache** — one model cache of ``slots`` rows that lives across
  requests, updated in place: zeros of the shapes and dtypes of the cache
  that the admit prefill returns (``models.cache_zeros``), as the
  reference allocates it from prefill's ``jax.eval_shape``.  Attention
  K/V, Mamba, mLSTM and sLSTM states alike; an idle slot's mLSTM/sLSTM
  stabiliser starts at 0 as in the reference, which matters because idle
  slots keep decoding and, in an MoE model, take expert capacity.  A vlm's
  K/V rows hold the vision prefix too (``prompt_cap + max_new +
  vision_tokens``), and an encdec's cache carries every layer's encoder
  K/V (``enc_kv``), which an admit copies like the rest;
* the **static model inputs** of a family — the reference's float32 zero
  placeholders for ``vision`` (A, vision_tokens, vision_dim) or ``audio``
  (A, enc_seq, d_model) — allocated once on the device, not per admit;
* the **serving steps** of ``launch.steps.cached_serve_steps``;
* an **admit/evict loop** — every tick first admits pending sequences into
  free slots (one fixed-shape prefill of ``admit_cap`` rows, copied into
  their slots; unused admit rows are dropped), then runs ONE batched
  decode step for all live slots and evicts the finished ones.

A tick is split into :meth:`step_begin` / :meth:`step_finish`.
``step_begin`` enqueues the admit prefill and the batched decode on the
device and returns at once (CUDA launches are asynchronous).
``step_finish`` makes the tick's one host sync — a single ``.cpu()`` of the
admitted sequences' first tokens and the decode step's tokens, with their
logprob bits beside them when ``logprobs=True`` — records them and returns
them as ``(seq_id, position, token)`` emissions, in the reference's order:
admit-time first tokens, then the decode step's.  The tick's logprobs land
in :attr:`ContinuousBatcher.tick_logprobs`.

``metrics`` (an ``obs.MetricsRegistry``) receives the reference's
``batcher.*`` counters and gauges; ``spans`` is the reference's duck-typed
span hook (``event(span_id, name, **fields)``), a no-op when None.
``trace`` (an ``obs.TraceRecorder``) gets the tick's timeline
(``obs.timeline``): a ``batcher.tick`` span from ``step_begin`` to the end
of ``step_finish``, holding ``batcher.prefill`` (the admit's prefill and
slot copies) and ``batcher.decode`` (the decode step's enqueue), both with
their device time, then ``batcher.sync`` (the one ``.cpu()``) and
``batcher.emit`` (the Python after it); a tick's ``gap_ms`` is the device
time from the last tick's final enqueue to this tick's start.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..obs.timeline import NULL_SPAN, mark, span


@dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the serve loop (documented in launch/serve.py's docstring)."""

    slots: int = 8  # fixed KV-cache rows = max concurrent sequences
    prompt_cap: int = 32  # prompts are padded/truncated to this length
    max_new: int = 16  # greedy tokens generated per sequence
    admit_cap: Optional[int] = None  # prefill width per tick (default: slots)

    def __post_init__(self) -> None:
        if self.slots < 1 or self.prompt_cap < 1 or self.max_new < 1:
            raise ValueError(
                f"slots/prompt_cap/max_new must be >= 1, got "
                f"{self.slots}/{self.prompt_cap}/{self.max_new}"
            )
        if self.admit_cap is not None and self.admit_cap < 1:
            raise ValueError(f"admit_cap must be >= 1 or None, got {self.admit_cap}")

    @property
    def admit_width(self) -> int:
        return self.admit_cap or self.slots

    @property
    def cache_len(self) -> int:
        return self.prompt_cap + self.max_new


@dataclass
class _Sequence:
    seq_id: Hashable
    tokens: List[int]
    out: List[int] = field(default_factory=list)
    remaining: int = 0


def _kept_rows(slot_ids: np.ndarray, slots: int, device) -> Optional[Tuple[torch.Tensor,
                                                                          torch.Tensor]]:
    """(admit rows, their slots) of the rows whose slot id lies inside the
    cache, or None.  Unused admit rows hold ``slots`` (one past the last
    slot); the reference's ``mode="drop"`` scatter discards those, and so
    do the copies here, explicitly."""
    rows = np.nonzero(slot_ids < slots)[0]
    if not rows.size:
        return None
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(slot_ids[rows].astype(np.int64)).to(device))


def _scatter_rows(cache: Dict, cur_tok: torch.Tensor, new_cache: Dict,
                  new_tok: torch.Tensor, slot_ids: np.ndarray) -> None:
    """Copy prefilled rows into their slots, in place: every tensor of
    every layer's state, along the batch axis (unused admit rows dropped,
    see :func:`_kept_rows`)."""
    kept = _kept_rows(slot_ids, cur_tok.shape[0], cur_tok.device)
    if kept is None:
        return
    src, dst = kept
    for c, n in zip(cache["layers"], new_cache["layers"]):
        for name, t in c.items():
            t.index_copy_(0, dst, n[name].index_select(0, src).to(t.dtype))
    for c, n in zip(cache.get("enc_kv", ()), new_cache.get("enc_kv", ())):
        for t, nt in zip(c, n):
            t.index_copy_(0, dst, nt.index_select(0, src).to(t.dtype))
    cache["pos"].index_copy_(0, dst, new_cache["pos"].index_select(0, src))
    cur_tok.index_copy_(0, dst, new_tok.index_select(0, src))


def _scatter_vec(vec: torch.Tensor, new: torch.Tensor, slot_ids: np.ndarray) -> None:
    """Slot copy for the per-slot logprob column, in place (same drop rule
    as :func:`_scatter_rows`)."""
    kept = _kept_rows(slot_ids, vec.shape[0], vec.device)
    if kept is not None:
        vec.index_copy_(0, kept[1], new.index_select(0, kept[0]).to(vec.dtype))


def extra_inputs(cfg: ModelConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    """The family's non-token model inputs as the reference's float32 zero
    placeholders: ``vision`` for a vlm, ``audio`` for an encdec, none for
    an lm."""
    if cfg.family == "vlm":
        shape = (batch, cfg.vision_tokens, cfg.vision_dim)
        return {"vision": torch.zeros(shape, dtype=torch.float32, device=device)}
    if cfg.family == "encdec":
        shape = (batch, cfg.enc_seq, cfg.d_model)
        return {"audio": torch.zeros(shape, dtype=torch.float32, device=device)}
    return {}


class ContinuousBatcher:
    """Admit/decode/evict loop over a fixed-slot KV cache."""

    def __init__(self, params, cfg: ModelConfig, sched: SchedulerConfig,
                 metrics=None, spans=None, logprobs: bool = False, trace=None):
        from ..launch.steps import cached_serve_steps
        from ..models.model import cache_zeros

        self.params = params
        self.cfg = cfg
        self.sched = sched
        #: optional obs.MetricsRegistry (admit/evict counters, occupancy +
        #: queue-depth gauges); None = no-op telemetry
        self.metrics = metrics
        #: optional span tracker; seq_ids with an entry in :attr:`span_of`
        #: get "batcher.admit"/"batcher.evict" events
        self.spans = spans
        self.span_of: Dict[Hashable, int] = {}
        #: optional obs.TraceRecorder for the tick's timeline spans
        self.trace = trace
        self._tick = NULL_SPAN
        self._tick_end = None  # mark after the last tick's final enqueue
        #: when True the steps also return the chosen token's logprob,
        #: surfaced per tick in :attr:`tick_logprobs` (the greedy pick is
        #: unchanged — token output is byte-identical either way)
        self.logprobs = logprobs
        self.device = params.embed.device
        self.prefill_step, self.decode_step = cached_serve_steps(
            cfg, cache_len=sched.cache_len, logprobs=logprobs
        )
        self.cache = cache_zeros(cfg, sched.slots, sched.prompt_cap, sched.cache_len,
                                 self.device)
        self._extra_inputs = extra_inputs(cfg, sched.admit_width, self.device)
        self.cur_tok = torch.zeros((sched.slots, 1), dtype=torch.int32, device=self.device)
        self.cur_lp = torch.zeros((sched.slots, 1), dtype=torch.float32, device=self.device)
        #: (seq_id, position) -> logprob of every emission of the last tick
        #: (filled by step_finish when ``logprobs=True``)
        self.tick_logprobs: Dict[Tuple[Hashable, int], float] = {}
        self.active: List[Optional[_Sequence]] = [None] * sched.slots
        self.pending: Deque[_Sequence] = deque()
        self.done: Dict[Hashable, List[int]] = {}
        self.steps_run = 0
        # admitted this tick, first tokens still on the device
        self._admitted: List[_Sequence] = []
        self._first_tok: Optional[torch.Tensor] = None
        self._first_lp: Optional[torch.Tensor] = None
        self._stepped = False

    # -- queue -------------------------------------------------------------

    def submit(self, seq_id: Hashable, tokens: List[int]) -> None:
        self.pending.append(_Sequence(seq_id, list(tokens)))

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.active)

    # -- scheduler tick ----------------------------------------------------

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.active) if s is None]
        if not free or not self.pending:
            return
        A = self.sched.admit_width
        take = min(len(free), A, len(self.pending))
        seqs = [self.pending.popleft() for _ in range(take)]
        S = self.sched.prompt_cap
        with span(self.trace, "batcher.prefill", device=self.device, parent=self._tick,
                  rows=take):
            # right-padded with token 0, no pad mask (the reference's batch)
            toks = np.zeros((A, S), np.int32)
            for j, seq in enumerate(seqs):
                toks[j, : min(len(seq.tokens), S)] = seq.tokens[:S]
            batch = dict(self._extra_inputs)
            batch["tokens"] = torch.from_numpy(toks).to(self.device)
            if self.logprobs:
                next_tok, next_lp, new_cache = self.prefill_step(self.params, batch)
            else:
                next_tok, new_cache = self.prefill_step(self.params, batch)
            # unused admit rows -> out-of-range slot id, dropped by the copy
            slot_ids = np.full(A, self.sched.slots, np.int64)
            slot_ids[:take] = free[:take]
            _scatter_rows(self.cache, self.cur_tok, new_cache, next_tok, slot_ids)
            self._first_tok = next_tok[:take, 0]
            if self.logprobs:
                _scatter_vec(self.cur_lp, next_lp, slot_ids)
                self._first_lp = next_lp[:take, 0]
        self._admitted = seqs
        for j, seq in enumerate(seqs):
            seq.remaining = self.sched.max_new - 1
            self.active[free[j]] = seq
            if self.spans is not None and seq.seq_id in self.span_of:
                self.spans.event(self.span_of[seq.seq_id], "batcher.admit", slot=free[j])
        if self.metrics is not None:
            self.metrics.counter("batcher.admitted").add(take)
        self._evict()

    def _evict(self) -> None:
        evicted = 0
        for i, seq in enumerate(self.active):
            if seq is not None and seq.remaining <= 0:
                # ``seq.out`` is the list the caller gets; tokens still on
                # the device are appended to it in step_finish
                self.done[seq.seq_id] = seq.out
                self.active[i] = None
                evicted += 1
                if self.spans is not None and seq.seq_id in self.span_of:
                    # an evicted sequence has produced all max_new tokens,
                    # some of which may still be on the device
                    self.spans.event(self.span_of[seq.seq_id], "batcher.evict",
                                     n_out=self.sched.max_new)
        if self.metrics is not None and evicted:
            self.metrics.counter("batcher.evicted").add(evicted)

    def step_begin(self) -> bool:
        """Enqueue one scheduler tick: admit into free slots, then one
        batched decode step for every live slot.  Returns without waiting
        for the device; True when a decode step was enqueued.  Must be
        paired with :meth:`step_finish`."""
        self._tick = span(self.trace, "batcher.tick").begin()
        self._tick.interval("gap_ms", self._tick_end, mark(self.trace, self.device))
        self._admitted, self._first_tok, self._first_lp = [], None, None
        self.tick_logprobs = {}
        self._admit()
        if self.metrics is not None:
            self.metrics.gauge("batcher.occupancy").set(self.n_active)
            self.metrics.gauge("batcher.queue_depth").set(len(self.pending))
        if self.n_active == 0:
            self._stepped = False
            return False
        with span(self.trace, "batcher.decode", device=self.device, parent=self._tick):
            if self.logprobs:
                self.cur_tok, self.cur_lp, self.cache = self.decode_step(
                    self.params, self.cache, self.cur_tok)
            else:
                self.cur_tok, self.cache = self.decode_step(self.params, self.cache,
                                                            self.cur_tok)
        self.steps_run += 1
        self._stepped = True
        if self.metrics is not None:
            self.metrics.counter("batcher.steps").add(1)
        return True

    def step_finish(self) -> List[Tuple[Hashable, int, int]]:
        """Sync the tick and return its emissions: every token the tick
        produced — admit-time first tokens first — as
        ``(seq_id, position, token)`` triples in emission order."""
        tick, self._tick = self._tick, NULL_SPAN
        parts, lp_parts = [], []
        if self._first_tok is not None:
            parts.append(self._first_tok)
            lp_parts.append(self._first_lp)
        if self._stepped:
            parts.append(self.cur_tok[:, 0])
            lp_parts.append(self.cur_lp[:, 0])
        if not parts:
            tick.end()
            return []
        with span(self.trace, "batcher.sync", parent=tick):
            if self.logprobs:
                # the float32 logprob bits ride beside the tokens: one copy
                parts.append(torch.cat(lp_parts).view(torch.int32))
            flat = torch.cat(parts)
            self._tick_end = mark(self.trace, self.device)
            host = flat.cpu().numpy()  # the tick's one host sync
        emit = span(self.trace, "batcher.emit", parent=tick).begin()
        n = len(host) // 2 if self.logprobs else len(host)
        lps = host[n:].view(np.float32) if self.logprobs else None
        emitted: List[Tuple[Hashable, int, int]] = []
        for j, seq in enumerate(self._admitted):
            seq.out.append(int(host[j]))
            emitted.append((seq.seq_id, 0, int(host[j])))
            if lps is not None:
                self.tick_logprobs[(seq.seq_id, 0)] = float(lps[j])
        if self._stepped:
            off = len(self._admitted)
            for i, seq in enumerate(self.active):
                if seq is not None:
                    seq.out.append(int(host[off + i]))
                    seq.remaining -= 1
                    pos = len(seq.out) - 1
                    emitted.append((seq.seq_id, pos, int(host[off + i])))
                    if lps is not None:
                        self.tick_logprobs[(seq.seq_id, pos)] = float(lps[off + i])
            self._evict()
        self._admitted, self._first_tok, self._first_lp = [], None, None
        self._stepped = False
        emit.end()
        tick.end()
        return emitted

    def step(self) -> None:
        """One synchronous scheduler tick (enqueue + sync back to back)."""
        self.step_begin()
        self.step_finish()

    def run(self) -> Dict[Hashable, List[int]]:
        """Drain the queue; returns seq_id -> generated tokens."""
        while self.pending or self.n_active:
            self.step()
        out, self.done = self.done, {}
        return out
