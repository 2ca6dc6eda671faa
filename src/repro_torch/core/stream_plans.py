"""Generated chunk codecs for ``Stream<T>`` schema nodes.

HGum's thesis is that SER/DES logic is *generated from the message
schema*, never hand-written.  This module extends that to incremental
streams: a ``["Stream", t]`` node in the IDL compiles — via the same
schema ROM as every other type — into a :class:`StreamPlan`, and the
plan drives both the host reference codec here and the batched pack path
on the card (``kernels.ops.encode_chunks_batch``, the B7 CUDA kernel).

Copy of ``repro.core.stream_plans`` (numpy over ``idl`` and
``schema_tree``); only :func:`encode_fragment_burst` differs: it packs on a
torch device.

Wire format of one fragment (all little-endian u32 words)::

    [ stream_id | step | flags | elem words ... | n ]

``n`` is the *element* count and trails the elements (§IV-B
count-after-elements), so a burst of concatenated fragments parses
back-to-front.  Each element occupies ``plan.elem_words`` words: the
fixed-size leaves of the element type, each padded to whole words,
little-endian within a leaf.

The plan also carries the fragment-meta bit budgets (``id_bits`` /
``step_bits``).  The check functions below are shared verbatim between
the runtime (encode raises, decode sets a per-fragment ``corrupt``
flag) and the reference's ``repro.analysis`` ``stream-*`` rules.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, default_device
from .idl import Schema, SchemaError
from .schema_tree import (
    KIND_BYTES,
    KIND_NAMES,
    KIND_STREAM,
    STREAM_META_WORDS,
    build_rom,
)

#: u32 words of fragment metadata: ``(stream_id, step, flags)``
CHUNK_META_WORDS = STREAM_META_WORDS
#: smallest parseable fragment: meta + trailing count word
CHUNK_MIN_WORDS = CHUNK_META_WORDS + 1
#: ``flags`` bit 0 — this fragment ends its stream
FLAG_EOS = 0x1
#: all flag bits the wire format defines; anything else marks corruption
FLAG_KNOWN_MASK = FLAG_EOS
#: an element count this large in a trailing word means a corrupt burst
MAX_CHUNK_TOKENS = 1 << 16
#: id-packing convention of the serve plane: a stream id is
#: ``(hi << STREAM_ID_BITS) | lo`` with each half below ``1 << STREAM_ID_BITS``
STREAM_ID_BITS = 16

_WORD = 4  # bytes per wire word


# ---------------------------------------------------------------------------
# Shared check functions (PR-6 pattern: runtime raises / analyzer wraps)
# ---------------------------------------------------------------------------


def check_chunk_tokens(n: int) -> None:
    """Shared by the runtime encoder and the ``stream-chunk-tokens`` rule."""
    if n >= MAX_CHUNK_TOKENS:
        raise ValueError(f"chunk of {n} tokens exceeds {MAX_CHUNK_TOKENS}")


def meta_budget_error(id_bits: int, step_bits: int) -> Optional[str]:
    """Fragment meta fields each ride one u32 wire word: budgets must fit.

    Backs the ``stream-meta-budget`` analyzer rule; :class:`StreamPlan`
    raises the same message at construction.
    """
    for name, bits in (("id_bits", id_bits), ("step_bits", step_bits)):
        if not (isinstance(bits, int) and 1 <= bits <= 32):
            return (
                f"stream meta budget {name}={bits!r} does not fit the u32 "
                f"fragment-meta word (need 1..32 bits)"
            )
    return None


def elem_size_error(elem_words: int) -> Optional[str]:
    """Element wire size vs. the ``MAX_CHUNK_TOKENS`` count budget.

    The back-to-front parser addresses ``n * elem_words`` words with the
    u32 trailing count, so the largest legal fragment must stay u32
    addressable.  Backs the ``stream-elem-size`` analyzer rule.
    """
    if elem_words < 1:
        return f"stream element is empty ({elem_words} wire words)"
    if MAX_CHUNK_TOKENS * elem_words >= 1 << 32:
        return (
            f"stream element of {elem_words} words makes the largest "
            f"fragment ({MAX_CHUNK_TOKENS - 1} elements) exceed u32 word "
            f"addressing"
        )
    return None


def fragment_meta_error(
    plan: "StreamPlan", stream_id: int, step: int, flags: int = 0
) -> Optional[str]:
    """Out-of-budget fragment metadata.

    Shared by the runtime: ``encode_fragment`` raises this message, and
    ``decode_fragments`` surfaces it as the per-fragment ``corrupt`` flag
    instead of silently attributing elements to a garbage stream.
    """
    if not 0 <= stream_id < (1 << plan.id_bits):
        return (
            f"stream_id {stream_id:#x} outside the {plan.id_bits}-bit "
            f"budget of plan {plan.location!r}"
        )
    if not 0 <= step < (1 << plan.step_bits):
        return (
            f"step {step} outside the {plan.step_bits}-bit budget of "
            f"plan {plan.location!r}"
        )
    if flags & ~FLAG_KNOWN_MASK:
        return (
            f"unknown flag bits {flags & ~FLAG_KNOWN_MASK:#x} in fragment "
            f"of plan {plan.location!r}"
        )
    return None


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StreamPlan:
    """Chunk encode/decode plan generated from one ``Stream<T>`` node.

    ``leaf_paths``/``leaf_nbytes`` are the fixed-size leaves of the
    element type in schema order; ``leaf_words`` is each leaf padded to
    whole u32 words and ``elem_words`` their sum — one element's wire
    footprint.  Elements of a single-leaf plan are plain ints on the
    Python side; multi-leaf elements are tuples in leaf order.
    """

    location: str  # token path of the Stream node, e.g. "tokens"
    leaf_paths: Tuple[str, ...]
    leaf_nbytes: Tuple[int, ...]
    id_bits: int = 2 * STREAM_ID_BITS
    step_bits: int = STREAM_ID_BITS

    def __post_init__(self):
        err = meta_budget_error(self.id_bits, self.step_bits)
        if err is None:
            err = elem_size_error(self.elem_words)
        if err is not None:
            raise SchemaError(f"{self.location}: {err}")

    # cached: these sit on the per-fragment encode/decode hot path, and a
    # frozen dataclass keeps an instance __dict__ for the cache to land in
    @cached_property
    def leaf_words(self) -> Tuple[int, ...]:
        return tuple((n + _WORD - 1) // _WORD for n in self.leaf_nbytes)

    @cached_property
    def elem_words(self) -> int:
        return sum((n + _WORD - 1) // _WORD for n in self.leaf_nbytes)

    @cached_property
    def n_leaves(self) -> int:
        return len(self.leaf_nbytes)


def stream_plans(
    schema: Schema,
    *,
    id_bits: int = 2 * STREAM_ID_BITS,
    step_bits: int = STREAM_ID_BITS,
) -> Dict[str, StreamPlan]:
    """Compile every ``Stream<T>`` node of `schema` into a StreamPlan.

    Plans are derived from the schema ROM (the same compiled form every
    other codec uses), keyed by the stream node's token path.  Stream
    element types must be fixed-size: a nested Array/List/Stream inside
    a stream element has no static wire footprint and is rejected.
    """
    rom = build_rom(schema)
    plans: Dict[str, StreamPlan] = {}
    for i in range(rom.n_nodes):
        if int(rom.kind[i]) != KIND_STREAM:
            continue
        path = rom.paths[i]
        leaf_paths: List[str] = []
        leaf_nbytes: List[int] = []
        j = int(rom.child[i])
        while True:
            k = int(rom.kind[j])
            if k != KIND_BYTES:
                raise SchemaError(
                    f"{path}: stream element must be fixed-size; "
                    f"{rom.paths[j]!r} is a {KIND_NAMES[k]}"
                )
            leaf_paths.append(rom.paths[j])
            leaf_nbytes.append(int(rom.nbytes[j]))
            if int(rom.last[j]):
                break
            j += 1
        plans[path] = StreamPlan(
            location=path,
            leaf_paths=tuple(leaf_paths),
            leaf_nbytes=tuple(leaf_nbytes),
            id_bits=id_bits,
            step_bits=step_bits,
        )
    return plans


# ---------------------------------------------------------------------------
# Fragments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fragment:
    """One decoded stream fragment.

    ``tokens`` holds the elements: ints for single-leaf plans, tuples of
    ints (leaf order) otherwise.  ``corrupt`` marks fragments whose
    metadata violated the plan's declared budgets — the payload is kept
    for diagnostics but must not be attributed to the stream.
    """

    stream_id: int
    step: int
    tokens: Tuple
    eos: bool = False
    corrupt: bool = False


def _u32_vec(tokens: Sequence) -> np.ndarray:
    """Mask a token sequence to u32 wire words (C-speed common case)."""
    try:
        return np.asarray(tokens, dtype=np.uint64) & 0xFFFFFFFF
    except (OverflowError, TypeError):
        # out-of-u64-range or negative ints: mask one by one, same
        # wrap-around semantics as the single-fragment reference path
        return np.asarray(
            [int(t) & 0xFFFFFFFF for t in tokens], dtype="<u4"
        )


def _elem_rows(plan: StreamPlan, tokens: Sequence) -> np.ndarray:
    """(n, elem_words) u32 matrix of the elements' wire words."""
    n = len(tokens)
    out = np.zeros((n, plan.elem_words), dtype="<u4")
    if plan.n_leaves == 1 and plan.leaf_words[0] == 1:
        # fast path: the Stream<Bytes 4>-style single-word element
        if n:
            out[:, 0] = _u32_vec(tokens)
        return out
    for r, elem in enumerate(tokens):
        leaves = (elem,) if plan.n_leaves == 1 else tuple(elem)
        if len(leaves) != plan.n_leaves:
            raise ValueError(
                f"element of plan {plan.location!r} needs "
                f"{plan.n_leaves} leaves, got {len(leaves)}"
            )
        c = 0
        for v, nbytes, words in zip(leaves, plan.leaf_nbytes, plan.leaf_words):
            v = int(v) & ((1 << (8 * nbytes)) - 1)
            for w in range(words):
                out[r, c] = (v >> (32 * w)) & 0xFFFFFFFF
                c += 1
    return out


def _rows_to_elems(plan: StreamPlan, rows: np.ndarray) -> Tuple:
    """Inverse of :func:`_elem_rows` (rows: (n, elem_words) u32)."""
    if plan.n_leaves == 1 and plan.leaf_words[0] == 1:
        return tuple(int(t) for t in rows[:, 0])
    elems = []
    for r in range(rows.shape[0]):
        leaves = []
        c = 0
        for nbytes, words in zip(plan.leaf_nbytes, plan.leaf_words):
            v = 0
            for w in range(words):
                v |= int(rows[r, c]) << (32 * w)
                c += 1
            leaves.append(v & ((1 << (8 * nbytes)) - 1))
        elems.append(leaves[0] if plan.n_leaves == 1 else tuple(leaves))
    return tuple(elems)


def encode_fragment(
    plan: StreamPlan,
    stream_id: int,
    step: int,
    tokens: Sequence,
    eos: bool = False,
) -> bytes:
    """Host reference encoder for one fragment (little-endian u32 words)."""
    check_chunk_tokens(len(tokens))
    flags = FLAG_EOS if eos else 0
    err = fragment_meta_error(plan, stream_id, step, flags)
    if err is not None:
        raise ValueError(err)
    words = np.empty(
        CHUNK_META_WORDS + len(tokens) * plan.elem_words + 1, dtype="<u4"
    )
    words[0] = stream_id
    words[1] = step
    words[2] = flags
    words[CHUNK_META_WORDS:-1] = _elem_rows(plan, tokens).reshape(-1)
    words[-1] = len(tokens)
    return words.tobytes()


def encode_fragment_burst(
    plan: StreamPlan, fragments: Sequence, device: DeviceLike = None
) -> bytes:
    """Encode a burst of fragments through the batched pack kernel.

    Accepts anything with ``stream_id``/``step``/``tokens``/``eos``
    attributes (:class:`Fragment`, ``stream.chunks.TokenChunk``).  The
    burst's meta, element-word and count arrays go to ``device`` (default:
    the card) in ONE host-to-device copy, ``kernels.ops.encode_chunks_batch``
    packs one row per fragment in one launch (the plan's ``elem_words`` as
    the element width, the tail mask fused in), and one copy brings the
    rows back; they are trimmed to the exact wire bytes and concatenated in
    order.  Rows are as wide as the burst's largest fragment: the
    reference's power-of-two bucketing of both axes existed for JAX's jit
    cache and changes no byte.
    """
    from ..kernels.ops import encode_chunks_batch

    if not fragments:
        return b""
    dev = default_device(device)
    counts = [len(f.tokens) for f in fragments]
    b = len(fragments)
    elem_words = plan.elem_words
    one_word = plan.n_leaves == 1 and elem_words == 1
    cap_w = max(1, max(counts)) * elem_words
    # one host buffer [meta (b, 3) | element words (b, cap_w) | counts (b,)]
    # so the burst crosses to the device in a single copy
    n_meta, n_toks = b * CHUNK_META_WORDS, b * cap_w
    flat = np.zeros(n_meta + n_toks + b, dtype=np.uint32)
    meta = flat[:n_meta].reshape(b, CHUNK_META_WORDS)
    toks = flat[n_meta:n_meta + n_toks].reshape(b, cap_w)
    cnts = flat[n_meta + n_toks:]
    # inline guard over the same bounds :func:`fragment_meta_error`
    # checks (which stays the single source of the failure message) —
    # a per-fragment call would dominate small-burst encode time
    id_lim, step_lim = 1 << plan.id_bits, 1 << plan.step_bits
    for i, f in enumerate(fragments):
        n = counts[i]
        if n >= MAX_CHUNK_TOKENS:
            check_chunk_tokens(n)
        flags = FLAG_EOS if f.eos else 0
        if not (0 <= f.stream_id < id_lim and 0 <= f.step < step_lim
                and not flags & ~FLAG_KNOWN_MASK):
            raise ValueError(
                fragment_meta_error(plan, f.stream_id, f.step, flags)
            )
        meta[i, 0] = f.stream_id
        meta[i, 1] = f.step
        meta[i, 2] = flags
        if n:
            if one_word:  # Stream<Bytes 4>-style: no row matrix needed
                try:
                    # direct numpy setitem wraps mod 2**32 like the mask
                    toks[i, :n] = f.tokens
                except (OverflowError, TypeError):
                    toks[i, :n] = _u32_vec(f.tokens)
            else:
                toks[i, : n * elem_words] = _elem_rows(
                    plan, f.tokens
                ).reshape(-1)
        cnts[i] = n
    lanes = torch.from_numpy(flat.view(np.int32)).to(dev)
    rows = encode_chunks_batch(
        lanes[:n_meta].view(b, CHUNK_META_WORDS),
        lanes[n_meta:n_meta + n_toks].view(b, cap_w),
        lanes[n_meta + n_toks:],
        elem_words=elem_words,
    )
    rows = rows.cpu().numpy().view("<u4")
    out = []
    for i, n in enumerate(counts):
        nw = CHUNK_META_WORDS + n * elem_words
        out.append(rows[i, :nw].tobytes())
        out.append(rows[i, -1:].tobytes())
    return b"".join(out)


def decode_fragments(
    plan: StreamPlan, data: bytes
) -> Tuple[List[Fragment], bool]:
    """Parse a burst back-to-front into fragments (wire order).

    Returns ``(fragments, ok)``.  ``ok=False`` means the burst is
    structurally malformed and parsing stopped (a prefix may be
    missing).  Fragments whose metadata violates the plan's budgets
    parse fine structurally but come back with ``corrupt=True``.
    """
    ok = True
    nbytes = len(data)
    if nbytes % _WORD:
        ok = False  # salvage the aligned prefix of a truncated wire
        nbytes -= nbytes % _WORD
    words = np.frombuffer(data[:nbytes], dtype="<u4")
    frags: List[Fragment] = []
    end = len(words)
    ew = plan.elem_words
    while end > 0:
        if end < CHUNK_MIN_WORDS:
            ok = False
            break
        n = int(words[end - 1])
        lo = end - 1 - n * ew - CHUNK_META_WORDS
        if n >= MAX_CHUNK_TOKENS or lo < 0:
            ok = False
            break
        sid, step, flags = (
            int(words[lo]),
            int(words[lo + 1]),
            int(words[lo + 2]),
        )
        rows = words[lo + CHUNK_META_WORDS:end - 1].reshape(n, ew)
        frags.append(
            Fragment(
                stream_id=sid,
                step=step,
                tokens=_rows_to_elems(plan, rows),
                eos=bool(flags & FLAG_EOS),
                corrupt=fragment_meta_error(plan, sid, step, flags)
                is not None,
            )
        )
        end = lo
    frags.reverse()
    return frags, ok
