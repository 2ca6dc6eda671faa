"""Token-chunk wire format — the first *generated* ``Stream<T>`` codec.

Counterpart of ``repro.stream.chunks``, byte for byte; bursts pack on the
card (``kernels.ops.encode_chunks_batch``, the B7 CUDA kernel) unless the
caller passes ``device="cpu"``.

HGum's claim is that a large List streams through the SER/DES incrementally
— nobody buffers the whole message.  Applied to serving, a response is a
List of generated tokens whose length is unknown until decode finishes, so
the shard should emit each decode step's tokens the tick they are produced
instead of buffering the whole ``response_schema`` wire.  The unit of that
stream is a *token chunk*: one decode step's tokens for one sequence,
serialized as an incremental HGum List fragment.

This module used to be a hand-rolled one-off wire format riding beside the
schema-driven core.  It is now the first generated instance of the
``["Stream", t]`` IDL node: the token stream is *declared* as schema JSON
(:data:`TOKEN_STREAM_SCHEMA_JSON`, a ``Stream<Bytes 4>``), compiled through
the schema ROM into a ``core.stream_plans.StreamPlan``, and every public
function below delegates to the generated codec.  The wire format is
byte-for-byte identical to the pre-refactor hand-rolled one (regression:
``tests/golden/token_chunks.bin``).

Chunk layout (u32 words, HW->SW List convention — the count comes AFTER
the elements, paper §IV-B, so the host parses from the end)::

    [ stream_id | step | flags ] [ tok0 .. tok_{n-1} ] [ n ]

* ``stream_id`` — writer-scoped stream identifier (the serve plane packs
  ``(local_request << 16) | prompt_index``);
* ``step``      — chunk sequence number within the stream, starting at 0;
  the reader flags gaps exactly like the fabric flags frame-seq gaps;
* ``flags``     — bit 0 = end-of-stream terminator (the explicit EOS the
  paper's size-0 frame plays at the framing layer);
* ``n``         — token count, written last.

Because the count trails the elements, chunk wires concatenate into a
*burst* that parses back-to-front with no delimiters: the last word of the
burst is the last chunk's count, which locates that chunk's start, and so
on.  One fabric message per (shard, tenant) per tick therefore carries every
live sequence's chunk — ``encode_chunk_burst`` assembles them all in ONE
batched kernel launch (``kernels.ops.encode_chunks_batch``).

Ordering and integrity ride the layers below: the fabric's route-word seq
numbers order the bursts per (src, dst) stream, the per-frame CRC32 flags
corruption per message, and ``stream.plane.StreamReader`` turns both into
per-stream corruption flags.  Fragment metadata that violates the plan's
declared bit budgets (e.g. a step past the u16 step budget, or unknown
flag bits) additionally sets the per-chunk :attr:`TokenChunk.corrupt`
flag rather than silently attributing tokens to a garbage stream.

Declaring a *new* streamed payload needs no codec code at all — see
:data:`LOGPROB_STREAM_SCHEMA_JSON` (per-token logprobs as
``Stream<Struct{tok, logprob}>``) and ``examples/typed_streams.py``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from ..core.idl import Schema
from ..device import DeviceLike
from ..core.stream_plans import (
    CHUNK_META_WORDS,
    CHUNK_MIN_WORDS,
    FLAG_EOS,
    MAX_CHUNK_TOKENS,
    STREAM_ID_BITS,
    StreamPlan,
    check_chunk_tokens,
    decode_fragments,
    encode_fragment,
    encode_fragment_burst,
    stream_plans,
)

__all__ = [
    "CHUNK_META_WORDS",
    "CHUNK_MIN_WORDS",
    "FLAG_EOS",
    "MAX_CHUNK_TOKENS",
    "STREAM_ID_BITS",
    "TOKEN_STREAM_SCHEMA_JSON",
    "LOGPROB_STREAM_SCHEMA_JSON",
    "TokenChunk",
    "check_chunk_tokens",
    "decode_token_chunks",
    "encode_chunk_burst",
    "encode_token_chunk",
    "logprob_stream_plan",
    "token_stream_plan",
]

#: the shipped token stream, declared in schema JSON: one decode step's
#: tokens as a ``Stream<Bytes 4>`` (a u32 token id per element)
TOKEN_STREAM_SCHEMA_JSON = {
    "TokenStream": [["tokens", ["Stream", ["Bytes", 4]]]],
}

#: per-token logprobs — the second shipped typed stream, proving the
#: generated codec path: each element is ``Struct{tok, logprob}`` (the
#: chosen token id + its float32 logprob bit pattern), two u32 words on
#: the wire, and NO hand-written codec exists for it anywhere.
LOGPROB_STREAM_SCHEMA_JSON = {
    "LogprobStream": [["entries", ["Stream", ["Struct", "LogprobEntry"]]]],
    "LogprobEntry": [["tok", ["Bytes", 4]], ["logprob", ["Bytes", 4]]],
}


@functools.lru_cache(maxsize=None)
def token_stream_plan() -> StreamPlan:
    """The generated plan behind this module's public codec functions.

    ``id_bits`` is the full u32 word (serve packs ``(request:u16 |
    prompt:u16)``, using both :data:`STREAM_ID_BITS` halves);
    ``step_bits`` is the u16 step budget the serve plane guarantees.
    """
    schema = Schema.from_json(TOKEN_STREAM_SCHEMA_JSON)
    return stream_plans(
        schema, id_bits=2 * STREAM_ID_BITS, step_bits=STREAM_ID_BITS
    )["tokens"]


@functools.lru_cache(maxsize=None)
def logprob_stream_plan() -> StreamPlan:
    """Generated plan for the shipped logprob stream (same meta budgets)."""
    schema = Schema.from_json(LOGPROB_STREAM_SCHEMA_JSON)
    return stream_plans(
        schema, id_bits=2 * STREAM_ID_BITS, step_bits=STREAM_ID_BITS
    )["entries"]


@dataclass(frozen=True)
class TokenChunk:
    """One decode step's tokens for one stream.

    ``corrupt`` is set by the decoder when the fragment's metadata
    violated the token plan's declared budgets (out-of-budget step,
    unknown flag bits) — the tokens are kept for diagnostics but the
    stream must be treated as corrupt.
    """

    stream_id: int
    step: int
    tokens: Tuple[int, ...]
    eos: bool = False
    corrupt: bool = False


def encode_token_chunk(
    stream_id: int, step: int, tokens: Sequence[int], eos: bool = False
) -> bytes:
    """Serialize ONE chunk (host reference path; bursts use the kernel)."""
    return encode_fragment(token_stream_plan(), stream_id, step, tokens, eos)


def encode_chunk_burst(chunks: Sequence[TokenChunk],
                       device: DeviceLike = None) -> bytes:
    """Serialize a tick's chunks into one burst wire through the batched
    small-chunk kernel on ``device`` (default: the card) — one SER launch
    for every live sequence.

    Bit-identical to concatenating ``encode_token_chunk`` outputs.
    """
    return encode_fragment_burst(token_stream_plan(), chunks, device)


def decode_token_chunks(wire: bytes) -> Tuple[List[TokenChunk], bool]:
    """Parse a burst wire back into chunks, BACK TO FRONT (§IV-B: the host
    reads trailing counts to locate element runs).

    Returns ``(chunks, ok)`` with chunks in emission order.  ``ok`` is
    False when the structure does not parse cleanly (truncated wire,
    impossible count) — the parser salvages every chunk it can walk from
    the end so a flagged delivery still attributes corruption to streams.
    Chunks whose metadata is structurally fine but out of the plan's
    budgets come back with ``corrupt=True`` instead of poisoning ``ok``.
    """
    frags, ok = decode_fragments(token_stream_plan(), wire)
    return [
        TokenChunk(f.stream_id, f.step, f.tokens, f.eos, f.corrupt)
        for f in frags
    ], ok
