"""Streaming message plane: token-level streamed responses over the fabric.

Counterpart of ``repro.stream``; fragment bursts pack on the card with the
B7 CUDA kernel (``kernels.ops.encode_chunks_batch``).

HGum serializes a List incrementally — neither side buffers the whole
message (§IV).  This package applies that rule to the serving response
path: instead of waiting for a shard's whole ``response_schema`` wire, each
decode step's tokens leave the shard the tick they are produced, as framed
chunk bursts (``chunks.py``) demultiplexed back into per-request streams at
the ingress (``plane.py``).

Layers:

* ``chunks`` — the token-chunk codec, *generated* from its ``Stream<T>``
  schema declaration (``core.stream_plans``): count-after-elements List
  fragments with stream ids, step numbers, and explicit end-of-stream
  terminators; bursts serialize through the batched small-chunk
  kernel.  New streamed payloads (e.g. the shipped logprob stream) are
  declared purely in schema JSON — no hand-written codec.
* ``plane``  — ``StreamWriter``/``ChunkLane`` on the shard side (one fabric
  message per tenant per tick), ``StreamReader`` at the ingress (ordering,
  per-stream corruption flags, EOS tracking).  Both take a generated
  ``plan=`` to carry any typed stream; the default is the token plan.

The serve loop that ties this to compute — overlapped
``Fabric.exchange_async`` ticks against ``ContinuousBatcher`` steps, QoS
credit classes per tenant — is ``launch.serve.serve_requests_streaming``.
"""
from .chunks import (
    CHUNK_META_WORDS,
    FLAG_EOS,
    LOGPROB_STREAM_SCHEMA_JSON,
    MAX_CHUNK_TOKENS,
    STREAM_ID_BITS,
    TOKEN_STREAM_SCHEMA_JSON,
    TokenChunk,
    decode_token_chunks,
    encode_chunk_burst,
    encode_token_chunk,
    logprob_stream_plan,
    token_stream_plan,
)
from .plane import (
    ChunkLane,
    StreamEvent,
    StreamReader,
    StreamState,
    StreamWriter,
    arrive_stats,
)

__all__ = [
    "CHUNK_META_WORDS", "FLAG_EOS", "MAX_CHUNK_TOKENS", "STREAM_ID_BITS",
    "TOKEN_STREAM_SCHEMA_JSON", "LOGPROB_STREAM_SCHEMA_JSON", "TokenChunk",
    "decode_token_chunks", "encode_chunk_burst", "encode_token_chunk",
    "logprob_stream_plan", "token_stream_plan",
    "ChunkLane", "StreamEvent", "StreamReader", "StreamState", "StreamWriter",
    "arrive_stats",
]
