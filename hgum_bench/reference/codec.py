"""Frozen HGum codec for the serving plane's two messages.

A copy of the wire layout of ``request_schema`` and ``response_schema``
(``Request{req_id: Bytes8, prompts: List<Prompt{tokens: List<Bytes4>}>}``
and ``Response{req_id: Bytes8, outputs: List<Output{tokens:
List<Bytes4>}>}``), kept here so that no change to the program can move
the yardstick.  All integers are little-endian; a container count takes 4
bytes.

* SW->HW (a request, paper section IV-A1): each count comes before its
  elements.
* HW->SW (a response, paper section IV-B): each count comes after its
  elements, so the host parses it from the end.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

COUNT_BYTES = 4
TOKEN_BYTES = 4


def encode_request(req_id: int, prompts: List[np.ndarray]) -> bytes:
    """The SW->HW wire of one request."""
    parts = [int(req_id).to_bytes(8, "little"), len(prompts).to_bytes(COUNT_BYTES, "little")]
    for p in prompts:
        p = np.asarray(p, dtype="<u4")
        parts.append(len(p).to_bytes(COUNT_BYTES, "little"))
        parts.append(p.tobytes())
    return b"".join(parts)


def decode_request(wire: bytes) -> Tuple[int, List[List[int]]]:
    """Forward parse of a SW->HW request wire; raises ``ValueError`` on a
    malformed one."""
    if len(wire) < 8 + COUNT_BYTES:
        raise ValueError("request wire too short")
    rid = int.from_bytes(wire[:8], "little")
    n = int.from_bytes(wire[8:12], "little")
    pos, prompts = 12, []
    for _ in range(n):
        if pos + COUNT_BYTES > len(wire):
            raise ValueError("request wire truncated")
        k = int.from_bytes(wire[pos:pos + COUNT_BYTES], "little")
        pos += COUNT_BYTES
        end = pos + k * TOKEN_BYTES
        if end > len(wire):
            raise ValueError("request wire truncated")
        prompts.append(np.frombuffer(wire[pos:end], dtype="<u4").astype(np.int64).tolist())
        pos = end
    if pos != len(wire):
        raise ValueError(f"{len(wire) - pos} trailing bytes in a request wire")
    return rid, prompts


def encode_response(req_id: int, outputs: List[List[int]]) -> bytes:
    """The HW->SW wire of one response (counts after elements)."""
    parts = [int(req_id).to_bytes(8, "little")]
    for o in outputs:
        parts.append(np.asarray(o, dtype="<u4").tobytes())
        parts.append(len(o).to_bytes(COUNT_BYTES, "little"))
    parts.append(len(outputs).to_bytes(COUNT_BYTES, "little"))
    return b"".join(parts)


def decode_response(wire: bytes) -> Tuple[int, List[List[int]]]:
    """Reverse parse of a HW->SW response wire; raises ``ValueError`` on a
    malformed one."""
    if not isinstance(wire, (bytes, bytearray)) or len(wire) < 8 + COUNT_BYTES:
        raise ValueError("response wire too short")
    pos = len(wire) - COUNT_BYTES
    n = int.from_bytes(wire[pos:], "little")
    outputs = []
    for _ in range(n):
        pos -= COUNT_BYTES
        if pos < 8:
            raise ValueError("response wire truncated")
        k = int.from_bytes(wire[pos:pos + COUNT_BYTES], "little")
        start = pos - k * TOKEN_BYTES
        if start < 8:
            raise ValueError("response wire truncated")
        outputs.append(np.frombuffer(wire[start:pos], dtype="<u4").astype(np.int64).tolist())
        pos = start
    if pos != 8:
        raise ValueError(f"{pos - 8} stray bytes in a response wire")
    outputs.reverse()
    return int.from_bytes(wire[:8], "little"), outputs
