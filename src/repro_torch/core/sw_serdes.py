"""Software SER/DES functions (paper §III-D, §IV-A1, §IV-B).

Store-and-forward, operating on whole messages and randomly-accessible
buffers, exactly like a software messaging framework:

* ``ser_sw_to_hw``   — software SER, SW->HW direction: counts written *before*
  elements (software buffers the whole message, so Array and List are treated
  identically).  This is the wire format the hardware DES logic consumes.
* ``des_sw_oracle``  — forward parse of that format (test oracle).
* ``des_hw_to_sw``   — software DES, HW->SW direction: the hardware SER wrote
  container counts *after* the elements, so this parses the buffer from the
  END (paper §IV-B).
* ``msg_to_des_tokens`` — the token stream a correct hardware DES module must
  emit for a message (with client-schema tags) — oracle for the FSM engines.
* ``tokens_to_msg``  — reconstruct a message from a DES token stream.
* ``random_message`` — schema-directed random message generator for tests.

Message representation: structs are dicts, containers are python lists,
Bytes(n) fields are unsigned ints (little-endian on the wire).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .idl import Array, Bytes, ClientSchema, ListT, Schema, StructRef, TypeNode
from .idl import ELEM, END, START
from .schema_tree import COUNT_BYTES
from .tokens import (
    TOK_ARRAY_END,
    TOK_ARRAY_LENGTH,
    TOK_DATA,
    TOK_LIST_BEGIN,
    TOK_LIST_END,
    Token,
)

_CONTAINER = (Array, ListT)


def _check_value(v: int, n: int, where: str) -> int:
    v = int(v)
    if v < 0 or v >= (1 << (8 * n)):
        raise ValueError(f"{where}: value {v} does not fit in {n} bytes")
    return v


# ---------------------------------------------------------------------------
# SW -> HW: software SER (counts before elements)
# ---------------------------------------------------------------------------


def ser_sw_to_hw(schema: Schema, msg: dict) -> bytes:
    """Software serialization per paper §IV-A1 (simple binary protocol)."""
    out = bytearray()

    def ser(t: TypeNode, v, where: str) -> None:
        if isinstance(t, Bytes):
            out.extend(_check_value(v, t.n, where).to_bytes(t.n, "little"))
        elif isinstance(t, StructRef):
            if not isinstance(v, dict):
                raise TypeError(f"{where}: expected dict for struct, got {type(v)}")
            for fname, ftype in schema.structs[t.name]:
                ser(ftype, v[fname], f"{where}.{fname}")
        elif isinstance(t, _CONTAINER):
            if not isinstance(v, list):
                raise TypeError(f"{where}: expected list, got {type(v)}")
            out.extend(len(v).to_bytes(COUNT_BYTES, "little"))
            for i, e in enumerate(v):
                ser(t.elem, e, f"{where}[{i}]")
        else:  # pragma: no cover
            raise TypeError(f"bad type {t!r}")

    for fname, ftype in schema.structs[schema.top]:
        ser(ftype, msg[fname], fname)
    return bytes(out)


def des_sw_oracle(schema: Schema, buf: bytes) -> dict:
    """Forward parse of the SW->HW format (software-side test oracle)."""
    pos = 0

    def des(t: TypeNode):
        nonlocal pos
        if isinstance(t, Bytes):
            v = int.from_bytes(buf[pos : pos + t.n], "little")
            pos += t.n
            return v
        if isinstance(t, StructRef):
            return {f: des(ft) for f, ft in schema.structs[t.name]}
        if isinstance(t, _CONTAINER):
            n = int.from_bytes(buf[pos : pos + COUNT_BYTES], "little")
            pos += COUNT_BYTES
            return [des(t.elem) for _ in range(n)]
        raise TypeError(f"bad type {t!r}")  # pragma: no cover

    msg = {f: des(ft) for f, ft in schema.structs[schema.top]}
    if pos != len(buf):
        raise ValueError(f"trailing bytes: consumed {pos} of {len(buf)}")
    return msg


# ---------------------------------------------------------------------------
# HW -> SW: hardware SER wrote counts AFTER elements; parse from the end.
# ---------------------------------------------------------------------------


def ser_hw_to_sw_reference(schema: Schema, msg: dict) -> bytes:
    """Reference for what the hardware SER emits in the HW->SW direction:
    identical to ``ser_sw_to_hw`` except container counts trail the elements
    (paper §IV-B)."""
    out = bytearray()

    def ser(t: TypeNode, v, where: str) -> None:
        if isinstance(t, Bytes):
            out.extend(_check_value(v, t.n, where).to_bytes(t.n, "little"))
        elif isinstance(t, StructRef):
            for fname, ftype in schema.structs[t.name]:
                ser(ftype, v[fname], f"{where}.{fname}")
        elif isinstance(t, _CONTAINER):
            for i, e in enumerate(v):
                ser(t.elem, e, f"{where}[{i}]")
            out.extend(len(v).to_bytes(COUNT_BYTES, "little"))
        else:  # pragma: no cover
            raise TypeError(f"bad type {t!r}")

    for fname, ftype in schema.structs[schema.top]:
        ser(ftype, msg[fname], fname)
    return bytes(out)


def des_hw_to_sw(schema: Schema, buf: bytes) -> dict:
    """Software DES for the HW->SW direction: parse the buffer from the END
    (paper §IV-B), reconstructing fields in reverse schema order."""
    pos = len(buf)

    def des(t: TypeNode):
        nonlocal pos
        if isinstance(t, Bytes):
            pos -= t.n
            return int.from_bytes(buf[pos : pos + t.n], "little")
        if isinstance(t, StructRef):
            fields = schema.structs[t.name]
            vals = {}
            for fname, ftype in reversed(fields):
                vals[fname] = des(ftype)
            return {f: vals[f] for f, _ in fields}  # restore field order
        if isinstance(t, _CONTAINER):
            pos -= COUNT_BYTES
            n = int.from_bytes(buf[pos : pos + COUNT_BYTES], "little")
            save = pos
            elems = []
            for _ in range(n):
                elems.append(des(t.elem))
            elems.reverse()
            if pos > save:  # pragma: no cover - defensive
                raise ValueError("reverse parse overran container")
            return elems
        raise TypeError(f"bad type {t!r}")  # pragma: no cover

    fields = schema.structs[schema.top]
    vals = {}
    for fname, ftype in reversed(fields):
        vals[fname] = des(ftype)
    if pos != 0:
        raise ValueError(f"leading bytes left: {pos}")
    return {f: vals[f] for f, _ in fields}


# ---------------------------------------------------------------------------
# Token-stream oracles (paper §III-C1)
# ---------------------------------------------------------------------------


def msg_to_des_tokens(
    schema: Schema, msg: dict, client: Optional[ClientSchema] = None
) -> List[Token]:
    """The token stream a correct DES module emits for `msg` (§III-C1)."""
    client = client or ClientSchema()
    out: List[Token] = []

    def walk(t: TypeNode, v, path: str) -> None:
        if isinstance(t, Bytes):
            out.append(Token(TOK_DATA, value=int(v), tag=client.tag_for(path), path=path))
        elif isinstance(t, StructRef):
            for fname, ftype in schema.structs[t.name]:
                walk(ftype, v[fname], f"{path}.{fname}" if path else fname)
        elif isinstance(t, Array):
            out.append(
                Token(
                    TOK_ARRAY_LENGTH,
                    value=len(v),
                    tag=client.tag_for(f"{path}.{START}"),
                    path=f"{path}.{START}",
                )
            )
            for e in v:
                walk(t.elem, e, f"{path}.{ELEM}")
            end_tag = client.tag_for(f"{path}.{END}")
            if end_tag >= 0:  # array-end emitted iff tagged (§III-C1)
                out.append(Token(TOK_ARRAY_END, tag=end_tag, path=f"{path}.{END}"))
        elif isinstance(t, ListT):
            out.append(
                Token(
                    TOK_LIST_BEGIN,
                    tag=client.tag_for(f"{path}.{START}"),
                    path=f"{path}.{START}",
                )
            )
            for e in v:
                walk(t.elem, e, f"{path}.{ELEM}")
            out.append(
                Token(
                    TOK_LIST_END,
                    value=len(v),
                    tag=client.tag_for(f"{path}.{END}"),
                    path=f"{path}.{END}",
                )
            )
        else:  # pragma: no cover
            raise TypeError(f"bad type {t!r}")

    for fname, ftype in schema.structs[schema.top]:
        walk(ftype, msg[fname], fname)
    return out


def tokens_to_msg(
    schema: Schema, tokens: List[Token], client: Optional[ClientSchema] = None
) -> dict:
    """Reconstruct a message from a DES-side token stream (user-logic view).

    `client` must be the client schema the DES module was generated with so
    that optional array-end tokens are consumed exactly when they were
    emitted (paper §III-C1).
    """
    client = client or ClientSchema()
    pos = 0

    def take(kind: int) -> Token:
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError(f"token stream ended, expected kind {kind}")
        t = tokens[pos]
        if t.kind != kind:
            raise ValueError(f"expected token kind {kind}, got {t!r} at {pos}")
        pos += 1
        return t

    def peek() -> Optional[Token]:
        return tokens[pos] if pos < len(tokens) else None

    def walk(t: TypeNode, path: str):
        if isinstance(t, Bytes):
            return take(TOK_DATA).value
        if isinstance(t, StructRef):
            return {
                f: walk(ft, f"{path}.{f}" if path else f)
                for f, ft in schema.structs[t.name]
            }
        if isinstance(t, Array):
            n = take(TOK_ARRAY_LENGTH).value
            elems = [walk(t.elem, f"{path}.{ELEM}") for _ in range(n)]
            if client.tag_for(f"{path}.{END}") >= 0:
                take(TOK_ARRAY_END)
            return elems
        if isinstance(t, ListT):
            take(TOK_LIST_BEGIN)
            elems = []
            while True:
                nxt = peek()
                if nxt is None:
                    raise ValueError("token stream ended inside a list")
                if nxt.kind == TOK_LIST_END:
                    take(TOK_LIST_END)
                    return elems
                elems.append(walk(t.elem, f"{path}.{ELEM}"))
        raise TypeError(f"bad type {t!r}")  # pragma: no cover

    msg = {}
    for fname, ftype in schema.structs[schema.top]:
        msg[fname] = walk(ftype, fname)
    if pos != len(tokens):
        raise ValueError(f"trailing tokens: consumed {pos} of {len(tokens)}")
    return msg


# ---------------------------------------------------------------------------
# Random messages for property tests
# ---------------------------------------------------------------------------


def random_message(
    schema: Schema,
    rng: np.random.Generator,
    max_elems: int = 4,
    depth_decay: float = 0.7,
) -> dict:
    """Generate a random message conforming to `schema`."""

    def gen(t: TypeNode, depth: int):
        if isinstance(t, Bytes):
            nbits = 8 * t.n
            if nbits <= 62:
                return int(rng.integers(0, 1 << nbits))
            # wide fields: compose 32-bit limbs (numpy bounds are int64)
            v = 0
            for i in range(0, nbits, 32):
                limb_bits = min(32, nbits - i)
                v |= int(rng.integers(0, 1 << limb_bits)) << i
            return v
        if isinstance(t, StructRef):
            return {f: gen(ft, depth) for f, ft in schema.structs[t.name]}
        if isinstance(t, _CONTAINER):
            cap = max(0, int(max_elems * (depth_decay**depth)))
            n = int(rng.integers(0, cap + 1))
            return [gen(t.elem, depth + 1) for _ in range(n)]
        raise TypeError(f"bad type {t!r}")  # pragma: no cover

    return {f: gen(ft, 0) for f, ft in schema.structs[schema.top]}
