"""Central schemas (HGum IDL) for the framework's own messages.

These are the *messages* of the training/serving system — the paper's
technique applied to ourselves:

* ``batch_schema``    — SW->HW training batch: an Array of fixed-length rows
  (tokens + segment ids).  Fixed-size rows make every leaf a uniform run,
  so the device DES hits the ``unpack_run`` kernel fast path.
* ``request_schema``  — serving request: a List of prompts, each a List of
  token ids (lengths unknown up front — the paper's List case).
* ``response_schema`` — HW->SW response: List of generated ids per prompt
  (hardware SER writes counts after elements, host parses from the end).
"""
from __future__ import annotations

from ..core.idl import ClientSchema, Schema

TOKEN_BYTES = 4


def batch_schema(seq_len: int) -> Schema:
    # Fixed-length rows: Array of Row structs; row fields are Arrays whose
    # runtime length equals seq_len (validated by the pipeline).
    return Schema.from_json({
        "Batch": [
            ["rows", ["Array", ["Struct", "Row"]]],
        ],
        "Row": [
            ["tokens", ["Array", ["Bytes", TOKEN_BYTES]]],
            ["segids", ["Array", ["Bytes", TOKEN_BYTES]]],
        ],
    })


def batch_client_schema() -> ClientSchema:
    return ClientSchema.from_json({
        "rows.start": 1,
        "rows.elem.tokens.start": 2,
        "rows.elem.tokens.elem": 3,
        "rows.elem.segids.start": 4,
        "rows.elem.segids.elem": 5,
    })


def request_schema() -> Schema:
    return Schema.from_json({
        "Request": [
            ["req_id", ["Bytes", 8]],
            ["prompts", ["List", ["Struct", "Prompt"]]],
        ],
        "Prompt": [
            ["tokens", ["List", ["Bytes", TOKEN_BYTES]]],
        ],
    })


def response_schema() -> Schema:
    return Schema.from_json({
        "Response": [
            ["req_id", ["Bytes", 8]],
            ["outputs", ["List", ["Struct", "Output"]]],
        ],
        "Output": [
            ["tokens", ["List", ["Bytes", TOKEN_BYTES]]],
        ],
    })
