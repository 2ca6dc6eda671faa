"""Token-stream representation (paper §III-C).

Tokens *out of* DES logic: (kind, tag, value, path)
  - DATA         : one Bytes field (value = little-endian int)
  - ARRAY_LENGTH : count of an Array            (paper "array-length")
  - LIST_BEGIN   : start of a List
  - ARRAY_END    : optional end-of-Array marker (emitted iff tagged)
  - LIST_END     : end of a List

Tokens *into* SER logic (paper §III-C2): no tags, no array-end, no list-begin;
LIST_END carries the list nesting level instead of a value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

# token kinds (shared by python + JAX FSM implementations)
TOK_DATA = 0
TOK_ARRAY_LENGTH = 1
TOK_LIST_BEGIN = 2
TOK_ARRAY_END = 3
TOK_LIST_END = 4

TOK_NAMES = {
    TOK_DATA: "data",
    TOK_ARRAY_LENGTH: "array-length",
    TOK_LIST_BEGIN: "list-begin",
    TOK_ARRAY_END: "array-end",
    TOK_LIST_END: "list-end",
}


@dataclass(frozen=True)
class Token:
    kind: int
    value: int = 0  # data payload / array length / list nesting level
    tag: int = -1
    path: str = ""  # debug only; "" when not tracked

    def __repr__(self):  # compact for test failures
        t = TOK_NAMES[self.kind]
        return f"<{t} v={self.value} tag={self.tag}{' ' + self.path if self.path else ''}>"

    def eq_untagged(self, other: "Token") -> bool:
        return self.kind == other.kind and self.value == other.value


def strip_for_ser(tokens: List[Token]) -> List[Token]:
    """Convert a DES-side token stream into the SER-side input format.

    Paper §III-C2: drop array-end tokens, drop list-begin tokens, replace the
    value of list-end tokens with the list nesting level, and drop all tags.
    Requires `path`-free operation, so list nesting levels are recomputed from
    the stream structure itself.
    """
    out: List[Token] = []
    level = 0
    for t in tokens:
        if t.kind == TOK_LIST_BEGIN:
            level += 1
            continue
        if t.kind == TOK_ARRAY_END:
            continue
        if t.kind == TOK_LIST_END:
            out.append(Token(TOK_LIST_END, value=level))
            level -= 1
            continue
        out.append(Token(t.kind, value=t.value))
    return out
