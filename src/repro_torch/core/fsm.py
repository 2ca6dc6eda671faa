"""Cycle-accurate hardware SER/DES engines (paper §IV).

These execute the paper's microarchitecture literally: a schema-independent
FSM walking the schema ROM with a context stack.  One FSM action == one
hardware cycle; the returned cycle counts drive the throughput reproduction
of paper Fig. 14 (see ``benchmarks/bench_fig14_*``).

Cycle model (constants documented; the paper reports only "a few extra
cycles" per container / frame):

* emitting any token (data / array-length / list-begin / array-end /
  list-end) costs 1 cycle;
* completing a container whose end token is *not* emitted still costs 1
  bookkeeping cycle (finding the next node);
* restarting a container element (ChildPtr jump) is combinational — 0 cycles;
* consuming or producing a frame header costs ``FrameWriter.cycles_per_frame``
  (SER, default 2: header fixup + flush) / 1 cycle (DES header read);
* visiting the END node costs 1 cycle.

Directions implemented (paper Figures 8-10):
  * ``DesFSM(direction="sw2hw")``  — hardware DES of the software SER format
    (in-band, length-prefixed counts);
  * ``SerFSM(direction="hw2sw")``  — hardware SER writing counts *after*
    elements (software parses from the end);
  * ``SerFSM(direction="hw2hw")`` / ``DesFSM(direction="hw2hw")`` — framed
    lists per §IV-C.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .framing import (
    DEFAULT_FRAME_PHITS,
    DEFAULT_PHIT_BYTES,
    FrameHeader,
    FrameWriter,
    payload_wire_bytes,
)
from .schema_tree import (
    COUNT_BYTES,
    KIND_ARRAY,
    KIND_BYTES,
    KIND_END,
    KIND_LIST,
    SchemaROM,
)
from .tokens import (
    TOK_ARRAY_END,
    TOK_ARRAY_LENGTH,
    TOK_DATA,
    TOK_LIST_BEGIN,
    TOK_LIST_END,
    Token,
)

NULL = -1


def fsm_step_bound(rom, n_items: int) -> int:
    """Static step bound of one DES/SER engine run over ``n_items`` input
    units (wire bytes or tokens): linear in the input plus a per-node
    allowance for container bookkeeping.  Shared by both engines' runtime
    guards and the ``repro.analysis`` schema pass, so the bound the
    analyzer reports is the bound the engines enforce."""
    return 8 * n_items + 64 * rom.n_nodes + 64


@dataclass
class Context:
    """One context-stack entry (paper §IV-A2)."""

    num: Optional[int]  # remaining elements; None for framed Lists (unknown)
    ctype: int  # KIND_ARRAY or KIND_LIST
    child_ptr: int
    next_ptr: int  # NULL when the container is the last child
    emit_end: bool
    tag_end: int
    path_idx: int  # ROM index of the container node (debug / end-token path)
    done: int = 0  # elements completed so far (list-end carries this count)


@dataclass
class EngineResult:
    tokens: List[Token]
    cycles: int
    wire: bytes = b""
    frames: int = 0

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


class _ProtocolError(ValueError):
    pass


# ---------------------------------------------------------------------------
# DES
# ---------------------------------------------------------------------------


class DesFSM:
    """Hardware deserializer: phit/byte stream -> token stream + cycle count."""

    def __init__(
        self,
        rom: SchemaROM,
        direction: str = "sw2hw",
        phit_bytes: int = DEFAULT_PHIT_BYTES,
    ):
        if direction not in ("sw2hw", "hw2hw"):
            raise ValueError(f"bad DES direction {direction!r}")
        self.rom = rom
        self.direction = direction
        self.phit_bytes = phit_bytes

    # -- byte-stream plumbing ------------------------------------------------

    def _read_raw(self, n: int) -> bytes:
        b = self._buf[self._pos : self._pos + n]
        if len(b) != n:
            raise _ProtocolError(f"stream underrun: wanted {n} at {self._pos}")
        self._pos += n
        return b

    def _align(self) -> None:
        self._pos += (-self._pos) % self.phit_bytes

    def _n_list_ctx(self) -> int:
        return sum(1 for c in self._stack if c.ctype == KIND_LIST)

    def _read_header(self) -> FrameHeader:
        self._align()
        hdr, self._pos = FrameHeader.unpack(self._buf, self._pos, self.phit_bytes)
        self._cycles += 1  # header-consume cycle
        self._frames += 1
        return hdr

    def _take_header(self) -> FrameHeader:
        if self._pending_hdr is not None:
            hdr, self._pending_hdr = self._pending_hdr, None
            return hdr
        return self._read_header()

    def _read(self, n: int) -> bytes:
        """Read n payload bytes, crossing frame boundaries when framed."""
        if self.direction == "sw2hw" or self._n_list_ctx() == 0:
            return self._read_raw(n)
        out = bytearray()
        while len(out) < n:
            if self._frame_left == 0:
                hdr = self._take_header()
                if hdr.is_end_of_list or hdr.list_level != self._n_list_ctx():
                    raise _ProtocolError(
                        f"unexpected frame {hdr} mid-element at level "
                        f"{self._n_list_ctx()}"
                    )
                self._frame_left = hdr.size
                self._frame_pad = payload_wire_bytes(hdr.size, self.phit_bytes) - hdr.size
            take = min(n - len(out), self._frame_left)
            out.extend(self._read_raw(take))
            self._frame_left -= take
            if self._frame_left == 0:
                self._read_raw(self._frame_pad)  # skip phit padding
                self._frame_pad = 0
        return bytes(out)

    # -- token emission --------------------------------------------------------

    def _emit(self, kind: int, value: int = 0, tag: int = -1, path: str = "") -> None:
        self._tokens.append(Token(kind, value=value, tag=tag, path=path))
        self._cycles += 1

    # -- main traversal (paper §IV-A2) -----------------------------------------

    def run(self, wire: bytes) -> EngineResult:
        rom = self.rom
        self._buf = wire
        self._pos = 0
        self._cycles = 0
        self._frames = 0
        self._tokens = []
        self._stack: List[Context] = []
        self._frame_left = 0
        self._frame_pad = 0
        self._pending_hdr: Optional[FrameHeader] = None

        ptr = rom.root_first
        guard = 0
        max_steps = fsm_step_bound(rom, len(wire))
        while True:
            guard += 1
            if guard > max_steps:  # defensive: malformed wire must not hang
                raise _ProtocolError("DES FSM exceeded step bound")
            kind = int(rom.kind[ptr])
            if kind == KIND_END:
                self._cycles += 1
                break
            if kind == KIND_BYTES:
                n = int(rom.nbytes[ptr])
                val = int.from_bytes(self._read(n), "little")
                self._emit(TOK_DATA, value=val, tag=int(rom.tag[ptr]), path=rom.paths[ptr])
                ptr = self._advance(ptr)
            elif kind == KIND_ARRAY or (kind == KIND_LIST and self.direction == "sw2hw"):
                cnt = int.from_bytes(self._read(COUNT_BYTES), "little")
                tok = TOK_ARRAY_LENGTH if kind == KIND_ARRAY else TOK_LIST_BEGIN
                val = cnt if kind == KIND_ARRAY else 0  # list-begin carries no count
                self._emit(tok, value=val, tag=int(rom.tag_start[ptr]), path=rom.paths[ptr] + ".start")
                if cnt > 0:
                    self._push(ptr, cnt)
                    ptr = int(rom.child[ptr])
                else:
                    ptr = self._end_container_inline(ptr)
            else:  # framed List (hw2hw)
                self._emit(TOK_LIST_BEGIN, tag=int(rom.tag_start[ptr]), path=rom.paths[ptr] + ".start")
                hdr = self._take_header()
                want = self._n_list_ctx() + 1
                if hdr.list_level < want:
                    raise _ProtocolError(f"frame level {hdr.list_level}, expected >= {want}")
                if hdr.list_level > want:
                    # Frame belongs to a descendant list (the first element of
                    # this list begins with a nested list).  Paper: "keep
                    # traversing the schema tree until equality is reached".
                    self._pending_hdr = hdr
                    self._push(ptr, None)
                    ptr = int(rom.child[ptr])
                elif hdr.is_end_of_list:
                    ptr = self._end_container_inline(ptr)  # empty list
                else:
                    self._frame_left = hdr.size
                    self._frame_pad = payload_wire_bytes(hdr.size, self.phit_bytes) - hdr.size
                    self._push(ptr, None)
                    ptr = int(rom.child[ptr])

        return EngineResult(self._tokens, self._cycles, frames=self._frames)

    def _push(self, ptr: int, num: Optional[int]) -> None:
        rom = self.rom
        self._stack.append(
            Context(
                num=num,
                ctype=int(rom.kind[ptr]),
                child_ptr=int(rom.child[ptr]),
                next_ptr=NULL if int(rom.last[ptr]) else ptr + 1,
                emit_end=bool(int(rom.emit_end[ptr])),
                tag_end=int(rom.tag_end[ptr]),
                path_idx=ptr,
            )
        )

    def _emit_container_end(
        self, ctype: int, emit_end: bool, tag_end: int, path: str, count: int
    ) -> None:
        """End-of-container processing: one cycle, token iff emitted."""
        if ctype == KIND_LIST:
            self._emit(TOK_LIST_END, value=count, tag=tag_end, path=path + ".end")
        elif emit_end:
            self._emit(TOK_ARRAY_END, tag=tag_end, path=path + ".end")
        else:
            self._cycles += 1  # silent end-processing cycle

    def _end_container_inline(self, ptr: int) -> int:
        """Zero-element container: end it without having pushed a context."""
        rom = self.rom
        self._emit_container_end(
            int(rom.kind[ptr]),
            bool(int(rom.emit_end[ptr])),
            int(rom.tag_end[ptr]),
            rom.paths[ptr],
            count=0,
        )
        return self._advance(ptr)

    def _list_has_more_elements(self) -> bool:
        """Framed list at an element boundary: does another element follow?"""
        if self._frame_left > 0:
            return True
        hdr = self._take_header()
        lvl = self._n_list_ctx()
        if hdr.list_level == lvl and hdr.is_end_of_list:
            return False
        if hdr.list_level < lvl:
            raise _ProtocolError(f"frame level dropped to {hdr.list_level} < {lvl}")
        # Same-level data frame, or a deeper-level frame (next element begins
        # with a nested list; paper: "keep traversing the schema tree until
        # equality is reached").  Stash it; traversal will consume it.
        self._pending_hdr = hdr
        if hdr.list_level == lvl:
            self._frame_left = hdr.size
            self._frame_pad = payload_wire_bytes(hdr.size, self.phit_bytes) - hdr.size
            self._pending_hdr = None
            if hdr.is_end_of_list:  # pragma: no cover - caught above
                return False
        return True

    def _advance(self, ptr: int) -> int:
        """Find the next node after finishing `ptr` (paper's traversal rules)."""
        rom = self.rom
        while True:
            if not int(rom.last[ptr]):
                return ptr + 1
            if not self._stack:
                raise _ProtocolError("context stack underflow")
            top = self._stack[-1]
            top.done += 1
            if top.num is not None:
                top.num -= 1
                more = top.num > 0
            else:
                more = self._list_has_more_elements()
            if more:
                return top.child_ptr
            self._emit_container_end(
                top.ctype, top.emit_end, top.tag_end, rom.paths[top.path_idx], top.done
            )
            self._stack.pop()
            if top.next_ptr != NULL:
                return top.next_ptr
            ptr = top.path_idx  # cascade: container itself completed an element


# ---------------------------------------------------------------------------
# SER
# ---------------------------------------------------------------------------


class SerFSM:
    """Hardware serializer: SER-side token stream -> wire bytes + cycles."""

    def __init__(
        self,
        rom: SchemaROM,
        direction: str = "hw2hw",
        phit_bytes: int = DEFAULT_PHIT_BYTES,
        frame_phits: int = DEFAULT_FRAME_PHITS,
        frame_cycles: int = 2,
    ):
        if direction not in ("hw2sw", "hw2hw"):
            raise ValueError(f"bad SER direction {direction!r}")
        self.rom = rom
        self.direction = direction
        self.phit_bytes = phit_bytes
        self.frame_phits = frame_phits
        self.frame_cycles = frame_cycles

    # -- token input -----------------------------------------------------------

    def _next(self, expect: int) -> Token:
        if self._tpos >= len(self._toks):
            raise _ProtocolError(f"token underrun, expected kind {expect}")
        t = self._toks[self._tpos]
        if t.kind != expect:
            raise _ProtocolError(f"expected token kind {expect}, got {t!r}")
        self._tpos += 1
        self._cycles += 1  # one consumed token per cycle
        return t

    def _peek(self) -> Optional[Token]:
        return self._toks[self._tpos] if self._tpos < len(self._toks) else None

    # -- byte output -------------------------------------------------------------

    def _write(self, data: bytes) -> None:
        lvl = self._n_list_ctx()
        if self.direction == "hw2hw" and lvl >= 1:
            self._framer.write(data, lvl)
        else:
            self._out.extend(data)

    def _n_list_ctx(self) -> int:
        return sum(1 for c in self._stack if c.ctype == KIND_LIST)

    # -- main traversal ------------------------------------------------------------

    def run(self, tokens: List[Token]) -> EngineResult:
        rom = self.rom
        self._toks = tokens
        self._tpos = 0
        self._cycles = 0
        self._out = bytearray()
        self._stack: List[Context] = []
        self._framer = FrameWriter(
            self._out, self.frame_phits, self.phit_bytes, self.frame_cycles
        )

        ptr = rom.root_first
        guard = 0
        max_steps = fsm_step_bound(rom, len(tokens))
        while True:
            guard += 1
            if guard > max_steps:
                raise _ProtocolError("SER FSM exceeded step bound")
            kind = int(rom.kind[ptr])
            if kind == KIND_END:
                self._cycles += 1
                break
            if kind == KIND_BYTES:
                t = self._next(TOK_DATA)
                self._write(int(t.value).to_bytes(int(rom.nbytes[ptr]), "little"))
                ptr = self._advance(ptr)
            elif kind == KIND_ARRAY:
                t = self._next(TOK_ARRAY_LENGTH)
                cnt = int(t.value)
                if self.direction == "hw2hw":
                    self._write(cnt.to_bytes(COUNT_BYTES, "little"))
                if cnt > 0:
                    self._push(ptr, cnt)
                    ptr = int(rom.child[ptr])
                else:
                    if self.direction == "hw2sw":
                        self._write_trailing_count(0)
                    self._cycles += 1  # end-processing cycle
                    ptr = self._advance(ptr)
            else:  # KIND_LIST — no list-begin token on the SER side (§III-C2)
                lvl = self._n_list_ctx() + 1
                nxt = self._peek()
                if nxt is not None and nxt.kind == TOK_LIST_END and int(nxt.value) == lvl:
                    self._next(TOK_LIST_END)  # empty list
                    if self.direction == "hw2sw":
                        self._write_trailing_count(0)
                    else:
                        self._framer.end_list(lvl)
                    ptr = self._advance(ptr)
                else:
                    self._push(ptr, None)
                    ptr = int(rom.child[ptr])

        if self.direction == "hw2hw":
            self._framer.flush()
        self._cycles += self._framer.overhead_cycles
        if self._tpos != len(tokens):
            raise _ProtocolError(f"trailing tokens: {self._tpos} of {len(tokens)}")
        return EngineResult(
            list(tokens), self._cycles, wire=bytes(self._out), frames=self._framer.frames_emitted
        )

    def _write_trailing_count(self, cnt: int) -> None:
        """HW->SW: counts go AFTER the elements (paper §IV-B); costs a cycle."""
        self._out.extend(cnt.to_bytes(COUNT_BYTES, "little"))
        self._cycles += 1

    def _push(self, ptr: int, num: Optional[int]) -> None:
        rom = self.rom
        self._stack.append(
            Context(
                num=num,
                ctype=int(rom.kind[ptr]),
                child_ptr=int(rom.child[ptr]),
                next_ptr=NULL if int(rom.last[ptr]) else ptr + 1,
                emit_end=False,
                tag_end=-1,
                path_idx=ptr,
            )
        )

    def _advance(self, ptr: int) -> int:
        rom = self.rom
        while True:
            if not int(rom.last[ptr]):
                return ptr + 1
            if not self._stack:
                raise _ProtocolError("context stack underflow")
            top = self._stack[-1]
            top.done += 1
            if top.ctype == KIND_ARRAY:
                top.num -= 1
                if top.num > 0:
                    return top.child_ptr
                if self.direction == "hw2sw":
                    self._write_trailing_count(top.done)
                self._cycles += 1  # end-processing cycle
            else:  # List: decided by the next input token
                lvl = self._n_list_ctx()
                nxt = self._peek()
                if not (nxt is not None and nxt.kind == TOK_LIST_END and int(nxt.value) == lvl):
                    return top.child_ptr  # another element follows
                self._next(TOK_LIST_END)
                if self.direction == "hw2sw":
                    self._write_trailing_count(top.done)
                else:
                    self._framer.end_list(lvl)
            self._stack.pop()
            if top.next_ptr != NULL:
                return top.next_ptr
            ptr = top.path_idx
