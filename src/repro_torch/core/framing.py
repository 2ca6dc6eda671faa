"""HW-to-HW framing protocol (paper §IV-C).

Neither side of a HW-to-HW link can buffer a whole List, so serialized list
data is cut into *frames*: a bounded buffer's worth of payload prefixed by a
header carrying ``(size, ListLevel)``.  Protocol rules (verbatim from the
paper):

* an **empty frame** (header only) always represents the **end of a list** —
  the SER logic sends at least one frame per list (the terminator);
* all payload bytes of one frame sit at **one** list-nesting level
  (``ListLevel``), so the DES logic can unambiguously resync its schema-tree
  traversal from the header alone;
* data outside any List flows unframed (raw phits).

Wire format choices (implementation-defined, documented here):
  header = ``size:u32le | list_level:u32le`` padded to a whole number of
  phits; payload padded to a whole number of phits; raw->frame transitions
  are phit-aligned.  ``size`` is the true payload byte count (pre-padding).
"""
from __future__ import annotations

from dataclasses import dataclass

HEADER_BYTES = 8

#: paper §V: "the maximum size of a frame in the HW-to-HW SER logic is set to
#: 500-phit large"; block RAMs on Altera parts are 512 deep (§IV-C).
DEFAULT_FRAME_PHITS = 500
DEFAULT_PHIT_BYTES = 16  # paper §V: 128-bit phits


@dataclass(frozen=True)
class FrameHeader:
    size: int  # payload bytes (0 == end-of-list terminator)
    list_level: int

    def pack(self, phit_bytes: int) -> bytes:
        raw = self.size.to_bytes(4, "little") + self.list_level.to_bytes(4, "little")
        return _pad_to_phit(raw, phit_bytes)

    @staticmethod
    def unpack(buf: bytes, pos: int, phit_bytes: int) -> tuple["FrameHeader", int]:
        size = int.from_bytes(buf[pos : pos + 4], "little")
        level = int.from_bytes(buf[pos + 4 : pos + 8], "little")
        pos += header_wire_bytes(phit_bytes)
        return FrameHeader(size, level), pos

    @property
    def is_end_of_list(self) -> bool:
        return self.size == 0


def header_wire_bytes(phit_bytes: int) -> int:
    return _round_up(HEADER_BYTES, phit_bytes)


def payload_wire_bytes(size: int, phit_bytes: int) -> int:
    return _round_up(size, phit_bytes)


def _round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _pad_to_phit(raw: bytes, phit_bytes: int) -> bytes:
    return raw + b"\0" * (_round_up(len(raw), phit_bytes) - len(raw))


class FrameWriter:
    """SER-side bounded frame buffer: 'a FIFO with an additional write port to
    set the frame header' (§IV-C).  Collects payload at one list level, emits
    wire bytes on flush.  Tracks the cycle overhead per frame."""

    def __init__(self, out: bytearray, frame_phits: int, phit_bytes: int,
                 cycles_per_frame: int = 2):
        self.out = out
        self.max_payload = frame_phits * phit_bytes
        self.phit_bytes = phit_bytes
        self.cycles_per_frame = cycles_per_frame
        self.buf = bytearray()
        self.level = 0
        self.frames_emitted = 0
        self.overhead_cycles = 0

    def _align_out(self) -> None:
        pad = (-len(self.out)) % self.phit_bytes
        self.out.extend(b"\0" * pad)

    def write(self, data: bytes, level: int) -> None:
        assert level >= 1, "frames only carry in-list data"
        if self.buf and self.level != level:
            self.flush()
        self.level = level
        off = 0
        while off < len(data):
            room = self.max_payload - len(self.buf)
            take = min(room, len(data) - off)
            self.buf.extend(data[off : off + take])
            off += take
            if len(self.buf) == self.max_payload:
                self.flush()
                self.level = level
        # re-arm level for a lazily started next frame
        self.level = level

    def flush(self) -> None:
        """Emit the current (non-empty) frame."""
        if not self.buf:
            return
        self._align_out()
        self.out.extend(FrameHeader(len(self.buf), self.level).pack(self.phit_bytes))
        self.out.extend(_pad_to_phit(bytes(self.buf), self.phit_bytes))
        self.buf.clear()
        self.frames_emitted += 1
        self.overhead_cycles += self.cycles_per_frame

    def end_list(self, level: int) -> None:
        """Flush pending payload, then emit the empty end-of-list frame."""
        self.flush()
        self._align_out()
        self.out.extend(FrameHeader(0, level).pack(self.phit_bytes))
        self.frames_emitted += 1
        self.overhead_cycles += self.cycles_per_frame
