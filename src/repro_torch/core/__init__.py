"""repro_torch.core — HGum schema-driven SER/DES, host side plus torch payload pass.

``idl``, ``schema_tree``, ``tokens``, ``framing``, ``fsm`` and
``sw_serdes`` use no framework and are copies of the reference modules of
the same names.  ``vectorized`` keeps the numpy structure passes and writes
the payload pass in torch.  ``stream_plans`` is a copy whose burst encoder
packs on the card (the B7 kernel).  Same public names as ``repro.core``.
"""
from .idl import (
    Array,
    Bytes,
    ClientSchema,
    ListT,
    Schema,
    SchemaError,
    StreamT,
    StructRef,
    all_token_paths,
)
from .schema_tree import (
    COUNT_BYTES,
    KIND_ARRAY,
    KIND_BYTES,
    KIND_END,
    KIND_LIST,
    KIND_STREAM,
    STREAM_META_WORDS,
    SchemaROM,
    build_rom,
    build_tree,
    tree_depth,
)
from .stream_plans import (
    Fragment,
    StreamPlan,
    decode_fragments,
    encode_fragment,
    encode_fragment_burst,
    stream_plans,
)
from .tokens import (
    TOK_ARRAY_END,
    TOK_ARRAY_LENGTH,
    TOK_DATA,
    TOK_LIST_BEGIN,
    TOK_LIST_END,
    Token,
    strip_for_ser,
)
from .sw_serdes import (
    des_hw_to_sw,
    des_sw_oracle,
    msg_to_des_tokens,
    random_message,
    ser_hw_to_sw_reference,
    ser_sw_to_hw,
    tokens_to_msg,
)
from .fsm import DesFSM, EngineResult, SerFSM
from .framing import (
    DEFAULT_FRAME_PHITS,
    DEFAULT_PHIT_BYTES,
    FrameHeader,
    FrameWriter,
)
from .vectorized import (
    BatchedDecodePlan,
    DecodePlan,
    batch_plans,
    build_plan,
    decode_batch,
    decode_leaf,
    decode_message,
    encode_leaf,
    encode_message,
    lanes_to_int,
    lanes_u32,
    plan_from_wire,
    stack_wires,
    wire_to_u8,
)

__all__ = [n for n in dir() if not n.startswith("_")]
