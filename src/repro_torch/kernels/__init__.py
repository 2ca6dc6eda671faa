"""Hand-written CUDA kernels of the port and their public wrappers.

``phit_unpack`` holds the DES payload kernels (CUDA C++ for ``sm_90a`` in
``csrc/phit_unpack.cu``) and ``frame_pack`` the SER payload run, the header
stamp, the routed fabric's frame assembly and RX split and the streaming
plane's fragment assembly (``csrc/frame_pack.cu``), each kernel beside its
plain PyTorch version; ``framing`` the fabric's frame format and its
structure pass in plain torch (with the join, ``frame_batch``'s plain
version); ``ops`` holds the public wrappers
(``decode_batch_kernel``, ``encode_run``, ``write_headers``,
``encode_frames_batch``, ``encode_chunks_batch``, ...);
``decode_attention`` the decode step's append-and-attend
(``csrc/decode_attention.cu``, beside its plain version and the plain
``decode_attention``), which ``models.attention.attn_decode`` calls, and
``prefill_attention`` the prefill's attention
(``csrc/prefill_attention.cu``, beside its plain version
``flash_attention`` and ``softcap``), which ``attn_forward`` and
``cross_attn_forward`` call; ``models.common`` re-exports the plain
functions, and neither kernel replaces a TPU kernel.
Importing this package builds nothing: a kernel is built on its first
launch.
"""
from .ops import (
    batched_runs_from_plan,
    decode_batch_kernel,
    decode_frames_batch,
    decode_gather,
    decode_message_kernel,
    decode_run,
    encode_chunks_batch,
    encode_frames_batch,
    encode_run,
    runs_from_plan,
    wire_to_u32,
    wires_to_u32,
    write_headers,
)
from .frame_pack import (
    pack_chunks_batch,
    pack_frames_batch,
    pack_run,
    stamp_headers,
    unpack_frames_batch,
)
from .phit_unpack import (
    LAUNCHES,
    reset_launches,
    unpack_gather,
    unpack_run,
    unpack_run_aligned,
    unpack_run_general,
)
