"""Hand-written CUDA kernels of the port and their public wrappers.

``phit_unpack`` holds the DES payload kernels (CUDA C++ for ``sm_90a`` in
``csrc/phit_unpack.cu``) and ``frame_pack`` the routed fabric's frame
assembly and RX split and the streaming plane's fragment assembly
(``csrc/frame_pack.cu``), each kernel beside its plain PyTorch version;
``ops`` holds the public wrappers (``decode_batch_kernel``,
``encode_frames_batch``, ``encode_chunks_batch``, ...).  Importing
this package builds nothing: a kernel is built on its first launch.
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
    runs_from_plan,
    wire_to_u32,
    wires_to_u32,
)
from .frame_pack import pack_chunks_batch, pack_frames_batch, unpack_frames_batch
from .phit_unpack import (
    LAUNCHES,
    reset_launches,
    unpack_gather,
    unpack_run,
    unpack_run_aligned,
    unpack_run_general,
)
