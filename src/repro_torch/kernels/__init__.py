"""Hand-written CUDA kernels of the port and their public wrappers.

``phit_unpack`` holds the DES payload kernels (CUDA C++ for ``sm_90a`` in
``csrc/phit_unpack.cu``, each beside its plain PyTorch version); ``ops``
holds the plan-driven wrappers (``decode_batch_kernel``, ...).  Importing
this package builds nothing: a kernel is built on its first launch.
"""
from .ops import (
    batched_runs_from_plan,
    decode_batch_kernel,
    decode_gather,
    decode_message_kernel,
    decode_run,
    runs_from_plan,
    wire_to_u32,
    wires_to_u32,
)
from .phit_unpack import (
    LAUNCHES,
    reset_launches,
    unpack_gather,
    unpack_run,
    unpack_run_aligned,
    unpack_run_general,
)
