"""repro_torch — the HGum message plane on PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``, with the same module
layout and public names, so each function has a counterpart one path away
(``repro.core.vectorized`` -> ``repro_torch.core.vectorized``).  It imports
``torch`` and numpy only, never JAX and nothing of ``repro``: the host
modules that use no framework are carried over by copy.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); see :func:`repro_torch.device.default_device`.
"""
