"""Device selection for the port's entry points.

The port runs on the card.  ``default_device`` resolves ``device=None`` to
``cuda`` and raises when CUDA is absent: there is no silent CPU fallback.
The CPU is used only when a caller asks for it by name (the tests pass
``device="cpu"``).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoCudaError(RuntimeError):
    """Raised when an entry point defaults to the card and none is present."""


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises :class:`NoCudaError` if ``None`` (or a CUDA device) is asked for
    and ``torch.cuda.is_available()`` is false.  Pass ``device="cpu"`` to
    run on the host explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaError(
            "repro_torch entry points run on a CUDA device by default and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "on the host"
        )
    return dev
