"""The one device rule of the package: ``device=None`` means the CUDA
device, and a missing CUDA device is an error — the CPU is used only when
the caller names it."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    Args:
        device: ``None`` (the CUDA device), a device string, or a
            ``torch.device``.

    Returns:
        The ``torch.device`` to place tensors on; a CUDA device always
        carries its index (``"cuda"`` becomes the current CUDA device).

    Raises:
        RuntimeError: a CUDA device was asked for (explicitly or by
            ``None``) and ``torch.cuda.is_available()`` is false.  There
            is no silent fall-back to the CPU; pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host explicitly")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so the result compares equal to ``tensor.device``
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
