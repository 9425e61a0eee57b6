"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); anything else is taken as given.

    Asking for CUDA where no card is visible raises: nothing drops quietly
    to the CPU, because a CPU run of the port says nothing about the card.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the port on the CPU"
        )
    return dev
