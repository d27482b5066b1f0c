"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a missing
card is an error, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when CUDA is asked for (explicitly
    or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu on the "
            "CLI) to run on the CPU"
        )
    return dev
