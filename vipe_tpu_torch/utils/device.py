"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a missing
card is an error, never a silent fallback."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def true_f32():
    """Matmuls and cuDNN convolutions inside run in IEEE f32, not TF32,
    whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
