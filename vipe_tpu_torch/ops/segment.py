"""Deterministic segment sum.

``Tensor.index_add_`` on a CUDA tensor adds rows with atomics, so the order
of the additions, and with it the float result, changes from run to run.
``segment_sum`` stable-sorts the indices and reduces each contiguous segment
in order, with no atomics and no host synchronisation: the same inputs give
the same bits on every run.  On the CPU the rows of a segment are added in
their original order, starting from zero, as ``index_add_`` adds them, so
the result is bit-equal to ``torch.zeros(n, ...).index_add_(0, idx, x)``.
"""

from __future__ import annotations

import torch


def segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of the rows of ``x`` (E, ...) that share an index of ``idx`` (E,),
    into ``n`` rows; rows whose index appears nowhere are zero.  ``idx`` must
    lie in ``[0, n)``."""
    order = torch.argsort(idx, stable=True)
    bounds = torch.arange(n + 1, dtype=idx.dtype, device=idx.device)
    offsets = torch.searchsorted(idx[order], bounds)
    return torch.segment_reduce(x[order], "sum", offsets=offsets, unsafe=True)
