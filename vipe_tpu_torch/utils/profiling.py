"""Global wall-clock stage accumulator for the annotation pipeline (a copy
of ``vipe_tpu/utils/profiling.py``).  Accumulators are process-global and
cheap (two ``perf_counter`` calls per stage entry), so they are always on.
"""

from __future__ import annotations

import collections
import contextlib
import time

_acc: dict = collections.defaultdict(float)
_cnt: dict = collections.defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1


def add(name: str, seconds: float):
    _acc[name] += seconds
    _cnt[name] += 1


def snapshot(reset: bool = False) -> dict:
    """{stage: {"s": total_seconds, "n": calls}} sorted by total time."""
    out = {
        k: {"s": round(_acc[k], 3), "n": _cnt[k]}
        for k in sorted(_acc, key=_acc.get, reverse=True)
    }
    if reset:
        _acc.clear()
        _cnt.clear()
    return out
