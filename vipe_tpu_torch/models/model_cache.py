"""Process-level prior-model cache (port of ``vipe_tpu/models/model_cache.py``).

A batch run builds a fresh pipeline per video; the learned priors it
builds are kept here so that one process pays for their construction (and
weight loading) once.

* ``cached_global``: stateless models (GeoCalib, the depth nets), shared by
  every video and thread of the process.
* ``cached_thread``: stateful engines, one instance per thread, reused by
  that thread's videos in turn; callers reset per-video state on reuse.

Keys should include the class (tests swap small variants in) and the
device.
"""

from __future__ import annotations

import threading
from typing import Callable, Hashable

_global: dict = {}
_global_lock = threading.Lock()
_tls = threading.local()


def cached_global(key: Hashable, builder: Callable):
    with _global_lock:
        if key not in _global:
            _global[key] = builder()
        return _global[key]


def cached_thread(key: Hashable, builder: Callable):
    d = getattr(_tls, "d", None)
    if d is None:
        d = _tls.d = {}
    if key not in d:
        d[key] = builder()
    return d[key]


def clear():
    """Drop every cached model (global, and this thread's)."""
    with _global_lock:
        _global.clear()
    if getattr(_tls, "d", None) is not None:
        _tls.d.clear()
