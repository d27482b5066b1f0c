"""Depth-model factory (port of ``vipe_tpu/priors/depth/factory.py``).

Names follow ``"<family>-<variant>"``.  Ported: ``constant-<depth>`` and
``unidepth-<s|b|l>``; the other learned families raise
``NotImplementedError`` until the slice that ports them.  A learned model
is built once per process and device (``models/model_cache.py``): a fresh
pipeline per video does not load a ViT-L again.
"""

from __future__ import annotations

from .base import ConstantDepthModel, DepthEstimationModel

_LATER = ("metric3d", "priorda", "dav2", "vda", "videodepthanything")


def make_depth_model(name: str, device=None) -> DepthEstimationModel:
    """``device``: where a learned model runs (None: the card)."""
    family, _, variant = name.partition("-")
    if family == "constant":
        return ConstantDepthModel(float(variant) if variant else 2.0)
    if family == "unidepth":
        from ...models.model_cache import cached_global
        from ...utils.device import resolve_device
        from .unidepth import UniDepthModel

        dev = resolve_device(device)
        return cached_global(("depth_model", UniDepthModel, name, str(dev)),
                             lambda: UniDepthModel(variant or "l", device=dev))
    if family in _LATER:
        raise NotImplementedError(
            f"depth model {name!r}: the {family} prior is not ported yet "
            "(ROADMAP.md, queue 1: the priors slice)")
    raise ValueError(f"Unknown depth model family: {family!r} (from {name!r})")
