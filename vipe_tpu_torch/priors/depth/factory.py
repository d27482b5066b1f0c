"""Depth-model factory (port of ``vipe_tpu/priors/depth/factory.py``).

Names follow ``"<family>-<variant>"``: ``constant-<depth>``,
``unidepth-<s|b|l>``, ``dav2-<vits|vitb|vitl>``,
``vda-<vits|vitl>`` (or ``videodepthanything-…``),
``metric3d-<small|large>`` and ``priorda[-<vits|vitb|vitl>]``.  A learned
model is built once per process and device (``models/model_cache.py``): a
fresh pipeline per video does not load a ViT-L again.
"""

from __future__ import annotations

from .base import ConstantDepthModel, DepthEstimationModel


def _learned(family: str):
    if family == "unidepth":
        from .unidepth import UniDepthModel

        return UniDepthModel, "l"
    if family == "dav2":
        from .dav2 import DepthAnythingV2Model

        return DepthAnythingV2Model, "vitl"
    if family in ("vda", "videodepthanything"):
        from .videodepthanything import VideoDepthAnythingModel

        return VideoDepthAnythingModel, "vitl"
    if family == "metric3d":
        from .metric3d import Metric3DModel

        return Metric3DModel, "small"
    if family == "priorda":
        from .priorda import PriorDAModel

        return PriorDAModel, "vitb"
    return None, None


def make_depth_model(name: str, device=None) -> DepthEstimationModel:
    """``device``: where a learned model runs (None: the card)."""
    family, _, variant = name.partition("-")
    if family == "constant":
        return ConstantDepthModel(float(variant) if variant else 2.0)
    cls, default = _learned(family)
    if cls is not None:
        from ...models.model_cache import cached_global
        from ...utils.device import resolve_device

        dev = resolve_device(device)
        return cached_global(("depth_model", cls, name, str(dev)),
                             lambda: cls(variant or default, device=dev))
    raise ValueError(f"Unknown depth model family: {family!r} (from {name!r})")
