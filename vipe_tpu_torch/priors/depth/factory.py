"""Depth-model factory (port of ``vipe_tpu/priors/depth/factory.py``).

Names follow ``"<family>-<variant>"``.  Only ``constant-<depth>`` is ported;
the learned families raise ``NotImplementedError`` until the slice that
ports them.
"""

from __future__ import annotations

from .base import ConstantDepthModel, DepthEstimationModel

_LATER = ("unidepth", "metric3d", "priorda", "dav2", "vda", "videodepthanything")


def make_depth_model(name: str) -> DepthEstimationModel:
    family, _, variant = name.partition("-")
    if family == "constant":
        return ConstantDepthModel(float(variant) if variant else 2.0)
    if family in _LATER:
        raise NotImplementedError(
            f"depth model {name!r}: the {family} prior is not ported yet "
            "(ROADMAP.md, queue 1: the priors slice)")
    raise ValueError(f"Unknown depth model family: {family!r} (from {name!r})")
