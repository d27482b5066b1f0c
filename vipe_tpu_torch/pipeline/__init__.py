"""Pipeline orchestration (port of ``vipe_tpu/pipeline/__init__.py``):
``Pipeline.run(video_stream) -> AnnotationPipelineOutput`` and the dotted
``instance:`` factory ``make_pipeline``."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class AnnotationPipelineOutput:
    trajectory: Optional[np.ndarray] = None        # (T, 7) c2w SE3
    intrinsics: Optional[np.ndarray] = None        # (D,) full-res
    camera_type: str = "pinhole"
    depths: Optional[Iterator[np.ndarray]] = None
    instance_masks: Optional[Iterator[np.ndarray]] = None
    mask_phrases: Optional[object] = None
    rgb_frames: Optional[Iterator[np.ndarray]] = None
    frame_inds: Optional[np.ndarray] = None
    fps: float = 30.0
    ba_residual: float = 0.0
    slam_map: Optional[object] = None
    payload: Optional[dict] = None


class Pipeline:
    def __init__(self, **kwargs):
        self.return_payload = kwargs.get("return_payload", False)

    def run(self, video_stream) -> AnnotationPipelineOutput:
        raise NotImplementedError

    def should_filter(self, stream_name: str) -> bool:
        """Skip already-processed videos."""
        return False


def make_pipeline(config: dict, **kwargs) -> Pipeline:
    """Instantiate the pipeline class named by ``config["instance"]``;
    ``kwargs`` (e.g. ``device``) are passed through."""
    module, cls = config["instance"].rsplit(".", 1)
    klass = getattr(importlib.import_module(module), cls)
    return klass(**{k: v for k, v in config.items() if k != "instance"}, **kwargs)
