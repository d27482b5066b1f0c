"""DefaultAnnotationPipeline (port of ``vipe_tpu/pipeline/default.py``,
single view): intrinsics processor → SLAMSystem → artifacts.

``init.intrinsics`` is ``fov`` or ``gt`` (the stream's own); the keyframe
depth prior of ``slam.keyframe_depth`` is built by the depth factory, which
holds the ``constant-<depth>`` prior so far.  The learned priors (GeoCalib,
depth alignment, TrackAnything instances) are not ported yet; asking for
one raises ``NotImplementedError``.
"""

from __future__ import annotations

import gc
import pathlib

import numpy as np

from ..ops.cameras import CameraType
from ..slam.system import SLAMSystem
from ..streams.base import AssignAttributesProcessor, ProcessedVideoStream
from ..utils import io as io_utils
from ..utils import profiling
from ..utils.device import resolve_device
from . import AnnotationPipelineOutput, Pipeline
from .processors import HeuristicIntrinsicsProcessor


class DefaultAnnotationPipeline(Pipeline):
    def __init__(self, init=None, slam=None, post=None, output=None,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.init_cfg = dict(init or {})
        self.slam_cfg = dict(slam or {})
        self.post_cfg = dict(post or {})
        self.output_cfg = dict(output or {})
        self.device = resolve_device(device)
        intr_mode = self.init_cfg.get("intrinsics", "fov")
        if intr_mode not in ("fov", "gt", None):
            raise NotImplementedError(f"init.intrinsics={intr_mode!r} is not ported yet")
        for section, key in (("init", "instance"), ("post", "depth_align_model")):
            if getattr(self, f"{section}_cfg").get(key):
                raise NotImplementedError(f"{section}.{key} is not ported yet")
        if self.output_cfg.get("save_viz", False):
            raise NotImplementedError("output.save_viz is not ported yet")

    def should_filter(self, stream_name: str) -> bool:
        root = self.output_cfg.get("path")
        if not self.output_cfg.get("skip_exists", False) or root is None:
            return False
        return io_utils.ArtifactPath(root, stream_name).exists()

    def _make_metric_depth(self):
        kd = self.slam_cfg.get("keyframe_depth")
        if not kd:
            return None
        from ..priors.depth.factory import make_depth_model

        return make_depth_model(kd)

    def run(self, video_stream) -> AnnotationPipelineOutput:
        if isinstance(video_stream, (list, tuple)):
            raise NotImplementedError("multiview rigs are not ported yet")
        camera_type = CameraType(self.slam_cfg.get("camera_type", "pinhole"))
        procs = []
        if self.init_cfg.get("intrinsics", "fov") in ("fov", None):
            procs.append(HeuristicIntrinsicsProcessor(self.init_cfg.get("fov_deg", 60.0)))
        stream = ProcessedVideoStream(video_stream, procs).cache(online=True, compress_rgb=True)

        slam = SLAMSystem(config=self.slam_cfg, device=self.device,
                          metric_depth=self._make_metric_depth())
        with profiling.stage("slam"):
            slam_out = slam.run(stream, camera_type=camera_type)
        del slam
        gc.collect()
        output = self._post(stream, slam_out, camera_type, video_stream.fps())
        if self.return_payload:
            output.payload = {"slam_output": slam_out}
        return output

    def _post(self, stream, slam_out, camera_type, fps):
        """One streaming pass that stamps poses/intrinsics on the frames and
        writes the artifacts (or keeps the rgb frames when no path)."""
        out_stream = ProcessedVideoStream(stream, [
            AssignAttributesProcessor(poses=slam_out.trajectory,
                                      intrinsics=slam_out.intrinsics)
        ])
        root = self.output_cfg.get("path")
        art = io_utils.ArtifactPath(pathlib.Path(root), stream.name()) if root is not None else None
        writer = io_utils.StreamingArtifactWriter(art, fps=fps) if art is not None else None
        rgbs = [] if art is None else None
        n_frames = 0
        for f in out_stream:
            if writer is not None:
                with profiling.stage("artifact_write"):
                    writer.add_frame(rgb=f.rgb)
            else:
                rgbs.append(f.rgb)
            n_frames += 1

        output = AnnotationPipelineOutput(
            trajectory=slam_out.trajectory, intrinsics=slam_out.intrinsics,
            camera_type=camera_type.value, frame_inds=np.arange(n_frames), fps=fps,
            ba_residual=slam_out.ba_residual, slam_map=slam_out.slam_map,
        )
        if rgbs is not None:
            output.rgb_frames = iter(rgbs)
        if writer is not None:
            writer.close()
            io_utils.save_poses(art, output.trajectory, output.frame_inds)
            io_utils.save_intrinsics(art, output.intrinsics, output.camera_type,
                                     n_frames=n_frames)
            io_utils.save_info(art, {"ba_residual": output.ba_residual})
        return output
