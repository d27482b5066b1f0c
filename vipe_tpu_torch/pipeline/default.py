"""DefaultAnnotationPipeline (port of ``vipe_tpu/pipeline/default.py``):
intrinsics processor → SLAMSystem → artifacts.  A rig capture (a
``MultiviewVideoList``) runs one SLAM over all its views and writes each
view's artifacts under the view's own stream name, with the view's camera
trajectory ``c2w · rig[v]`` and its intrinsics.

``init.intrinsics`` is ``fov``, ``gt`` (the stream's own) or ``geocalib``
(calibrated from sampled frames of the raw stream, for ``init.camera_type``;
each view of a rig on its own stream); the keyframe depth prior of
``slam.keyframe_depth`` (``constant-<depth>`` or ``unidepth-<s|b|l>``) is
built by the depth factory on the pipeline's device.

``post.depth_align_model`` (``adaptive_<metric>[_<svda|vda>]``) adds the
post-SLAM depth stage: ``AdaptiveDepthProcessor`` runs on each view's
stream after SLAM and its metric depth goes to ``depth/<name>.zip`` (one
f16 EXR per frame), or to ``output.depths`` when no output path is
given.  The JAX package may run VDA-S beside SLAM (``post.overlap_vda``,
``init.overlap``); its result is the same, since VDA reads only the
frames, and the port runs it after SLAM whatever those keys say.

``init.instance: track_anything`` adds ``TrackAnythingProcessor`` after the
intrinsics processor: GroundingDINO on ``init.phrases``, SAM and DeAOT give
each frame its instance ids and the mask SLAM weighs by, and the ids go to
``mask/<name>.zip`` with the id → phrase lines in ``mask/<name>.txt``.  The
JAX package runs that init chain in a prefill thread ahead of SLAM
(``init.overlap``); the port runs it in line, with the same result.  A rig
with ``init.instance`` raises ``NotImplementedError``: the JAX package
gives all views one tracker (one frame counter, memory and id counter).
``output.save_viz`` writes ``vipe/<name>_vis.mp4`` (the panes of
``output.viz_attributes``).
"""

from __future__ import annotations

import dataclasses
import gc
import pathlib

import numpy as np
import torch

from ..ops import lie
from ..ops.cameras import CameraType
from ..slam.system import SLAMSystem
from ..streams.base import AssignAttributesProcessor, MultiviewVideoList, ProcessedVideoStream
from ..utils import io as io_utils
from ..utils import profiling
from ..utils.device import resolve_device
from . import AnnotationPipelineOutput, Pipeline
from .processors import AdaptiveDepthProcessor, GeoCalibIntrinsicsProcessor, \
    HeuristicIntrinsicsProcessor, TrackAnythingProcessor


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
        if intr_mode not in ("fov", "gt", "geocalib", None):
            raise NotImplementedError(f"init.intrinsics={intr_mode!r} is not ported yet")
        instance = self.init_cfg.get("instance")
        if instance not in ("track_anything", None):
            raise NotImplementedError(f"init.instance={instance!r} is not ported")

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

        return make_depth_model(kd, device=self.device)

    def _init_stream(self, video_stream):
        """The stream with the init processors, cached for SLAM's two passes
        and the artifact pass."""
        procs = []
        intr_mode = self.init_cfg.get("intrinsics", "fov")
        if intr_mode == "geocalib":
            procs.append(GeoCalibIntrinsicsProcessor(
                camera_type=self.init_cfg.get("camera_type", "pinhole"),
                sample_stream=video_stream, device=self.device))
        elif intr_mode in ("fov", None):
            procs.append(HeuristicIntrinsicsProcessor(self.init_cfg.get("fov_deg", 60.0)))
        if self.init_cfg.get("instance"):
            procs.append(TrackAnythingProcessor(self.init_cfg.get("phrases", []),
                                                device=self.device))
        return ProcessedVideoStream(video_stream, procs).cache(online=True, compress_rgb=True)

    def run(self, video_stream) -> AnnotationPipelineOutput:
        if isinstance(video_stream, MultiviewVideoList):
            return self._run_multiview(video_stream)
        camera_type = CameraType(self.slam_cfg.get("camera_type", "pinhole"))
        stream = self._init_stream(video_stream)

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

    def _run_multiview(self, video_list) -> AnnotationPipelineOutput:
        """One SLAM over the rig's views, then each view's artifacts.
        Returns view 0's output; the payload holds every view's."""
        V = len(video_list)
        if V == 1:
            return self.run(video_list[0])
        if self.init_cfg.get("instance"):
            raise NotImplementedError(
                "init.instance with a rig: the JAX package shares one tracker across the views")
        camera_type = CameraType(self.slam_cfg.get("camera_type", "pinhole"))
        streams = [self._init_stream(s) for s in video_list]
        slam = SLAMSystem(config=self.slam_cfg, device=self.device,
                          metric_depth=self._make_metric_depth())
        with profiling.stage("slam"):
            slam_out = slam.run(MultiviewVideoList(video_list.name(), streams, video_list.rig),
                                camera_type=camera_type)
        del slam
        gc.collect()
        traj = torch.as_tensor(slam_out.trajectory)
        outputs = []
        for v in range(V):
            view = dataclasses.replace(
                slam_out,
                trajectory=lie.se3_mul(traj, torch.as_tensor(slam_out.rig[v])).numpy(),
                intrinsics=slam_out.intrinsics[v],
            )
            outputs.append(self._post(streams[v], view, camera_type, video_list[v].fps()))
        if self.return_payload:
            outputs[0].payload = {"slam_output": slam_out, "view_outputs": outputs}
        return outputs[0]

    def _post(self, stream, slam_out, camera_type, fps):
        """One streaming pass that stamps poses/intrinsics (and the post
        depth) on the frames and writes the artifacts and the visualization
        (or keeps the rgb frames, depths and instance maps when no path)."""
        procs = [AssignAttributesProcessor(poses=slam_out.trajectory,
                                           intrinsics=slam_out.intrinsics)]
        depth_model = self.post_cfg.get("depth_align_model")
        if depth_model:
            procs.append(AdaptiveDepthProcessor(depth_model, slam_output=slam_out,
                                                device=self.device))
        out_stream = ProcessedVideoStream(stream, procs)
        root = self.output_cfg.get("path")
        art = io_utils.ArtifactPath(pathlib.Path(root), stream.name()) if root is not None else None
        writer = io_utils.StreamingArtifactWriter(art, fps=fps) if art is not None else None
        viz = None
        if art is not None and self.output_cfg.get("save_viz", False):
            from ..utils import visualization

            viz = visualization.VideoWriter(art.vis_path, fps)
            viz_attrs = self.output_cfg.get("viz_attributes", ["rgb", "depth"])
        rgbs = [] if art is None else None
        depths = [] if art is None and depth_model else None
        masks = [] if art is None else None
        instance_phrases: dict = {}
        any_instance = False
        n_frames = 0
        for f in out_stream:
            any_instance |= f.instance is not None
            instance_phrases.update(f.instance_phrases or {})
            if writer is not None:
                with profiling.stage("artifact_write"):
                    writer.add_frame(rgb=f.rgb, depth=f.metric_depth, instance=f.instance)
            else:
                rgbs.append(f.rgb)
                masks.append(f.instance)
                if depths is not None:
                    depths.append(f.metric_depth)
            if viz is not None:
                with profiling.stage("viz_write"):
                    viz.write(visualization.render_projection_frame(f, n_frames, slam_out,
                                                                    viz_attrs))
            n_frames += 1

        output = AnnotationPipelineOutput(
            trajectory=slam_out.trajectory, intrinsics=slam_out.intrinsics,
            camera_type=camera_type.value, frame_inds=np.arange(n_frames), fps=fps,
            ba_residual=slam_out.ba_residual, slam_map=slam_out.slam_map,
        )
        phrases = instance_phrases or self.init_cfg.get("phrases", [])
        if any_instance:
            output.mask_phrases = phrases
        if rgbs is not None:
            output.rgb_frames = iter(rgbs)
            if any_instance:
                output.instance_masks = iter(
                    m if m is not None else np.zeros(r.shape[:2], np.uint8)
                    for m, r in zip(masks, rgbs))
        if depths is not None:
            output.depths = iter(depths)
        if writer is not None:
            writer.close(phrases=phrases if writer.wrote_mask else None)
            io_utils.save_poses(art, output.trajectory, output.frame_inds)
            io_utils.save_intrinsics(art, output.intrinsics, output.camera_type,
                                     n_frames=n_frames)
            io_utils.save_info(art, {"ba_residual": output.ba_residual})
        if viz is not None:
            viz.close()
        return output
