"""TrackAnything: open-vocabulary instance masks over a video (port of
``vipe_tpu/priors/track_anything/__init__.py``).

Frame 0 and every ``sam_gap``-th frame run GroundingDINO on the phrases and
SAM on its boxes; objects found anew are merged into the tracked map and
the frame becomes a DeAOT reference; DeAOT propagates the map in between.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...utils import profiling
from .sam import SamPredictor


class SegTracker:
    """Detection, segmentation and the merge of new objects."""

    def __init__(self, detector, segmentor: SamPredictor, min_area: int = 200):
        self.detector = detector
        self.segmentor = segmentor
        self.min_area = min_area
        self.curr_idx = 0  # the last object id given

    def detect_and_seg(self, rgb: np.ndarray, phrases: List[str]):
        """Boxes of the phrases, a mask per box, one first-wins instance map
        of the masks that reach ``min_area`` (new ids from ``curr_idx + 1``).
        Returns (instance, {id: phrase})."""
        boxes, names = self.detector.run_grounding(rgb, phrases, return_phrases=True)
        self.segmentor.set_image(rgb)
        instance, ids = self.segmentor.segment_composite(boxes, self.min_area, self.curr_idx + 1)
        id2phrase = {}
        for oid, name in zip(ids, names):
            if oid > 0:
                id2phrase[int(oid)] = name
                self.curr_idx = max(self.curr_idx, int(oid))
        return instance, id2phrase

    def merge_new_objects(self, instance: np.ndarray, tracked: np.ndarray,
                          min_new_obj_iou: float = 0.8) -> np.ndarray:
        """The tracked map plus each detection of which at least
        ``min_new_obj_iou`` lies on untracked pixels and at least
        ``min_area`` pixels are new; none of them when their new pixels
        together pass 40 % of the frame (a detection glitch)."""
        new_mask = np.where(tracked == 0, instance, 0)
        out = tracked.copy()
        n_ids = int(max(new_mask.max(), instance.max())) + 1
        new_areas = np.bincount(new_mask.ravel(), minlength=n_ids)
        obj_areas = np.bincount(instance.ravel(), minlength=n_ids)
        ok = (new_areas / np.maximum(obj_areas, 1) >= min_new_obj_iou) & \
            (new_areas >= self.min_area)
        ok[0] = False
        added = ok[new_mask]
        if added.sum() > 0.4 * tracked.size:
            return out
        out[added] = new_mask[added]
        return out


class TrackAnythingPipeline:
    """Per-frame instance maps for a phrase list, on one device.
    ``detector``, ``tracker`` and ``segmentor`` default to the published
    nets (zoo weights, else seeded)."""

    def __init__(self, phrases: List[str], sam_gap: int = 20, detector=None, tracker=None,
                 segmentor=None, sam_variant: str = "vit_b", device=None):
        if detector is None:
            from .gdino import GroundingDINODetector

            detector = GroundingDINODetector(device=device)
        if tracker is None:
            from .deaot import DeAOTTracker

            tracker = DeAOTTracker(device=device)
        if segmentor is None:
            segmentor = SamPredictor(sam_variant, device=device)
        # "sky" is detected like any other phrase; its ids reach
        # instance_phrases, from which VideoFrame.sky_mask is made
        self.phrases = list(phrases)
        self.seg_tracker = SegTracker(detector, segmentor)
        self.sam_gap = sam_gap
        self.tracker = tracker
        self._frame_count = 0
        self.instance_phrase: dict = {}

    def reset(self):
        """Clear the per-video state (frame counter, id → phrase map, object
        ids, tracker memory)."""
        self._frame_count = 0
        self.instance_phrase = {}
        self.seg_tracker.curr_idx = 0
        self.tracker.restart()

    def track(self, frame_idx: int, rgb: np.ndarray):
        """(instance (H, W) int32, {id: phrase} of the ids present)."""
        rgb = np.asarray(rgb)
        if self._frame_count % self.sam_gap == 0:
            with profiling.stage("ta_detect"):
                detected, id2phrase = self.seg_tracker.detect_and_seg(rgb, self.phrases)
                self.instance_phrase.update(id2phrase)
                if self._frame_count == 0:
                    instance = detected
                else:
                    # a detection frame tracks without a memory update
                    tracked = self.tracker.propagate(rgb, update_memory=False)
                    instance = self.seg_tracker.merge_new_objects(detected, tracked)
                self.tracker.add_reference(rgb, instance)
        else:
            with profiling.stage("ta_propagate"):
                instance = self.tracker.propagate(rgb)
        self._frame_count += 1
        present = {int(k): self.instance_phrase.get(int(k), "")
                   for k in np.unique(instance) if k != 0}
        return instance, present
