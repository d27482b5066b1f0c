"""Keyframe motion filter (port of ``vipe_tpu/slam/motion_filter.py``, the
synchronous ``check`` path).

Every frame is encoded; one ConvGRU update against the last keyframe's
features gives a flow delta whose mean magnitude gates keyframe creation.
A rig's frame is its (V, h, w, 3) stack of views, scored view by view
against the same views of the keyframe; the least of the V scores gates.
With sparse tracks, a frame is also a keyframe when its keypoints moved
more than twice the threshold on average since the last keyframe, or when
more than a fifth of the tracks vanished since the previous frame scored.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import corr as corr_ops
from ..ops import geom


@dataclasses.dataclass
class _Token:
    image: torch.Tensor            # (V, h, w, 3) uint8
    fmap: torch.Tensor             # (V, ht, wd, 128)
    mask: Optional[torch.Tensor]   # (V, ht, wd) bool, True = invalid
    frame_idx: int = 0             # submissions before this one
    first: bool = False


class MotionFilter:
    def __init__(self, encode_features: Callable, encode_context: Callable,
                 update_fn: Callable, thresh: float, sparse_tracks=None):
        """``encode_*(images_nhwc)``; ``update_fn`` as in ``FactorGraph``;
        ``sparse_tracks``: a ``SparseTracks`` whose keypoint flow joins the
        decision, or None."""
        self.encode_features = encode_features
        self.encode_context = encode_context
        self.update_fn = update_fn
        self.thresh = thresh
        self.sparse_tracks = sparse_tracks
        self.n_submitted = 0
        self.last_kf_frame_idx = 0
        self.last_n_sparse_tracks = 0
        self.initialized = False
        self.stacked = False  # rig frames: keep the V axis of the features
        self.f_fmap = self.f_net = self.f_inp = self.f_mask = None

    @property
    def _decision_fixed(self):
        """True/False when the threshold makes every decision constant
        (negative: every frame; +inf: none) — the score is then skipped."""
        if self.thresh == float("inf"):
            return False
        if self.thresh < 0:
            return True
        return None

    def _score(self, fmap) -> float:
        """One GRU iteration against the stored keyframe → mean flow-delta
        magnitude (masked where the keyframe mask is invalid)."""
        V, ht, wd = fmap.shape[:3]
        coords0 = geom.coords_grid(ht, wd, fmap.device).expand(V, ht, wd, 2).contiguous()
        pyr = corr_ops.corr_pyramid(self.f_fmap.float(), fmap.float())
        corr = corr_ops.corr_lookup_pyramid(pyr, coords0)
        motn = torch.zeros((V, ht, wd, 4), device=fmap.device)
        zeros = torch.zeros((V,), dtype=torch.long, device=fmap.device)
        _, delta, _, _ = self.update_fn(self.f_net, self.f_inp, corr, motn, zeros, zeros, 1)
        flow_mag = torch.linalg.norm(delta, dim=-1)
        if self.f_mask is not None:
            w = (~self.f_mask).float()
            per_view = (flow_mag * w).mean((1, 2)) / (w.mean((1, 2)) + 1e-6)
        else:
            per_view = flow_mag.mean((1, 2))
        return float(per_view.min())

    def _sparse_score(self, frame_idx: int) -> float:
        """The mean keypoint flow since the last keyframe, summed over the
        views, plus 100 when more than 20 % of the tracks vanished."""
        st = self.sparse_tracks
        if st is None or not st.enabled:
            return 0.0
        score, n_tracks = 0.0, 0
        for v in range(st.n_views):
            kp = st.get_correspondences(v, frame_idx, self.last_kf_frame_idx)
            n_tracks += len(kp)
            if kp:
                cur = st.get_observations(v, frame_idx, kp)
                last = st.get_observations(v, self.last_kf_frame_idx, kp)
                score += float(np.linalg.norm(cur - last, axis=-1).mean())
        diff = n_tracks - self.last_n_sparse_tracks
        if diff < 0 and self.last_n_sparse_tracks > 0 and -diff / self.last_n_sparse_tracks > 0.2:
            score += 100.0
        self.last_n_sparse_tracks = n_tracks
        return score

    def _promote(self, token: _Token):
        self.f_net, self.f_inp = self.encode_context(token.image)
        self.f_fmap = token.fmap
        self.f_mask = token.mask

    def _promote_kf(self, token: _Token):
        self._promote(token)
        self.last_kf_frame_idx = token.frame_idx
        self.last_n_sparse_tracks = 0

    def submit(self, image, mask=None) -> _Token:
        """Encode one frame: ``image`` (h, w, 3) uint8, ``mask`` (ht, wd),
        or a rig's (V, h, w, 3) and (V, ht, wd)."""
        self.stacked = image.dim() == 4
        if not self.stacked:
            image = image[None]
            mask = None if mask is None else mask[None]
        tok = _Token(image, self.encode_features(image), mask, self.n_submitted)
        self.n_submitted += 1
        if not self.initialized:
            self.initialized = True
            tok.first = True
            self._promote(tok)
        return tok

    def resolve(self, token: _Token) -> bool:
        """Whether the submitted frame is a keyframe (promoting it if so)."""
        if token.first:
            return True
        fixed = self._decision_fixed
        if fixed is not None:
            if fixed:
                self._promote_kf(token)
            return fixed
        if (self._score(token.fmap) > self.thresh
                or self._sparse_score(token.frame_idx) > self.thresh * 2):
            self._promote_kf(token)
            return True
        return False

    @property
    def last_keyframe_features(self):
        """(fmap, net, inp) of the current keyframe reference."""
        if self.stacked:
            return self.f_fmap, self.f_net, self.f_inp
        return self.f_fmap[0], self.f_net[0], self.f_inp[0]
