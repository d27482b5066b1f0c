"""GeoCalib: single-image camera calibration (port of
``vipe_tpu/priors/geocalib``).

The network (``network.py``) predicts an up-vector field, a latitude field
and their confidences; the LM fit (``optimizer.py``) recovers each frame's
gravity and one focal (and k1 for a distorted model) shared by the frames.
Weights come from the local zoo (``models/zoo.py``); without them the net
is random-initialised from a seed, and its calibration is then meaningless
but deterministic.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ...models import zoo
from ...utils.device import resolve_device, true_f32
from .fields import gravity_from_rp, latitude_field, rp_from_gravity, up_field  # noqa: F401
from .network import GeoCalibNet, init_geocalib_, nmf_bases
from .optimizer import calibrate_from_fields, lm_calibrate  # noqa: F401

CAMERA_TYPES = ("pinhole", "simple_radial", "simple_divisional", "simple_mei")


class GeoCalib:
    """``calibrate(frames) -> intrinsics``, one focal shared by the frames.

    ``state_dict``: the network's weights in ViPE's layout; None reads the
    zoo's ``geocalib_pinhole`` (pinhole) or ``geocalib_distorted`` family,
    and without a file there initialises at random from ``seed``.  The NMF
    bases of both decoders are drawn once from ``seed`` (``self.bases``)."""

    def __init__(self, camera_type: str = "pinhole", state_dict=None, seed: int = 0,
                 infer_size: int = 320, device=None):
        if camera_type not in CAMERA_TYPES:
            raise ValueError(f"unknown GeoCalib camera type {camera_type!r}")
        self.camera_type = camera_type
        self.infer_size = infer_size
        self.device = resolve_device(device)
        net = GeoCalibNet()
        if state_dict is None:
            flavor = "pinhole" if camera_type == "pinhole" else "distorted"
            state_dict = zoo.load_state_dict(f"geocalib_{flavor}")
        if state_dict is None:
            init_geocalib_(net, seed)
        else:
            net.load_state_dict(state_dict, strict=True)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.bases = nmf_bases(torch.Generator().manual_seed(seed)).to(self.device)

    def _preprocess(self, rgb) -> torch.Tensor:
        """(H, W, 3) RGB in [0, 1] → (1, 3, h, w) on the device: the short
        side resized to ``infer_size`` (bilinear, half-pixel centres, no
        antialiasing), then centre-cropped to multiples of 32."""
        img = torch.as_tensor(np.asarray(rgb, np.float32), device=self.device)
        h0, w0 = img.shape[:2]
        s = self.infer_size / min(h0, w0)
        h1, w1 = int(round(h0 * s)), int(round(w0 * s))
        img = F.interpolate(img.permute(2, 0, 1)[None], size=(h1, w1), mode="bilinear",
                            align_corners=False, antialias=False)
        hc, wc = (h1 // 32) * 32, (w1 // 32) * 32
        t, l = (h1 - hc) // 2, (w1 - wc) // 2
        return img[..., t:t + hc, l:l + wc]

    @torch.no_grad()
    def predict_fields(self, frames) -> dict:
        """Frames of one size, each (H, W, 3) RGB in [0, 1] → up_field
        (B, h, w, 2), latitude_field, up_confidence, latitude_confidence
        (B, h, w) at the inference size, on the device.  The network runs in
        IEEE f32 (no TF32): the LM fits the focal to these fields."""
        img = torch.cat([self._preprocess(f) for f in frames])
        with true_f32():
            out = self.net(img, self.bases)
        out["up_field"] = out["up_field"].permute(0, 2, 3, 1)
        return out

    def calibrate(self, frames: List[np.ndarray]) -> np.ndarray:
        """Full-resolution intrinsics from the frames: pinhole → (4,)
        [fx, fy, cx, cy]; a distorted model → (5,) with k1 appended (the
        distortion of normalized coordinates does not depend on the
        resolution)."""
        f = self.predict_fields(frames)
        res = calibrate_from_fields(f["up_field"], f["latitude_field"], f["up_confidence"],
                                    f["latitude_confidence"], model=self.camera_type)
        h0, w0 = np.asarray(frames[0]).shape[:2]
        # the focal was fitted at the inference scale; the crop keeps it
        f_full = float(res.focal) * (min(h0, w0) / self.infer_size)
        intr = [f_full, f_full, w0 / 2.0, h0 / 2.0]
        if self.camera_type != "pinhole":
            intr.append(float(res.k1))
        return np.asarray(intr, np.float32)
