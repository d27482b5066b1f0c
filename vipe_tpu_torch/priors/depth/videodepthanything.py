"""Video Depth Anything: temporally consistent relative depth over a video
(port of ``vipe_tpu/priors/depth/videodepthanything.py``).

A DINOv2 encoder per frame and ``DPTHeadTemporal``, the DPT head with
temporal modules after layer 3, layer 4, fusion 4 and fusion 3, in ViPE's
key layout (``pretrained.*``, ``head.*``, ``head.motion_modules.{0..3}``).
Video inference runs 32-frame windows 22 frames apart; each later window
starts with 10 frames of the one before (``KEYFRAMES``) and is aligned to
it by scale and shift on two of them, with an 8-frame cross-fade
(``stitch_depth_windows``, host numpy).  "svda" is ViT-S, "vda" ViT-L.

Memory policy, as the JAX package's: the ViT runs on 8-frame chunks, and
the head is split after its last temporal module; the part after it
(fusion 2 and 1, the output convolutions and the full-size upsample,
whose activations are the largest) runs on 4-frame chunks.  The
window's output is upsampled to the frame size (align-corners, in f32)
and rounded to f16, as the JAX package returns it.

``VideoDepthAnythingModel`` runs its net in bf16 by default, under
``torch.autocast`` (bf16 products and convolutions on f32 weights, norms
and the residual stream in f32), as ViPE runs it under fp16 autocast; the
JAX package's bf16 forward keeps its activations in f32 from the
positional embeddings on.  ``dtype=torch.float32`` gives the f32 path
(TF32 off).  Frames are resized on the device by bicubic interpolation in
float and rounded to uint8 pixels, then normalised in the forward.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from ...models import zoo
from ...models.dpt import DPTHead
from ...models.temporal import TemporalModule
from ...models.vit import VIT_CONFIGS, make_vit
from ...ops.resize import resize_align_corners
from ...utils.device import resolve_device, true_f32
from .base import DepthEstimationInput, DepthEstimationModel, DepthEstimationResult, DepthType
from .dav2 import DAV2_CONFIGS, input_hw, normalize, resize_cubic

INFER_LEN = 32
OVERLAP = 10
KEYFRAMES = [0, 12, 24, 25, 26, 27, 28, 29, 30, 31]
INTERP_LEN = 8


def preprocess_u8(frames: torch.Tensor, input_size: int = 518) -> torch.Tensor:
    """(T, H, W, 3) float frames, in [0, 1] or [0, 255] (judged per frame)
    → (T, 3, nh, nw) uint8: bicubic in float, then rounded and clipped."""
    a = frames.float()
    a = a * torch.where(a.amax(dim=(1, 2, 3), keepdim=True) <= 1.5, 255.0, 1.0)
    img = resize_cubic(a.permute(0, 3, 1, 2), input_hw(a.shape[1], a.shape[2], input_size))
    return img.round().clamp(0, 255).to(torch.uint8)


class DPTHeadTemporal(DPTHead):
    """``joint`` runs the head through its last temporal module, on whole
    clips; ``tail`` the rest, frame by frame."""

    def __init__(self, in_dim: int, features: int = 256,
                 out_channels=(256, 512, 1024, 1024), num_frames: int = INFER_LEN):
        super().__init__(in_dim, features, out_channels)
        oc = tuple(out_channels)
        self.motion_modules = nn.ModuleList(TemporalModule(c, max_len=num_frames)
                                            for c in (oc[2], oc[3], features, features))

    def joint(self, taps, ph: int, pw: int, T: int):
        s, mm = self.scratch, self.motion_modules
        l1, l2, l3, l4 = self.levels(taps, ph, pw)
        l1, l2, l3, l4 = self.rn((l1, l2, mm[0](l3, T), mm[1](l4, T)))
        p4 = mm[2](s.refinenet4(l4, out_hw=l3.shape[-2:]), T)
        p3 = mm[3](s.refinenet3(p4, l3, out_hw=l2.shape[-2:]), T)
        return l1, l2, p3

    def tail(self, l1, l2, p3) -> torch.Tensor:
        s = self.scratch
        p1 = s.refinenet1(s.refinenet2(p3, l2, out_hw=l1.shape[-2:]), l1)
        return self.output(p1, l2.shape[-2] // 2, l2.shape[-1] // 2)

    def forward(self, taps, ph: int, pw: int, T: int) -> torch.Tensor:
        return self.tail(*self.joint(taps, ph, pw, T))


class VideoDepthAnythingNet(nn.Module):
    """``forward(clip, out_hw=None)``: clip (T, 3, H, W), uint8 pixels
    (normalised here) or normalised floats, H and W multiples of 14 →
    (T, H, W) f32 disparity, or (T, *out_hw) f16 with ``out_hw``.  Runs in
    the dtype of its parameters."""

    VIT_CHUNK = 8
    HEAD_CHUNK = 4

    def __init__(self, variant: str = "vitl", num_frames: int = INFER_LEN):
        super().__init__()
        cfg = DAV2_CONFIGS[variant]
        self.taps = cfg["taps"]
        self.pretrained = make_vit(variant)
        self.head = DPTHeadTemporal(VIT_CONFIGS[variant]["embed_dim"], cfg["features"],
                                    cfg["out_channels"], num_frames)

    def forward(self, clip: torch.Tensor, out_hw=None) -> torch.Tensor:
        if clip.dtype == torch.uint8:
            clip = normalize(clip.float() / 255.0)
        clip = clip.to(self.pretrained.cls_token.dtype)
        T, _, H, W = clip.shape
        parts = [self.pretrained(c, self.taps) for c in clip.split(self.VIT_CHUNK)]
        taps = [tuple(torch.cat([p[i][j] for p in parts]) for j in (0, 1))
                for i in range(len(self.taps))]
        del parts
        l1, l2, p3 = self.head.joint(taps, H // 14, W // 14, T)
        del taps
        outs = []
        HC = self.HEAD_CHUNK
        for a, b, c in zip(l1.split(HC), l2.split(HC), p3.split(HC)):
            o = self.head.tail(a, b, c).float()
            if out_hw is not None:
                o = resize_align_corners(o[:, None], tuple(out_hw))[:, 0]
            outs.append(o)
        out = torch.cat(outs)
        return out.half() if out_hw is not None else out


# ---------------------------------------------------------------- stitching


def compute_scale_and_shift(pred, target, mask=None):
    """Closed-form least-squares (scale, shift) of pred onto target, f32;
    (1, 0) when singular."""
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    m = np.ones_like(pred) if mask is None else np.asarray(mask, np.float32)
    a00 = np.sum(m * pred * pred)
    a01 = np.sum(m * pred)
    a11 = np.sum(m)
    b0 = np.sum(m * pred * target)
    b1 = np.sum(m * target)
    det = a00 * a11 - a01 * a01
    if det == 0:
        return 1.0, 0.0
    return float((a11 * b0 - a01 * b1) / det), float((-a01 * b0 + a00 * b1) / det)


def get_interpolate_frames(pre: List[np.ndarray], post: List[np.ndarray]):
    """Linear cross-fade from ``pre`` to ``post``."""
    assert len(pre) == len(post)
    n = len(pre)
    ws = [0.0] + [i / (n - 1) for i in range(1, n - 1)] + [1.0]
    return [p * (1 - w) + q * w for p, q, w in zip(pre, post, ws)]


def stitch_depth_windows(depth_list: List[np.ndarray], org_len: int):
    """Consecutive ``INFER_LEN``-frame windows, each later one aligned by
    scale and shift on its first keyframes, with an ``INTERP_LEN``
    cross-fade at the seam → (org_len, H, W)."""
    aligned: List[np.ndarray] = []
    ref_align: List[np.ndarray] = []
    align_len = OVERLAP - INTERP_LEN
    kf_align = KEYFRAMES[:align_len]

    for f0 in range(0, len(depth_list), INFER_LEN):
        if not aligned:
            aligned += depth_list[:INFER_LEN]
            for kf in kf_align:
                ref_align.append(depth_list[f0 + kf])
            continue
        curr_align = [depth_list[f0 + i] for i in range(len(kf_align))]
        scale, shift = compute_scale_and_shift(np.concatenate(curr_align),
                                               np.concatenate(ref_align))
        pre = aligned[-INTERP_LEN:]
        post = [np.maximum(depth_list[f0 + i] * scale + shift, 0)
                for i in range(align_len, OVERLAP)]
        aligned[-INTERP_LEN:] = get_interpolate_frames(pre, post)
        for i in range(OVERLAP, INFER_LEN):
            aligned.append(np.maximum(depth_list[f0 + i] * scale + shift, 0))
        ref_align = ref_align[:1]
        for kf in kf_align[1:]:
            ref_align.append(np.maximum(depth_list[f0 + kf] * scale + shift, 0))

    return np.stack(aligned[:org_len], axis=0)


def build_vda_net(variant: str, state_dict=None, seed: int = 0,
                  device="cpu") -> VideoDepthAnythingNet:
    """A frozen f32 ``VideoDepthAnythingNet`` on ``device`` with
    ``state_dict``, or seeded random weights when it is None."""
    with torch.device("meta"):
        net = VideoDepthAnythingNet(variant)
    return zoo.load_net(net, state_dict, seed).to(device)


def precision(device: torch.device, dtype: torch.dtype):
    """The context a VDA forward runs in: bf16 autocast, or IEEE f32."""
    if dtype == torch.bfloat16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return true_f32()


class VideoDepthAnythingModel(DepthEstimationModel):
    """Whole-video inference.  ``state_dict`` None reads the zoo's
    ``vda_<variant>``, else seeded random weights."""

    depth_type = DepthType.AFFINE_DISP

    def __init__(self, variant: str = "vitl", input_size: int = 518, state_dict=None,
                 seed: int = 0, device=None, dtype=torch.bfloat16):
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"Video Depth Anything runs in bf16 or f32, not {dtype}")
        self.device = resolve_device(device)
        self.input_size = input_size
        self.dtype = dtype
        if state_dict is None:
            state_dict = zoo.load_state_dict(f"vda_{variant}")
        self.net = build_vda_net(variant, state_dict, seed, self.device)

    @torch.no_grad()
    def forward(self, clip: torch.Tensor, out_hw=None) -> torch.Tensor:
        """The net on one clip (see ``VideoDepthAnythingNet``) in the
        model's precision."""
        with precision(self.device, self.dtype):
            return self.net(clip, out_hw)

    @torch.no_grad()
    def infer_video_depth(self, frames: List[np.ndarray]) -> np.ndarray:
        """frames: (H, W, 3) float RGB in [0, 1] → (T, H, W) f32 disparity."""
        h, w = frames[0].shape[:2]
        ratio = max(h, w) / min(h, w)
        input_size = self.input_size
        if ratio > 1.78:
            input_size = round(input_size * 1.777 / ratio / 14) * 14

        step = INFER_LEN - OVERLAP
        org_len = len(frames)
        pad = (step - (org_len % step)) % step + OVERLAP
        frames = list(frames) + [frames[-1]] * pad
        depth_list: List[np.ndarray] = []
        prev = None
        for f0 in range(0, org_len, step):
            # a later window's first OVERLAP frames are the previous clip's KEYFRAMES
            first = 0 if prev is None else OVERLAP
            x = torch.as_tensor(np.stack(frames[f0 + first: f0 + INFER_LEN]).astype(np.float32))
            clip = preprocess_u8(x.to(self.device), input_size)
            if prev is not None:
                clip = torch.cat([prev[KEYFRAMES], clip])
            depth = self.forward(clip, (h, w))
            depth_list += list(depth.float().cpu().numpy())
            prev = clip
        return stitch_depth_windows(depth_list, org_len)

    def estimate(self, inp: DepthEstimationInput) -> DepthEstimationResult:
        return DepthEstimationResult(
            depth=torch.as_tensor(self.infer_video_depth([np.asarray(inp.rgb)])[0]))
