"""UniDepth v2: camera-aware metric monocular depth (port of
``vipe_tpu/priors/depth/unidepth.py``).

A DINOv2 encoder tapped at four depths (patch tokens and cls tokens), a
camera head that predicts pinhole intrinsics from the cls tokens, and a
depth head conditioned on the camera's rays.  The decoder predicts a log
radius; ``points = rays · radius`` and the depth is their z.  SLAM uses it
as the keyframe metric anchor with the live focal (the given-rays path);
its depth is ``MODEL_METRIC_DEPTH``, so it is run again on every keyframe
when the intrinsics change.

``UniDepthNet`` holds ViPE's key layout (``pixel_encoder.*``,
``pixel_decoder.*``).  It runs in the dtype of its parameters; the
geometry (rays, their angles and Fourier embedding, the intrinsics, the
exponentials) stays in f32, since a bf16 angle times the top frequency
(~π·max(h, w)/2) would lose its phase.

``UniDepthModel`` drives the inference policy of ViPE's adapter: pad to the
aspect-ratio bounds, resize into the pixel-count bounds (sides multiples of
14), run, resize back to the padded shape and crop the padding.
``estimate`` is the f32 path (preprocessing as ``cv2.resize``'s
INTER_LINEAR); ``estimate_sens_device`` is SLAM's keyframe prior, on the
device from the buffer's uint8 image to the 1/8-grid disparity, in bf16,
with the focal read from the live intrinsics row without a host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import zoo
from ...models.unidepth_layers import LN_EPS, MLP, AttentionBlock, AttentionLayer, ResUpsampleBil, \
    fourier_features
from ...models.vit import VIT_CONFIGS, init_seeded_, make_vit
from ...ops.resize import resize_align_corners, resize_bilinear
from ...utils.device import resolve_device, true_f32
from .base import (IMAGENET_MEAN, IMAGENET_STD, DepthEstimationInput, DepthEstimationModel,
                   DepthEstimationResult, DepthType)

UNIDEPTH_TAPS = {
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (5, 11, 17, 23),
}


# ------------------------------------------------------------ infer policy


def get_paddings(original_shape, ratio_bounds):
    """((pad_left, pad_right, pad_top, pad_bottom), (H_pad, W_pad)): pad the
    short side until W/H lies within ``ratio_bounds``."""
    H, W = original_shape
    r = W / H
    target = min(ratio_bounds[1], max(ratio_bounds[0], r))
    if r > target:  # too wide: pad the height
        Hn = int(W / target)
        pt = (Hn - H) // 2
        return (0, 0, pt, Hn - H - pt), (Hn, W)
    Wn = int(H * target)
    pl = (Wn - W) // 2
    return (pl, Wn - W - pl, 0, 0), (H, Wn)


def get_resize_factor(original_shape, pixels_range, shape_multiplier=14):
    """(resize_factor, (H_new, W_new)): the pixel count scaled into
    ``pixels_range``, each side rounded up to the shape multiplier."""
    H, W = original_shape
    n = W * H
    target = min(pixels_range[1], max(pixels_range[0], n))
    f = (target / n) ** 0.5
    Hn = math.ceil(int(H * f) / shape_multiplier) * shape_multiplier
    Wn = math.ceil(int(W * f) / shape_multiplier) * shape_multiplier
    return f, (Hn, Wn)


def resolution_level_bounds(pixels_min, pixels_max, level: Optional[int]):
    """The pixel bounds narrowed to decile ``level`` in [0, 10); None keeps
    the full bounds (ViPE never sets a level)."""
    if level is None:
        return (pixels_min, pixels_max)
    if not 0 <= level < 10:
        raise ValueError(f"resolution level {level} is outside [0, 10)")
    interval = (pixels_max - pixels_min) / 10
    return (level * interval + pixels_min, (level + 1) * interval + pixels_min)


@dataclasses.dataclass(frozen=True)
class UniDepthConfig:
    variant: str = "vitl"
    hidden_dim: int = 512
    num_heads: int = 8
    expansion: int = 4
    depths: Sequence[int] = (2, 2, 2)  # residual units per upsampling stage
    out_dim: int = 32
    kernel_size: int = 7
    layer_scale: float = 1.0


# ------------------------------------------------------------------ network


class CameraHead(nn.Module):
    """Four camera tokens → pinhole (fx, fy, cx, cy) in pixels, f32."""

    def __init__(self, cfg: UniDepthConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.latents_pos = nn.Parameter(torch.zeros(1, 4, d))
        self.project = MLP(d, expansion=1, output_dim=d)
        self.aggregate1 = AttentionBlock(d, cfg.num_heads, cfg.expansion, cfg.layer_scale,
                                         use_bias=False)
        self.aggregate2 = AttentionBlock(d, cfg.num_heads, cfg.expansion, cfg.layer_scale,
                                         use_bias=False)
        self.out_pinhole = MLP(d, expansion=1, output_dim=1)

    def forward(self, cls_tokens, image_hw):
        tokens = self.project(cls_tokens)
        lp = self.latents_pos.expand(tokens.shape[0], -1, -1)
        tokens = self.aggregate1(tokens[:, :4], context=tokens, pos_embed=lp)
        tokens = self.aggregate2(tokens, pos_embed=lp)
        x = self.out_pinhole(tokens)[..., 0].float()
        H, W = image_hw
        diag = float(np.sqrt(H * H + W * W))
        return torch.stack([torch.exp(x[:, 0]) * 0.7 * diag, torch.exp(x[:, 1]) * 0.7 * diag,
                            torch.sigmoid(x[:, 2]) * W, torch.sigmoid(x[:, 3]) * H], dim=1)


def _head(cin: int) -> nn.Sequential:
    """3×3 reflect-padded conv → LeakyReLU → 1×1 conv to one channel."""
    return nn.Sequential(nn.Conv2d(cin, 32, 3, padding=1, padding_mode="reflect"),
                         nn.LeakyReLU(0.01), nn.Conv2d(32, 1, 1))


class DepthHead(nn.Module):
    """Ray-conditioned pyramid decoder: each tapped level attends to the
    ray embedding, then three stages of a transposed-conv skip, residual
    7×7 units and a ×2 upsampling, then log-depth and log-confidence heads
    at the image size."""

    def __init__(self, cfg: UniDepthConfig, n_levels: int):
        super().__init__()
        d = cfg.hidden_dim
        self.prompt_camera = nn.ModuleList(
            AttentionLayer(1, d, cfg.num_heads, cfg.expansion, layer_scale=-1.0, use_bias=False)
            for _ in range(n_levels))
        self.to_latents = nn.Linear(d, d)
        self.process_features = nn.ModuleList()
        self.ups = nn.ModuleList()
        mult = 2
        for i, depth in enumerate(cfg.depths):
            current = min(d, mult * d // 2 ** i)
            output_dim = max(mult * d // 2 ** (i + 1), cfg.out_dim)
            k = max(1, 2 * i)
            self.process_features.append(nn.ConvTranspose2d(d, current, k, stride=k))
            self.ups.append(ResUpsampleBil(current, output_dim, depth, cfg.kernel_size,
                                           cfg.layer_scale))
        nd = output_dim
        # ViPE's decoder keeps a depth MLP per stage and runs only the last
        self.depth_mlp = nn.ModuleDict({str(len(cfg.depths) - 1): nn.Sequential(
            nn.LayerNorm(nd, eps=LN_EPS), nn.Linear(nd, nd))})
        self.confidence_mlp = nn.Sequential(nn.LayerNorm(nd, eps=LN_EPS), nn.Linear(nd, nd))
        self.to_depth_lr = nn.Conv2d(nd, nd // 2, 3, padding=1, padding_mode="reflect")
        self.to_depth_hr = _head(nd // 2)
        self.to_confidence_lr = nn.Conv2d(nd, nd // 2, 3, padding=1, padding_mode="reflect")
        self.to_confidence_hr = _head(nd // 2)

    def forward(self, features, rays_embedding, grid_hw, image_hw):
        h, w = grid_hw
        B = features[0].shape[0]

        def grid(tokens):
            return tokens.transpose(1, 2).reshape(B, -1, h, w)

        cond = [layer(f, context=rays_embedding)
                for layer, f in zip(self.prompt_camera, features)]
        latents = grid(self.to_latents(cond[0]))
        for proc, up, c in zip(self.process_features, self.ups, cond[1:]):
            latents = up(latents + proc(grid(c)))

        last = latents.permute(0, 2, 3, 1)
        outs = []
        for mlp, lr, hr in ((self.depth_mlp[str(len(self.ups) - 1)], self.to_depth_lr,
                             self.to_depth_hr),
                            (self.confidence_mlp, self.to_confidence_lr, self.to_confidence_hr)):
            y = lr(mlp(last).permute(0, 3, 1, 2))
            outs.append(hr(resize_align_corners(y, tuple(image_hw)))[:, 0])
        return outs


class _Adapters(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        self.input_adapters = nn.ModuleList(nn.Linear(cin, cout) for _ in range(n))


def _angles_embedding(rays, grid_hw, dim):
    """(B, H, W, 3) unit rays → (B, h·w, dim) Fourier embedding of their
    polar and azimuth angles at the latent grid, f32."""
    B = rays.shape[0]
    h, w = grid_hw
    lr = resize_bilinear(rays.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
    lr = lr / torch.linalg.norm(lr, dim=-1, keepdim=True).clamp(min=1e-4)
    polar = torch.acos(lr[..., 2].clamp(-1 + 1e-6, 1 - 1e-6))
    xs = lr[..., 0]
    xs = torch.where(xs.abs() < 1e-3, torch.sign(xs) * 1e-3 + (xs == 0) * 1e-3, xs)
    azimuth = torch.atan2(lr[..., 1], xs)
    angles = torch.stack([polar, azimuth], -1).reshape(B, h * w, 2)
    return fourier_features(angles, dim, max_freq=max(h, w) // 2)


def pinhole_rays(intrinsics, hw) -> torch.Tensor:
    """(B, 4) f32 (fx, fy, cx, cy) → (B, H, W, 3) unit rays through pixel
    centres."""
    H, W = hw
    dev = intrinsics.device
    u = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    fx, fy, cx, cy = (intrinsics[:, k, None, None] for k in range(4))
    rx = ((u[None, None, :] - cx) / fx).expand(-1, H, W)
    ry = ((v[None, :, None] - cy) / fy).expand(-1, H, W)
    rays = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True)


class UniDepthDecoder(nn.Module):
    """Token adapters, the camera head and the ray-conditioned depth head."""

    def __init__(self, cfg: UniDepthConfig, input_dim: int, n_levels: int = 4):
        super().__init__()
        d = cfg.hidden_dim
        self.input_adapter = _Adapters(input_dim, d, n_levels)
        self.camera_token_adapter = _Adapters(input_dim, d, n_levels)
        self.camera_layer = CameraHead(cfg)
        self.depth_layer = DepthHead(cfg, n_levels)

    def forward(self, feats, cls_tokens, image_hw, rays=None):
        H, W = image_hw
        h, w = H // 14, W // 14
        features = [a(f) for a, f in zip(self.input_adapter.input_adapters, feats)]
        camera_tokens = torch.stack(
            [a(c) for a, c in zip(self.camera_token_adapter.input_adapters, cls_tokens)], dim=1)
        intrinsics = self.camera_layer(camera_tokens, image_hw)
        rays = pinhole_rays(intrinsics, image_hw) if rays is None else rays.float()
        emb = _angles_embedding(rays, (h, w), features[0].shape[-1]).to(features[0].dtype)
        logdepth, logconf = self.depth_layer(features, emb, (h, w), image_hw)
        radius = torch.exp(logdepth.float().clamp(-8.0, 8.0) + 2.0)
        confidence = torch.exp(logconf.float().clamp(-8.0, 8.0))
        points = rays * radius[..., None]
        return dict(depth=points[..., 2], points=points, confidence=confidence,
                    intrinsics=intrinsics, rays=rays)


class UniDepthNet(nn.Module):
    """``forward(x, rays=None)``: x (B, 3, H, W) normalised image, H and W
    multiples of 14; ``rays`` (B, H, W, 3) unit rays of the camera, or None
    to use the predicted pinhole camera.  Returns depth, points, confidence,
    intrinsics and rays, f32."""

    def __init__(self, variant: str = "vitl", cfg: Optional[UniDepthConfig] = None):
        super().__init__()
        self.cfg = cfg or UniDepthConfig(variant=variant)
        self.taps = UNIDEPTH_TAPS[variant]
        self.pixel_encoder = make_vit(variant)
        self.pixel_decoder = UniDepthDecoder(self.cfg, VIT_CONFIGS[variant]["embed_dim"],
                                             len(self.taps))

    def forward(self, x, rays=None):
        taps = self.pixel_encoder(x.to(self.pixel_encoder.cls_token.dtype), self.taps)
        return self.pixel_decoder([t for t, _ in taps], [c for _, c in taps],
                                  tuple(x.shape[-2:]), rays)


def init_unidepth_(net: UniDepthNet, seed: int = 0) -> UniDepthNet:
    """Seeded random init (``models.vit.init_seeded_``, layer scales at
    ``cfg.layer_scale``), then the camera latents normal(1)."""
    g = init_seeded_(net, seed, gamma=net.cfg.layer_scale)
    with torch.no_grad():
        lp = net.pixel_decoder.camera_layer.latents_pos
        lp.copy_(torch.randn(lp.shape, generator=g))
    return net


# ------------------------------------------------------------------ adapter


class UniDepthModel(DepthEstimationModel):
    """ViPE's UniDepth adapter (``estimate``, ``estimate_depth``) and SLAM's
    keyframe prior (``estimate_sens_device``).

    ``cfg``: the decoder's configuration (None: the published one).
    ``state_dict``: the network's weights in ViPE's layout; None reads the
    zoo's ``unidepth_<s|b|l>`` family (keys the network does not hold are
    dropped, as the JAX converter drops them), and without a file
    initialises at random from ``seed``.  The bf16 copy of the network that
    SLAM's path runs is made on its first call and kept.  The f32 network
    stays on the host until an f32 path (``estimate``, the f32 prior) runs,
    so SLAM's path holds only the bf16 weights on the card."""

    depth_type = DepthType.MODEL_METRIC_DEPTH

    def __init__(self, variant: str = "l", state_dict=None, seed: int = 0,
                 ratio_bounds=(0.5, 2.5), pixels_min: int = 200_000,
                 pixels_max: int = 500_000, resolution_level: Optional[int] = None,
                 device=None, cfg: Optional[UniDepthConfig] = None):
        vit_variant = {"s": "vits", "b": "vitb", "l": "vitl"}.get(variant, variant)
        self.device = resolve_device(device)
        with torch.device("meta"):  # no default init: every tensor is set below
            net = UniDepthNet(vit_variant, cfg)
        if state_dict is None:
            state_dict = zoo.load_state_dict(f"unidepth_{vit_variant[-1]}")
        self._net = zoo.load_net(net, state_dict, seed, init=init_unidepth_)
        self._net_on_device = self.device.type == "cpu"
        self._net_bf16 = None
        self.ratio_bounds = tuple(ratio_bounds)
        self.pixels_min, self.pixels_max = pixels_min, pixels_max
        self.resolution_level = resolution_level
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=self.device)

    def _policy(self, h: int, w: int):
        pads, (hp, wp) = get_paddings((h, w), self.ratio_bounds)
        rf, (nh, nw) = get_resize_factor(
            (hp, wp), resolution_level_bounds(self.pixels_min, self.pixels_max,
                                              self.resolution_level))
        return pads, (hp, wp), rf, (nh, nw)

    @property
    def net(self) -> UniDepthNet:
        """The f32 network on the model's device, moved there on first use."""
        if not self._net_on_device:
            self._net = self._net.to(self.device)
            self._net_on_device = True
        return self._net

    @property
    def net_bf16(self) -> UniDepthNet:
        if self._net_bf16 is None:
            import copy

            self._net_bf16 = copy.deepcopy(self._net).to(self.device, torch.bfloat16)
        return self._net_bf16

    def _normalized(self, rgb01: torch.Tensor, pads) -> torch.Tensor:
        """(h, w, 3) f32 in [0, 1] → (1, 3, h_pad, w_pad), zero-padded in
        normalised space (ViPE pads after normalising)."""
        pl, pr, pt, pb = pads
        x = ((rgb01 - self._mean) / self._std).permute(2, 0, 1)[None]
        return F.pad(x, (pl, pr, pt, pb))

    @staticmethod
    def _unpad(depth, hp, wp, pads):
        """(1, h', w') → (h, w): resized to the padded shape, padding cut."""
        pl, pr, pt, pb = pads
        d = resize_bilinear(depth[:, None], (hp, wp))[0, 0]
        return d[pt:hp - pb, pl:wp - pr]

    @torch.no_grad()
    def estimate(self, inp: DepthEstimationInput) -> DepthEstimationResult:
        """The f32 path: depth and confidence at the input's size."""
        rgb = torch.as_tensor(np.asarray(inp.rgb, np.float32), device=self.device)
        h, w = rgb.shape[:2]
        pads, (hp, wp), rf, (nh, nw) = self._policy(h, w)
        pl, _, pt, _ = pads
        # INTER_LINEAR: half-pixel bilinear without antialiasing
        x = F.interpolate(self._normalized(rgb, pads), size=(nh, nw), mode="bilinear",
                          align_corners=False, antialias=False)
        rays = None
        if inp.focal_length is not None:
            # the camera cropped by the padding and scaled by rf (in f64, as
            # the JAX package builds it with numpy)
            f = float(inp.focal_length) * rf
            cx, cy = (w / 2 + pl) * rf, (h / 2 + pt) * rf
            v, u = torch.meshgrid(torch.arange(nh, dtype=torch.float64) + 0.5,
                                  torch.arange(nw, dtype=torch.float64) + 0.5, indexing="ij")
            r = torch.stack([(u - cx) / f, (v - cy) / f, torch.ones_like(u)], -1)
            rays = (r / torch.linalg.norm(r, dim=-1, keepdim=True)).float()[None].to(self.device)
        with true_f32():
            out = self.net(x, rays)
        return DepthEstimationResult(depth=self._unpad(out["depth"], hp, wp, pads),
                                     confidence=self._unpad(out["confidence"], hp, wp, pads))

    def _batch_inputs(self, rgbs, focal_length=None):
        """Same-shaped (H, W, 3) frames in [0, 1] → the batch's inputs
        before their uint8 rounding: the frames padded with the ImageNet
        mean (0 once normalised) and resized as ``cv2.INTER_LINEAR`` does,
        (B, 3, nh, nw) f32 in [0, 1]; the rays of the shared focal (nh, nw,
        3) f32, None for the predicted camera; the padded shape and the
        pads."""
        h, w = rgbs[0].shape[:2]
        pads, (hp, wp), rf, (nh, nw) = self._policy(h, w)
        pl, pr, pt, pb = pads
        x = torch.as_tensor(np.stack(rgbs), device=self.device).permute(0, 3, 1, 2)
        canvas = self._mean[:, None, None].expand(len(rgbs), 3, hp, wp).clone()
        canvas[:, :, pt:hp - pb, pl:wp - pr] = x
        rs = F.interpolate(canvas, size=(nh, nw), mode="bilinear", align_corners=False,
                           antialias=False)
        rays = None
        if focal_length is not None:
            cam = torch.tensor([float(focal_length) * rf, (w / 2 + pl) * rf, (h / 2 + pt) * rf],
                               dtype=torch.float32, device=self.device)
            u = torch.arange(nw, dtype=torch.float32, device=self.device) + 0.5
            v = torch.arange(nh, dtype=torch.float32, device=self.device) + 0.5
            rx = ((u[None, :] - cam[1]) / cam[0]).expand(nh, nw)
            ry = ((v[:, None] - cam[2]) / cam[0]).expand(nh, nw)
            r = torch.stack([rx, ry, torch.ones_like(rx)], -1)
            rays = r / torch.linalg.norm(r, dim=-1, keepdim=True)
        return rs, rays, (hp, wp), pads

    def _net_input(self, rs):
        """``_batch_inputs``' resized frames → the net's input: rounded to
        uint8 pixels and normalised."""
        mean, std = self._mean[:, None, None], self._std[:, None, None]
        return ((rs * 255.0).round().clamp(0, 255) / 255.0 - mean) / std

    @staticmethod
    def _batch_depth(depth, hw_pad, pads):
        """The net's (B, nh, nw) depth resized to the padded shape and
        cropped, f32."""
        (hp, wp), (pl, pr, pt, pb) = hw_pad, pads
        return resize_bilinear(depth.float()[:, None], (hp, wp))[:, 0, pt:hp - pb, pl:wp - pr]

    @torch.no_grad()
    def estimate_depth_batch(self, rgbs, focal_length=None, dtype: torch.dtype = torch.bfloat16):
        """Depth for same-shaped frames with one shared focal (None: the
        predicted camera), the post-SLAM metric path: one forward for the
        batch, in bf16 (``dtype`` f32: the f32 net).  The frames are
        prepared by ``_batch_inputs`` and ``_net_input``; the depth is
        resized to the padded shape, cropped and rounded to f16, as the JAX
        package returns it.  Returns (H, W) f32 numpy arrays; frames of
        mixed shapes run one by one."""
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"the batch runs in bf16 or f32, not {dtype}")
        rgbs = [np.asarray(r, np.float32) for r in rgbs]
        if any(r.shape[:2] != rgbs[0].shape[:2] for r in rgbs):
            return [d for r in rgbs for d in self.estimate_depth_batch([r], focal_length, dtype)]
        rs, rays, hw_pad, pads = self._batch_inputs(rgbs, focal_length)
        x = self._net_input(rs)
        if rays is not None:
            rays = rays.to(dtype)[None].expand(len(rgbs), -1, -1, -1)
        if dtype == torch.float32:
            with true_f32():
                out = self.net(x, rays)
        else:
            out = self.net_bf16(x.to(dtype), rays)
        return list(self._batch_depth(out["depth"], hw_pad, pads).half().float().cpu().numpy())

    @torch.no_grad()
    def estimate_sens_device(self, image_u8: torch.Tensor,
                             intrinsics: Optional[torch.Tensor] = None,
                             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """(H, W, 3) uint8 image on the device, and the buffer's live
        intrinsics row (focal first) or None for the predicted camera →
        (H/8, W/8) f32 disparity prior, 0 where the depth is not positive.
        The net runs in bf16 (``dtype`` f32: the f32 net, the reference the
        bf16 path is held to); the focal is read on the device."""
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"the prior runs in bf16 or f32, not {dtype}")
        h, w = int(image_u8.shape[0]), int(image_u8.shape[1])
        pads, (hp, wp), rf, (nh, nw) = self._policy(h, w)
        pl, _, pt, _ = pads
        x = resize_bilinear(self._normalized(image_u8.float() / 255.0, pads), (nh, nw))
        rays = None
        if intrinsics is not None:
            f = intrinsics[0].float() * rf
            cx, cy = (w / 2.0 + pl) * rf, (h / 2.0 + pt) * rf
            u = torch.arange(nw, dtype=torch.float32, device=x.device) + 0.5
            v = torch.arange(nh, dtype=torch.float32, device=x.device) + 0.5
            rx = ((u[None, :] - cx) / f).expand(nh, nw)
            ry = ((v[:, None] - cy) / f).expand(nh, nw)
            r = torch.stack([rx, ry, torch.ones_like(rx)], -1)
            # the JAX package hands the net rays in its dtype
            rays = (r / torch.linalg.norm(r, dim=-1, keepdim=True)).to(dtype)[None]
        if dtype == torch.float32:
            with true_f32():
                out = self.net(x, rays)
        else:
            out = self.net_bf16(x.to(dtype), rays)
        d = self._unpad(out["depth"], hp, wp, pads)[3::8, 3::8]
        return torch.where(d > 0, 1.0 / d.clamp(min=1e-8), d)
