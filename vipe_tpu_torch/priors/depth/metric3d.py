"""Metric3D v2: canonical-space metric monocular depth (port of
``vipe_tpu/priors/depth/metric3d.py``).

A DINOv2 ViT with 4 register tokens, tapped at 4 depths, and the
``RAFTDepthNormalDPT5`` decoder:

* ``Token2Feature``: each tap's patch tokens read out against its cls and
  register tokens, then resampled to 1/14 (scale 1: identity), 1/7 (a
  2×2 transposed convolution) or 1/4 (a 1×1 convolution and a 3.5×
  nearest resize, ``jax.image.resize``'s half-pixel rule);
* ``FuseBlock``s (residual ``ConvBlock``s, align-corners upsampling ×1,
  ×2, ×7/4) down to a 1/4 map with 2 confidence channels;
* a depth regressor over 256 log-spaced bins in [0.1, 200] and a normal
  head (unit xyz, ELU κ);
* a context encoder (residual blocks with a LayerNorm over channels, ε
  1e-6 as flax's) and the 3-level slow-fast ConvGRU with its flow head and
  the convex ×4 upsampling mask, ``iters`` refinement steps.

``Metric3DNet`` holds ViPE's key layout (``depth_model.encoder.*``,
``depth_model.decoder.*``), NCHW; its public outputs keep the JAX
package's layout (normals channels-last).  ``Metric3DModel.estimate`` is
ViPE's adapter: the frame letterboxed into the 616×1064 canonical canvas
(bilinear with half-pixel centres and no antialiasing, what OpenCV's
``INTER_LINEAR`` computes on f32, done on the device), ImageNet
normalisation, the net in IEEE f32, the canvas's depth cropped back,
resized to the frame (antialiased where an axis shrinks, as
``jax.image.resize``) and rescaled by ``focal·scale/1000``.  Its depth is
``METRIC_DEPTH``: SLAM rescales its keyframe priors by the focal ratio
instead of running it again.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import zoo
from ...models.vit import VIT_CONFIGS, make_vit
from ...ops.resize import resize_align_corners, resize_bilinear, resize_nearest
from ...utils.device import resolve_device, true_f32
from .base import (IMAGENET_MEAN, IMAGENET_STD, DepthEstimationInput, DepthEstimationModel,
                   DepthEstimationResult, DepthType)

CANONICAL_SIZE = (616, 1064)
CANONICAL_FOCAL = 1000.0

METRIC3D_TAPS = {
    "small": (2, 5, 8, 11),
    "large": (5, 11, 17, 23),
}

# the decode head of each variant (ViPE's configs/vit.raft5.{small,large}.py)
METRIC3D_CFGS = {
    "small": dict(
        vit="vits", D=384,
        feature_channels=(96, 192, 384, 768),
        decoder_channels=(48, 96, 192, 384, 384),
        hidden=48, iters=4,
    ),
    "large": dict(
        vit="vitl", D=1024,
        feature_channels=(256, 512, 1024, 1024),
        decoder_channels=(128, 256, 512, 1024, 1024),
        hidden=128, iters=8,
    ),
}

MIN_DEPTH, MAX_DEPTH = 0.1, 200.0
REGRESS_SCALE = 100.0
NUM_ANCHORS = 256
UPSAMPLE = 4          # the convex upsampling factor
N_REGISTERS = 4


def _norm_normalize(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) → unit xyz and κ = ELU + 1.01, channels last."""
    n = torch.sqrt(torch.sum(x[..., :3] ** 2, -1, keepdim=True)) + 1e-10
    kappa = F.elu(x[..., 3:4]) + 1.0 + 0.01
    return torch.cat([x[..., :3] / n, kappa], -1)


class Readout(nn.Module):
    """Patch tokens projected and added to a projection of the cls and
    register tokens, then (tanh-approximated) GELU."""

    def __init__(self, D: int):
        super().__init__()
        self.project_patch = nn.Linear(D, D)
        self.project_learn = nn.Linear((1 + N_REGISTERS) * D, D, bias=False)

    def forward(self, patch, extras):
        learn = self.project_learn(extras.flatten(1))[:, None]
        return F.gelu(self.project_patch(patch) + learn, approximate="tanh")


class Token2Feature(nn.Module):
    def __init__(self, D: int, out: int, scale: float):
        super().__init__()
        self.readoper = Readout(D)
        self.scale = scale
        if scale == 1:
            self.sample = None  # identity: out == D
        elif float(scale).is_integer():
            s = int(scale)
            self.sample = nn.ConvTranspose2d(D, out, s, stride=s)
        else:
            self.sample = nn.Sequential(nn.Conv2d(D, out, 1))

    def forward(self, patch, extras, ph: int, pw: int):
        B, _, D = patch.shape
        x = self.readoper(patch, extras).transpose(1, 2).reshape(B, D, ph, pw)
        if self.sample is None:
            return x
        if isinstance(self.sample, nn.ConvTranspose2d):
            return self.sample(x)
        # the 1×1 convolution commutes with the nearest resize: run it on
        # the smaller grid
        return resize_nearest(self.sample(x), (int(ph * self.scale), int(pw * self.scale)))


class ConvBlock(nn.Module):
    """Pre-activation residual double 3×3 convolution."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FuseBlock(nn.Module):
    def __init__(self, channels: int, out: int, branch: bool = True, upsample: bool = True,
                 scale: float = 2.0):
        super().__init__()
        self.way_branch = ConvBlock(channels) if branch else None
        self.way_trunk = ConvBlock(channels)
        self.out_conv = nn.Conv2d(channels, out, 1)
        self.upsample, self.scale = upsample, scale

    def forward(self, x1, x2=None):
        if x2 is not None:
            x1 = x1 + self.way_branch(x2)
        out = self.way_trunk(x1)
        if self.upsample:
            H, W = out.shape[-2:]
            out = resize_align_corners(out, (int(H * self.scale), int(W * self.scale)))
        return self.out_conv(out)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (flax's ε, 1e-6)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-6)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ResidualBlockLN(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, out, 3, padding=1)
        self.norm1 = LayerNorm2d(out)
        self.conv2 = nn.Conv2d(out, out, 3, padding=1)
        self.norm2 = LayerNorm2d(out)
        if cin != out:
            self.downsample = nn.Sequential(nn.Conv2d(cin, out, 1))
            self.norm3 = LayerNorm2d(out)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


def _context_out(cin: int, out: int) -> nn.Sequential:
    """A residual block, then a 3×3 convolution."""
    return nn.Sequential(ResidualBlockLN(cin, out), nn.Conv2d(out, out, 3, padding=1))


class ConvGRU(nn.Module):
    """ConvGRU with the context's z, r, q injected."""

    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + cin, hidden, 3, padding=1)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, 1)
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)) + cq)
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    """The depth (2) and normal (4) deltas."""

    def __init__(self, hidden: int):
        super().__init__()
        self.conv1d = nn.Conv2d(hidden, hidden, 3, padding=1)
        self.conv2d = nn.Conv2d(hidden, 2, 3, padding=1)
        self.conv1n = nn.Conv2d(hidden, hidden, 3, padding=1)
        self.conv2n = nn.Conv2d(hidden, 4, 3, padding=1)

    def forward(self, x):
        d = self.conv2d(F.relu(self.conv1d(x)))
        n = self.conv2n(F.relu(self.conv1n(x)))
        return torch.cat([d, n], 1)


def _pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class UpdateBlock(nn.Module):
    """The 3-level slow-fast GRU hierarchy, the flow head and the convex
    upsampling mask."""

    def __init__(self, hidden: int):
        super().__init__()
        h = hidden
        self.gru08 = ConvGRU(h, 6 + h)
        self.gru16 = ConvGRU(h, 2 * h)
        self.gru32 = ConvGRU(h, h)
        self.flow_head = FlowHead(h)
        self.mask = nn.Sequential(nn.Conv2d(h, h, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(h, UPSAMPLE * UPSAMPLE * 9, 1))

    def forward(self, net, inp, flow=None, iter08=True, iter16=True, update=True):
        net = list(net)
        net[2] = self.gru32(net[2], *inp[2], _pool2x(net[1]))
        if iter16:
            hw = tuple(net[1].shape[-2:])
            net[1] = self.gru16(net[1], *inp[1], resize_align_corners(_pool2x(net[0]), hw),
                                resize_align_corners(net[2], hw))
        if iter08:
            net[0] = self.gru08(net[0], *inp[0], flow,
                                resize_align_corners(net[1], tuple(net[0].shape[-2:])))
        if not update:
            return net
        return net, 0.25 * self.mask(net[0]), self.flow_head(net[0])


def _convex_upsample(flow, mask):
    """(B, D, H, W) flow and (B, 9·4·4, H, W) mask (channels in the JAX
    package's (9, 4, 4) order) → (B, D, 4H, 4W): each output pixel a softmax
    combination of its 3×3 coarse neighbourhood."""
    B, D, H, W = flow.shape
    f = UPSAMPLE
    m = torch.softmax(mask.reshape(B, 9, f, f, H, W), dim=1)
    neigh = F.unfold(flow, 3, padding=1).reshape(B, D, 9, H, W)
    up = torch.einsum("bkuvhw,bdkhw->bdhuwv", m, neigh)
    return up.reshape(B, D, H * f, W * f)


class Metric3DDecoder(nn.Module):
    def __init__(self, D: int, feature_channels: Sequence[int],
                 decoder_channels: Sequence[int], hidden: int, iters: int):
        super().__init__()
        fc, dc, h = feature_channels, decoder_channels, hidden
        self.iters = iters
        self.token2feature = nn.Module()
        for i, (out, scale) in enumerate(((fc[0], 3.5), (fc[1], 2), (D, 1), (D, 1))):
            setattr(self.token2feature, f"read_{i}", Token2Feature(D, out, scale))
        self.decoder_mono = nn.Module()
        self.decoder_mono.upconv_3 = FuseBlock(dc[4], dc[3], branch=False, upsample=False)
        self.decoder_mono.upconv_2 = FuseBlock(dc[3], dc[2], scale=2.0)
        self.decoder_mono.upconv_1 = FuseBlock(dc[2], dc[1] + 2, scale=7 / 4)
        self.depth_regressor = nn.Sequential(
            nn.Conv2d(dc[1], NUM_ANCHORS, 3, padding=1), nn.ReLU(),
            nn.Conv2d(NUM_ANCHORS, NUM_ANCHORS, 1))
        self.normal_predictor = nn.Sequential(
            nn.Conv2d(dc[1], 128, 3, padding=1), nn.ReLU(), nn.Conv2d(128, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 1), nn.ReLU(), nn.Conv2d(128, 3, 1))
        self.context_feature_encoder = nn.Module()
        for tag, cin in (("04", fc[0]), ("08", fc[1]), ("16", D)):
            setattr(self.context_feature_encoder, f"outputs{tag}",
                    nn.ModuleList([_context_out(cin, h), _context_out(cin, h)]))
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(h, 3 * h, 3, padding=1)
                                               for _ in range(3))
        self.update_block = UpdateBlock(h)

    def forward(self, taps, ph: int, pw: int):
        t2f = self.token2feature
        x = t2f.read_3(*taps[3], ph, pw)     # 1/14
        x2 = t2f.read_2(*taps[2], ph, pw)    # 1/14
        x1 = t2f.read_1(*taps[1], ph, pw)    # 1/7
        x0 = t2f.read_0(*taps[0], ph, pw)    # 1/4

        dm = self.decoder_mono
        y = dm.upconv_1(dm.upconv_2(dm.upconv_3(x), x2), x1)
        feat, depth_conf, normal_conf = y[:, :-2], y[:, -2:-1], y[:, -1:]

        prob = torch.softmax(self.depth_regressor(feat), 1)
        bins = torch.exp(torch.linspace(math.log(MIN_DEPTH), math.log(MAX_DEPTH), NUM_ANCHORS,
                                        device=feat.device, dtype=feat.dtype))
        d = torch.einsum("bkhw,k->bhw", prob, bins)[:, None].clamp(MIN_DEPTH, MAX_DEPTH)
        depth_pred = (d - MAX_DEPTH) / REGRESS_SCALE
        n = torch.cat([self.normal_predictor(feat), normal_conf], 1)
        normal_pred = _norm_normalize(n.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        flow = torch.cat([depth_pred, depth_conf, normal_pred], 1)

        net, inp = [], []
        for lvl, (tag, feat_l) in enumerate(zip(("04", "08", "16"), (x0, x1, x2))):
            hid_out, ctx_out = getattr(self.context_feature_encoder, f"outputs{tag}")
            net.append(torch.tanh(hid_out(feat_l)))
            zqr = self.context_zqr_convs[lvl](F.relu(ctx_out(feat_l)))
            inp.append(tuple(zqr.chunk(3, 1)))

        update = self.update_block
        up_mask = None
        for _ in range(self.iters):
            net = update(net, inp, iter16=False, iter08=False, update=False)
            net = update(net, inp, iter08=False, update=False)
            net, up_mask, delta = update(net, inp, flow=flow)
            flow = flow + delta

        flow_up = _convex_upsample(flow, up_mask)
        depth = torch.clamp(flow_up[:, 0] * REGRESS_SCALE + MAX_DEPTH, MIN_DEPTH, MAX_DEPTH)
        normals = _norm_normalize(flow_up[:, 2:6].permute(0, 2, 3, 1))
        return depth, normals, flow_up[:, 1]


class Metric3DNet(nn.Module):
    """``forward(x)``: x (B, 3, H, W) normalised image, H and W multiples of
    14 → depth (B, h, w), normals (B, h, w, 4) and confidence (B, h, w)
    with h = 4·⌊3.5·H/14⌋ (w likewise)."""

    def __init__(self, variant: str = "small", iters: Optional[int] = None):
        super().__init__()
        cfg = METRIC3D_CFGS[variant]
        self.variant = variant
        self.taps = METRIC3D_TAPS[variant]
        self.depth_model = nn.Module()
        self.depth_model.encoder = make_vit(cfg["vit"], num_register_tokens=N_REGISTERS)
        self.depth_model.decoder = Metric3DDecoder(
            VIT_CONFIGS[cfg["vit"]]["embed_dim"], cfg["feature_channels"],
            cfg["decoder_channels"], cfg["hidden"],
            iters if iters is not None else cfg["iters"])

    def forward(self, x):
        taps = self.depth_model.encoder(x, self.taps)
        ps = self.depth_model.encoder.patch_size
        return self.depth_model.decoder(taps, x.shape[-2] // ps, x.shape[-1] // ps)


class Metric3DModel(DepthEstimationModel):
    """ViPE's Metric3D adapter.  ``state_dict``: the network's weights in
    ViPE's layout; None reads the zoo's ``metric3d_<variant>`` family and,
    without a file, initialises at random from ``seed``.  ``input_size``:
    the canonical canvas (None: 616×1064); ``iters``: the GRU's refinement
    steps (None: the variant's 4 or 8)."""

    depth_type = DepthType.METRIC_DEPTH

    def __init__(self, variant: str = "small", state_dict=None, seed: int = 0,
                 input_size=None, iters: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        with torch.device("meta"):  # no default init: every tensor is set below
            net = Metric3DNet(variant, iters)
        if state_dict is None:
            state_dict = zoo.load_state_dict(f"metric3d_{variant}")
        self.net = zoo.load_net(net, state_dict, seed).to(self.device)
        self.input_size = tuple(input_size or CANONICAL_SIZE)
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                                  device=self.device)[:, None, None]
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                                 device=self.device)[:, None, None]

    @torch.no_grad()
    def estimate(self, inp: DepthEstimationInput) -> DepthEstimationResult:
        """Depth at the input's size; ``inp.rgb`` (H, W, 3) in [0, 1], a
        host array or a tensor."""
        rgb = inp.rgb if torch.is_tensor(inp.rgb) else torch.from_numpy(
            np.asarray(inp.rgb, np.float32))
        rgb = rgb.to(self.device, torch.float32)
        h, w = rgb.shape[:2]
        th, tw = self.input_size
        scale = min(th / h, tw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        img = F.interpolate(rgb.permute(2, 0, 1)[None], size=(nh, nw), mode="bilinear",
                            align_corners=False, antialias=False)
        img = (img - self._mean) / self._std
        # letterbox into the canonical canvas, its sides multiples of 14
        th14, tw14 = (th // 14) * 14, (tw // 14) * 14
        pt, pl = max((th14 - nh) // 2, 0), max((tw14 - nw) // 2, 0)
        ch, cw = min(nh, th14), min(nw, tw14)
        canvas = torch.zeros((1, 3, th14, tw14), device=self.device)
        canvas[..., pt:pt + ch, pl:pl + cw] = img[..., :th14 - pt, :tw14 - pl]
        with true_f32():
            depth_c, _, _ = self.net(canvas)
        dh, dw = depth_c.shape[1:]
        sy, sx = dh / th14, dw / tw14
        crop = depth_c[:, int(pt * sy):int((pt + ch) * sy), int(pl * sx):int((pl + cw) * sx)]
        depth = resize_bilinear(crop[:, None], (h, w))[0, 0]
        if inp.focal_length is not None:
            # from the canonical camera (focal 1000 at the letterboxed scale)
            depth = depth * (float(inp.focal_length) * scale / CANONICAL_FOCAL)
        return DepthEstimationResult(depth=depth)
