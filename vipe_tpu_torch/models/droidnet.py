"""DroidNet in PyTorch (port of ``vipe_tpu/models/droidnet.py``).

Feature/context encoders (``BasicEncoder``) and the ConvGRU update operator
with the ``GraphAgg`` damping head.  Module and parameter names follow
ViPE's ``droid_net.py`` state-dict layout (``fnet.layer1.0.conv1``,
``update.corr_encoder.0``, ``update.gru.convz``, ``update.agg.eta.0``, …),
so a ``droid.pth`` checkpoint loads directly (its 3-channel delta/weight
heads cut to 2, as the JAX converter does).

Public tensors keep the JAX package's NHWC layout; convolutions run NCHW
inside.  ``dtype`` is the compute type: bf16 on the SLAM path (the
reference runs under fp16 autocast), f32 for algorithm tests.  Outputs of
the update operator are f32, as in the JAX package.
"""

from __future__ import annotations

import pathlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import segment_sum
from .zoo import weights_dir

DIM = 32
CORR_PLANES = 4 * (2 * 3 + 1) ** 2  # 196

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d(affine=False) over NCHW, statistics in f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _cv(conv, x):
    """Apply ``conv`` in its own parameter dtype."""
    return conv(x.to(conv.weight.dtype))


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def _cat(xs):
    """Channel concat (NCHW) with type promotion, like ``jnp.concatenate``."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.cat([x.to(dt) for x in xs], dim=1)


def _seq(seq: nn.Sequential, x):
    """Run a conv/ReLU stack with its first conv applied in its own dtype."""
    return seq[1:](_cv(seq[0], x)) if len(seq) > 1 else _cv(seq[0], x)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride))

    def _norm(self, x):
        return instance_norm(x) if self.norm_fn == "instance" else x

    def forward(self, x):
        y = F.relu(self._norm(self.conv1(x)))
        y = F.relu(self._norm(self.conv2(y)))
        if self.downsample is not None:
            x = self._norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7×7 s2 stem + 3 residual stages + 1×1 head → 1/8-res features."""

    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = _conv(3, DIM, 7, 2)
        stages = [(DIM, DIM, 1), (DIM, 2 * DIM, 2), (2 * DIM, 4 * DIM, 2)]
        for i, (cin, cout, stride) in enumerate(stages):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(cin, cout, norm_fn, stride),
                ResidualBlock(cout, cout, norm_fn, 1),
            ))
        self.conv2 = nn.Conv2d(4 * DIM, output_dim, 1)

    def forward(self, x):
        x = self.conv1(x)
        if self.norm_fn == "instance":
            x = instance_norm(x)
        x = F.relu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class ConvGRU(nn.Module):
    def __init__(self, h_planes=128, i_planes=320):
        super().__init__()
        self.w = nn.Conv2d(h_planes, h_planes, 1)
        self.convz = _conv(h_planes + i_planes, h_planes, 3)
        self.convr = _conv(h_planes + i_planes, h_planes, 3)
        self.convq = _conv(h_planes + i_planes, h_planes, 3)
        self.convz_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convr_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convq_glo = nn.Conv2d(h_planes, h_planes, 1)

    def forward(self, net, inp):
        """NCHW; ``net`` may be f32 while the convs compute in their own
        dtype: the gates are conv-typed, the state blend follows the
        promotion of ``net`` (as in the JAX package)."""
        net_inp = _cat([net, inp])
        glo = torch.sigmoid(_cv(self.w, net)) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)
        z = torch.sigmoid(_cv(self.convz, net_inp) + _cv(self.convz_glo, glo))
        r = torch.sigmoid(_cv(self.convr, net_inp) + _cv(self.convr_glo, glo))
        q = torch.tanh(
            _cv(self.convq, _cat([r * net, inp])) + _cv(self.convq_glo, glo)
        )
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    """Edge → per-source-frame aggregation producing the BA damping eta."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(128, 128, 3)
        self.conv2 = _conv(128, 128, 3)
        self.eta = nn.Sequential(_conv(128, 1, 3))

    def forward(self, net, ix, num_frames: int):
        """net: (E, 128, H, W); ix: (E,) source index → (num_frames, H, W)."""
        net = F.relu(_cv(self.conv1, net))
        summed = segment_sum(net.float(), ix, num_frames)
        counts = segment_sum(torch.ones(ix.shape, dtype=torch.float32, device=net.device), ix,
                             num_frames)
        net = (summed / torch.clamp(counts, min=1.0)[:, None, None, None]).to(net.dtype)
        net = F.relu(self.conv2(net))
        eta = F.softplus(self.eta(net).float())
        return 0.01 * eta[:, 0]


class UpdateModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(CORR_PLANES, 128, 1), nn.ReLU(), _conv(128, 128, 3), nn.ReLU()
        )
        self.flow_encoder = nn.Sequential(
            _conv(4, 128, 7), nn.ReLU(), _conv(128, 64, 3), nn.ReLU()
        )
        self.weight = nn.Sequential(_conv(128, 128, 3), nn.ReLU(), _conv(128, 2, 3))
        self.delta = nn.Sequential(_conv(128, 128, 3), nn.ReLU(), _conv(128, 2, 3))
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow, ix=None, num_frames: int = 0):
        """NHWC in: net/inp (E, H, W, 128), corr (E, H, W, 196), flow
        (E, H, W, 4).  Returns (net', delta, weight[, eta]) NHWC, f32."""
        def nhwc(x):
            return x.permute(0, 2, 3, 1).float()

        net, inp = net.permute(0, 3, 1, 2), inp.permute(0, 3, 1, 2)
        c = _seq(self.corr_encoder, corr.permute(0, 3, 1, 2))
        f = _seq(self.flow_encoder, flow.permute(0, 3, 1, 2))
        net = self.gru(net, _cat([inp, c, f]))
        delta = nhwc(_seq(self.delta, net))
        weight = torch.sigmoid(nhwc(_seq(self.weight, net)))
        if ix is not None:
            eta = self.agg(net, ix, num_frames)
            return nhwc(net), delta, weight, eta
        return nhwc(net), delta, weight


class DroidNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = UpdateModule()

    @property
    def dtype(self):
        return self.fnet.conv1.weight.dtype

    def _prep(self, images):
        """(B, H, W, 3) uint8 or float in [0, 1] → normalised NCHW."""
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        x = (images.float() - mean) / std
        return x.permute(0, 3, 1, 2).to(self.dtype)

    def encode_features(self, images):
        """→ (B, H/8, W/8, 128) in the compute dtype."""
        return self.fnet(self._prep(images)).permute(0, 2, 3, 1)

    def encode_context(self, images):
        """→ (net tanh, inp relu), each (B, H/8, W/8, 128)."""
        out = self.cnet(self._prep(images)).permute(0, 2, 3, 1)
        net, inp = out.split(128, dim=-1)
        return torch.tanh(net), F.relu(inp)


def init_droidnet_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init (PyTorch's default conv bounds, 1/√fan_in, drawn
    from one ``torch.Generator``)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / float(m.weight[0].numel()) ** 0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=g) * 2 - 1) * bound)
                m.bias.copy_((torch.rand(m.bias.shape, generator=g) * 2 - 1) * bound)
    return model


def weights_path() -> pathlib.Path:
    return weights_dir() / "droid.pth"


def load_checkpoint_(model: DroidNet, state_dict) -> DroidNet:
    """Load a ViPE ``droid.pth`` state dict: strip ``module.``, cut the
    3-channel delta/weight heads to 2, drop keys the port has no module
    for (the unused upsampling-mask head)."""
    own = model.state_dict()
    sd = {}
    for k, v in state_dict.items():
        k = k.removeprefix("module.")
        if k not in own:
            continue
        if k.startswith(("update.weight.2.", "update.delta.2.")):
            v = v[:2]
        sd[k] = v
    missing = set(own) - set(sd)
    if missing:
        raise KeyError(f"checkpoint lacks {sorted(missing)[:5]}…")
    model.load_state_dict(sd)
    return model


def build_droidnet(device="cpu", dtype=torch.bfloat16, seed: int = 0) -> DroidNet:
    """DroidNet with ``droid.pth`` weights when ``$VIPE_WEIGHTS_DIR`` holds
    one, else a seeded random init; in eval mode on ``device``."""
    model = DroidNet()
    ckpt = weights_path()
    if ckpt.exists():
        load_checkpoint_(model, torch.load(ckpt, map_location="cpu", weights_only=True))
    else:
        init_droidnet_(model, seed)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)
