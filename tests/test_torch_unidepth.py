"""The port's UniDepth v2 (``vipe_tpu_torch.priors.depth.unidepth``, SLAM's
``keyframe_depth: unidepth-<s|b|l>``) and its DINOv2 ViT against
``vipe_tpu``'s.

Both sides run the same weights: the synthetic ViPE-layout state dict of
``tests/test_unidepth.py`` goes through ``convert_unidepth`` to the JAX
package and, as is, into the port (``strict=True``).  Its 0.02-scale
weights leave the net close to constant, so the net-level tests also run
the port's seeded initialisation (``init_unidepth_``, weights with variance
1/fan_in), handed to JAX through ``convert_unidepth`` too.  The JAX
references of the ViT, the net, both estimate paths and the buffer run in
two spawned processes (``BackgroundJax``) that the module's first test
starts, so their compiles overlap the port's tests; in each, one JAX
``UniDepthModel`` (UniDepth-S, jitted at one shape: 70×84 for the net,
64×80 frames for the adapter) serves every weight set, swapped as an
argument of its jitted programs.  The numerical tests narrow the decoder
to 64 channels (the published 512 hold 143.8 M parameters); the converter
and ``strict=True`` load are checked at the published width.

Tolerances: the ViT (ViT-S widths, 4 f32 blocks, attention and sums in
another order) 1e-4; the positional-grid resize (torch's bicubic against
the JAX package's hand-built weights) 1e-6; each layer 1e-5; the resizes
1e-5; the policy helpers and the converter round trip exactly;
``UniDepthNet`` and ``estimate`` (f32) 1e-4 relative to the largest output.

The SLAM path (``estimate_sens_device``) runs bf16 activations and keeps
the rays' angles in f32.  The JAX package's bf16 path, from the same
bf16-rounded weights and image, runs f32 activations from its
positional-embedding add on (the f32 interpolation weights promote it) but
takes its rays' angles in bf16, whose error grows with the focal (with the
seeded weights at focal 140, 7.7 % of the largest prior against its own f32
path).  So the port is held to the JAX package through f32: the port's f32
prior equals the JAX package's f32 path (``estimate`` on the same frame and
focal, sampled and inverted as the prior is) within 1e-4 of the largest
prior (measured ≤ 4.7e-6); the port's bf16 prior lies within 5e-2 of the
port's f32 path on the bf16-rounded weights (measured ≤ 2.7e-2) and of the
JAX package's bf16 prior (measured ≤ 2.6e-2 at the focal used here); the
predicted camera in place of the given rays lies 0.28 away.  Given rays
avoid the line y = 0, x < 0 at the latent cells, where atan2's branch cut
makes the azimuth jump by 2π for a rounding difference.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slam import BackgroundJax, _disparity_grid, _rel
from tests.test_unidepth import make_synthetic_unidepth_sd
from vipe_tpu.models import convert as jconvert
from vipe_tpu.models import unidepth_layers as jl
from vipe_tpu.models import vit as jvit
from vipe_tpu.priors.depth import unidepth as jud
from vipe_tpu.priors.depth.base import DepthEstimationInput as JInput
from vipe_tpu_torch.models import model_cache, zoo
from vipe_tpu_torch.models import unidepth_layers as tl
from vipe_tpu_torch.models import vit as tvit
from vipe_tpu_torch.models.convert import unidepth_state_dict_from_flax, vit_state_dict_from_flax
from vipe_tpu_torch.ops.resize import resize_align_corners, resize_bilinear
from vipe_tpu_torch.priors.depth import unidepth as tud
from vipe_tpu_torch.priors.depth.base import DepthEstimationInput as TInput

NET_H, NET_W = 70, 84
FRAME_H, FRAME_W = 64, 80  # → 70×84 under the test's pixel bounds
BOUNDS = dict(pixels_min=3_000, pixels_max=6_000)
SENS_RTOL = 5e-2  # the port's bf16 prior against its f32 path and the JAX package's
FOCAL = 70.0
INTR = np.asarray([FOCAL, FOCAL, FRAME_W / 2, FRAME_H / 2], np.float32)
WEIGHTS = ("synthetic", "seeded")
VIT_CASES = {"plain": (0, 0), "registers": (4, 0), "cond": (0, 2)}
VIT_DEPTH, VIT_TAPS = 4, (1, 3)  # ViT-S widths, a few blocks
# UniDepth-S with a 64-wide decoder (the published one is 512 wide, 143.8 M
# parameters): the numerical tests' net
NARROW = dict(variant="vits", hidden_dim=64, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _state_dicts():
    """name → ViPE-layout numpy state dict, made alike in every process."""
    narrow = tud.UniDepthConfig(**NARROW)
    return {"synthetic": make_synthetic_unidepth_sd(np.random.default_rng(0), hidden=64),
            "seeded": _np_sd(tud.init_unidepth_(tud.UniDepthNet("vits", narrow), 0))}


@pytest.fixture(scope="module")
def weight_sets():
    """name → (ViPE-layout numpy state dict, its flax params)."""
    return {name: (sd, jconvert.convert_unidepth(sd)) for name, sd in _state_dicts().items()}


def _port_model(name, sd=None):
    sd = _state_dicts()[name] if sd is None else sd
    return tud.UniDepthModel("s", state_dict={k: torch.as_tensor(v) for k, v in sd.items()},
                             device="cpu", cfg=tud.UniDepthConfig(**NARROW), **BOUNDS)


_port_models = functools.lru_cache(maxsize=None)(_port_model)


def _jax_models():
    """name → the one JAX UniDepth-S, holding that weight set's params."""
    params = {name: jconvert.convert_unidepth(sd) for name, sd in _state_dicts().items()}
    model = jud.UniDepthModel("s", params=params["synthetic"], **BOUNDS)
    model.net = jud.UniDepthNet("vits", params["synthetic"], cfg=jud.UniDepthConfig(**NARROW))

    def use(name):
        model.net.params = params[name]
        return model
    return use


def _vit_inputs(registers, cond_dim):
    rng = np.random.default_rng(registers + cond_dim)
    x = rng.standard_normal((2, 56, 70, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 56, 70, cond_dim)).astype(np.float32) if cond_dim else None
    return rng, x, cond


def _net_input():
    return np.random.default_rng(1).random((1, NET_H, NET_W, 3)).astype(np.float32)


def _rays(f=80.0, cx=40.3, cy=33.2):
    u, v = np.meshgrid(np.arange(NET_W) + 0.5, np.arange(NET_H) + 0.5)
    r = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], -1)
    return (r / np.linalg.norm(r, axis=-1, keepdims=True)).astype(np.float32)[None]


def _frame_rgb():
    return np.random.default_rng(2).random((FRAME_H, FRAME_W, 3)).astype(np.float32)


def _frame_u8(seed):
    rgb = np.random.default_rng(seed).random((FRAME_H, FRAME_W, 3))
    return np.rint(rgb * 255.0).astype(np.uint8)


# ----------------------------------------------------- the JAX references


def _jax_vit_job():
    """The JAX references of the ViT cases, with the params they drew."""
    out = {}
    for case, (registers, cond_dim) in VIT_CASES.items():
        rng, x, cond = _vit_inputs(registers, cond_dim)
        jm = jvit.make_vit("vits", depth=VIT_DEPTH, num_register_tokens=registers,
                           cond_dim=cond_dim)
        c = None if cond is None else jnp.asarray(cond)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), tap_layers=VIT_TAPS, condition=c)
        # every leaf moved off its init (the condition projection starts at 0)
        params = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape)
                              .astype(np.float32), params)  # noqa: B023
        apply = jax.jit(lambda p, x, c: jm.apply(p, x, tap_layers=VIT_TAPS, condition=c))  # noqa: B023
        out[case] = (params, [(np.asarray(t), np.asarray(e))
                              for t, e in apply(params, jnp.asarray(x), c)])
    return out


def _jax_net_job():
    """The JAX references of ``UniDepthNet`` and ``estimate`` for every
    weight set."""
    use = _jax_models()
    out = {"net": {}, "estimate": {}}
    x, rays = jnp.asarray(_net_input()), jnp.asarray(_rays())
    for name in WEIGHTS:
        net = use(name).net
        for camera in ("given_rays", "predicted"):
            ref = net(x, rays if camera == "given_rays" else None)
            out["net"][name, camera] = {k: np.asarray(v) for k, v in ref.items()}
        for focal in (FOCAL, None):
            ref = use(name).estimate(JInput(rgb=_frame_rgb(), focal_length=focal))
            out["estimate"][name, focal] = (np.asarray(ref.depth), np.asarray(ref.confidence))
    return out


def _jax_sens_job():
    """The JAX references of ``estimate_sens_device`` for every weight set,
    with the JAX package's f32 path on the same frame (``estimate``, as a
    disparity grid), and of the buffer's ``update_disps_sens`` (seeded
    weights): the priors after each keyframe, then after the focal grew by
    half."""
    from vipe_tpu.slam.buffer import GraphBuffer as JBuffer

    use = _jax_models()
    out = {"sens": {}, "sens_f32": {}}
    for name in WEIGHTS:
        for with_intr in (True, False):
            ref = use(name).estimate_sens_device(jnp.asarray(_frame_u8(3)),
                                                 jnp.asarray(INTR) if with_intr else None)
            out["sens"][name, with_intr] = np.asarray(ref)
            ref = use(name).estimate(JInput(rgb=_frame_u8(3).astype(np.float32) / 255.0,
                                            focal_length=FOCAL if with_intr else None))
            out["sens_f32"][name, with_intr] = _disparity_grid(ref.depth)
    jm = use("seeded")
    jb = JBuffer(height=FRAME_H, width=FRAME_W, buffer_size=4)
    feat = np.zeros((FRAME_H // 8, FRAME_W // 8, 128), np.float32)
    for k in range(2):
        jb.append_keyframe(k, jnp.asarray(_frame_u8(10 + k)), feat, None, None,
                           intrinsics=INTR.copy())
        jb.update_disps_sens(jm, frame_idx=k)
    out["buffer_first"] = np.asarray(jb.disps_sens[:2])
    jb.intrinsics = jb.intrinsics.at[:2].multiply(1.5)
    jb.update_disps_sens(jm)
    out["buffer_rerun"] = np.asarray(jb.disps_sens[:2])
    return out


_JAX_NET = BackgroundJax({"vit": (_jax_vit_job, ()), "net": (_jax_net_job, ())})
_JAX_SENS = BackgroundJax({"sens": (_jax_sens_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_NET.start()
    _JAX_SENS.start()
    yield
    _JAX_NET.stop()
    _JAX_SENS.stop()


# --------------------------------------- the layers (JAX in this process)


@pytest.mark.parametrize("ph,pw", [(38, 68), (5, 6), (37, 20), (1, 90)])
def test_interpolate_pos_grid_matches_jax(ph, pw):
    pos = np.random.default_rng(ph).normal(0, 0.02, (1, 37 * 37, 64)).astype(np.float32)
    ref = jvit.interpolate_pos_grid(jnp.asarray(pos), 37, ph, pw)
    got = tvit.interpolate_pos_grid(torch.from_numpy(pos), 37, ph, pw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def _attn_params(sd, use_bias, ls):
    return {"params": jconvert._attn_block_ud(sd, "m", use_bias=use_bias, layer_scale=ls)}


def _layer_case(name, rng):
    """(port module, the JAX module, its flax params, inputs as numpy)."""
    C = 32
    x = rng.standard_normal((2, 6, C)).astype(np.float32)
    ctx = rng.standard_normal((2, 9, C)).astype(np.float32)
    if name == "mlp":
        t = tl.MLP(C, 2, 16)
        return t, jl.MLP(C, 2, 16), lambda sd: {"params": jconvert._mlp_ud(sd, "m")}, (x,)
    if name in ("attention_block", "attention_block_nobias_nols"):
        bias = name == "attention_block"
        t = tl.AttentionBlock(C, 4, 2, layer_scale=1.0 if bias else -1.0, use_bias=bias)
        j = jl.AttentionBlock(C, 4, 2, layer_scale=1.0 if bias else -1.0, use_bias=bias)
        pos = rng.standard_normal((2, 6, C)).astype(np.float32)
        pos_ctx = rng.standard_normal((2, 9, C)).astype(np.float32)
        return t, j, lambda sd: _attn_params(sd, bias, bias), (x, ctx, pos, pos_ctx)
    if name == "attention_layer":
        t = tl.AttentionLayer(2, C, 4, 2, use_bias=False)
        j = jl.AttentionLayer(2, C, 4, 2, use_bias=False)

        def params(sd):
            return {"params": {f"block{i}": jconvert._attn_block_ud(sd, f"m.layers.{i}", False)
                               for i in range(2)}}
        return t, j, params, (x, ctx)
    img = rng.standard_normal((2, 5, 7, C)).astype(np.float32)
    if name == "residual_conv_unit":
        t, j = tl.ResidualConvUnit(C, 7), jl.ResidualConvUnit(C, 7)

        def params(sd):
            return {"params": {"conv1": jconvert._conv_entry(sd, "m.conv1"),
                               "conv2": jconvert._conv_entry(sd, "m.conv2"),
                               "gamma": sd["m.gamma"].reshape(-1)}}
        return t, j, params, (img,)
    assert name == "res_upsample_bil"
    t, j = tl.ResUpsampleBil(C, 16, 2, 3), jl.ResUpsampleBil(C, 16, 2, 3)

    def params(sd):
        p = {f"rcu{i}": {"conv1": jconvert._conv_entry(sd, f"m.convs.{i}.conv1"),
                         "conv2": jconvert._conv_entry(sd, f"m.convs.{i}.conv2"),
                         "gamma": sd[f"m.convs.{i}.gamma"].reshape(-1)} for i in range(2)}
        p["up_conv"] = jconvert._conv_entry(sd, "m.up.0")
        return {"params": p}
    return t, j, params, (img,)


@pytest.mark.parametrize("name", ["mlp", "attention_block", "attention_block_nobias_nols",
                                  "attention_layer", "residual_conv_unit", "res_upsample_bil"])
def test_layer_matches_jax(name):
    """Each block with random weights (every norm and scale moved off its
    init), the port's module converted to flax by the JAX package's own
    converter helpers."""
    rng = np.random.default_rng(len(name))
    t, j, to_flax, inputs = _layer_case(name, rng)
    with torch.no_grad():
        for pname, p in t.named_parameters():
            n = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            if p.dim() >= 2 and not pname.endswith("gamma"):
                p.copy_(n / p[0].numel() ** 0.5)  # unit-variance outputs
            else:
                p.copy_(1.0 + 0.3 * n)  # scales, shifts and gammas off their init
    sd = {f"m.{k}": v for k, v in _np_sd(t).items()}
    ref = j.apply(to_flax(sd), *map(jnp.asarray, inputs))
    if inputs[0].ndim == 4:  # NHWC on the JAX side, NCHW in the port
        got = t(torch.from_numpy(inputs[0]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        got = t(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("max_freq", [3, 34])
def test_embeddings_match_jax(max_freq):
    """``fourier_features`` (log and linear bands) at the test net's latent
    grid (5×6: max_freq 3) and at 532×952's (38×68: 34), with
    ``position_embedding_sine`` and ``orthonormal_init``.  At max_freq 34
    the phase reaches 34·π·π ≈ 335 rad, where an f32 phase has a quantum of
    3e-5 whatever the order of operations: there the bound is 4 quanta."""
    np.testing.assert_allclose(tl.position_embedding_sine(5, 7, 16).numpy(),
                               np.asarray(jl.position_embedding_sine(5, 7, 16)), atol=1e-5)
    rng = np.random.default_rng(3)
    # polar angles in [0, π/2], azimuths in [-π, π]
    ang = np.stack([rng.uniform(0, np.pi / 2, (2, 30)), rng.uniform(-np.pi, np.pi, (2, 30))],
                   -1).astype(np.float32)
    atol = 1e-5 if max_freq == 3 else 4 * np.spacing(np.float32(max_freq * np.pi ** 2))
    for use_log in (True, False):
        np.testing.assert_allclose(
            tl.fourier_features(torch.from_numpy(ang), 64, max_freq, use_log).numpy(),
            np.asarray(jl.fourier_features(jnp.asarray(ang), 64, max_freq, use_log)),
            rtol=0, atol=atol)
    np.testing.assert_array_equal(tl.orthonormal_init(4, 16, 2), jl.orthonormal_init(4, 16, 2))


@pytest.mark.parametrize("src,dst", [((720, 1280), (532, 952)), ((70, 84), (5, 6)),
                                     ((5, 6), (10, 12)), ((40, 48), (70, 84)),
                                     ((33, 20), (18, 41))])
def test_resize_matches_jax(src, dst):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")``
    (antialiased where an axis shrinks: SLAM's 720p frame, the rays to the
    latent grid, one axis down and one up), and ``resize_align_corners``
    against the JAX package's."""
    from vipe_tpu.ops.resize import resize_align_corners as jresize_ac

    x = np.random.default_rng(src[0]).random((1,) + src + (3,)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1,) + dst + (3,), "bilinear")
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resize_bilinear(tx, dst).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    got = resize_align_corners(tx, dst).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jresize_ac(jnp.asarray(x), dst)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(720, 1280), (1280, 720), (480, 640), (100, 1000), (1000, 100),
                                (64, 80), (1080, 1920)])
@pytest.mark.parametrize("level", [None, 0, 9])
def test_policy_helpers_match_jax(hw, level):
    for ratio in ((0.5, 2.5), (0.75, 1.5)):
        assert tud.get_paddings(hw, ratio) == jud.get_paddings(hw, ratio)
        _, padded = tud.get_paddings(hw, ratio)
        bounds = tud.resolution_level_bounds(200_000, 500_000, level)
        assert bounds == jud.resolution_level_bounds(200_000, 500_000, level)
        assert tud.get_resize_factor(padded, bounds) == jud.get_resize_factor(padded, bounds)
    if hw == (720, 1280) and level is None:  # a 720p frame's net input
        assert tud.get_resize_factor(hw, (200_000, 500_000))[1] == (532, 952)


def test_converter_round_trip():
    """At the published decoder width: the synthetic state dict, through
    ``convert_unidepth`` and back, is itself, and loads ``strict=True``."""
    sd = make_synthetic_unidepth_sd(np.random.default_rng(0))
    got = unidepth_state_dict_from_flax(jconvert.convert_unidepth(sd))
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), v), k
    with torch.device("meta"):
        net = tud.UniDepthNet("vits")
    net.to_empty(device="cpu").load_state_dict(got, strict=True)


# --------------------------------------------------- factory and the zoo


def test_factory_builds_unidepth_once_per_device():
    from vipe_tpu_torch.priors.depth.factory import make_depth_model

    try:
        m = make_depth_model("unidepth-s", device="cpu")
        assert isinstance(m, tud.UniDepthModel) and m.net.cfg.variant == "vits"
        assert m.device == torch.device("cpu") and m.depth_type.name == "MODEL_METRIC_DEPTH"
        assert make_depth_model("unidepth-s", device="cpu") is m
        # without a weight file: the seeded initialisation, the same in every build
        fresh = tud.UniDepthModel("s", device="cpu")
        for k, v in fresh.net.state_dict().items():
            assert torch.equal(v, m.net.state_dict()[k]), k
        # the factory's other metric family builds beside it, METRIC_DEPTH
        m3d = make_depth_model("metric3d-small", device="cpu")
        assert m3d.depth_type.name == "METRIC_DEPTH" and m3d.device == torch.device("cpu")
    finally:
        model_cache.clear()
    with pytest.raises(ValueError, match="family"):
        make_depth_model("midas-l", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_depth_model("unidepth-l")


def test_zoo_reads_unidepth_families(weight_sets, tmp_path, monkeypatch):
    """``unidepth_<s|b|l>``: a ViPE ``.pth`` (keys the net does not hold,
    such as DINOv2's mask token, are dropped) or the JAX package's flax
    tree as ``.npz``; no file → None."""
    sd, params = weight_sets["synthetic"]
    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))
    assert zoo.load_state_dict("unidepth_s") is None
    extra = {"pixel_encoder.mask_token": np.zeros((1, 384), np.float32)}
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in {**sd, **extra}.items()}},
               tmp_path / "unidepth_s.pth")
    flat = {}

    def flatten(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            flatten(v, key) if isinstance(v, dict) else flat.__setitem__(key, np.asarray(v))

    flatten(params, "")
    np.savez(tmp_path / "unidepth_b.npz", **flat)
    got = zoo.load_state_dict("unidepth_b")
    assert set(got) == set(sd) and all(np.array_equal(got[k].numpy(), v) for k, v in sd.items())
    model = tud.UniDepthModel("s", device="cpu", cfg=tud.UniDepthConfig(**NARROW))
    assert all(np.array_equal(model.net.state_dict()[k].numpy(), v) for k, v in sd.items())


def test_unidepth_config_is_the_jax_one():
    assert dataclasses.asdict(tud.UniDepthConfig()) == dataclasses.asdict(jud.UniDepthConfig())
    assert tud.UNIDEPTH_TAPS == jud.UNIDEPTH_TAPS and tvit.VIT_CONFIGS == jvit.VIT_CONFIGS


def test_rig_with_keyframe_depth_raises():
    """A rig with a keyframe depth prior stays refused, the constant and the
    Metric3D one alike: the JAX reference indexes a rig's (frame, view)
    slots by frame there (ROADMAP.md, queue 3), so it cannot hold a port of
    that path to account."""
    from vipe_tpu_torch.priors.depth.base import ConstantDepthModel
    from vipe_tpu_torch.priors.depth.metric3d import Metric3DModel
    from vipe_tpu_torch.slam.system import SLAMSystem
    from vipe_tpu_torch.streams.base import MultiviewVideoList, VideoStream

    class Empty(VideoStream):
        def __len__(self):
            return 0

    rig = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32), (2, 1))
    for prior in (ConstantDepthModel(2.0), Metric3DModel("small", device="cpu")):
        slam = SLAMSystem(config={}, device="cpu", metric_depth=prior,
                          update_fn=lambda *a: None)
        with pytest.raises(NotImplementedError, match="rig"):
            slam.run(MultiviewVideoList("rig", [Empty(), Empty()], rig))


# --------------------------- the ViT and the net (JAX in the background)


@pytest.mark.parametrize("case", list(VIT_CASES))
def test_vit_matches_jax(case):
    registers, cond_dim = VIT_CASES[case]
    _, x, cond = _vit_inputs(registers, cond_dim)
    params, ref = _JAX_NET.result("vit")[case]
    tm = tvit.make_vit("vits", depth=VIT_DEPTH, num_register_tokens=registers,
                       cond_dim=cond_dim)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), VIT_TAPS,
                 None if cond is None else torch.from_numpy(cond).permute(0, 3, 1, 2))
    for (jt, jc), (tt, tc) in zip(ref, got):
        assert tt.shape == jt.shape and tc.shape == jc.shape
        np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=1e-4)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("camera", ["given_rays", "predicted"])
def test_unidepth_net_matches_jax(weights, camera):
    net = _port_models(weights).net
    rays = _rays() if camera == "given_rays" else None
    with torch.no_grad():
        got = net(torch.from_numpy(_net_input()).permute(0, 3, 1, 2),
                  None if rays is None else torch.from_numpy(rays))
    ref = _JAX_NET.result("net")["net"][weights, camera]
    for key in ("depth", "confidence", "intrinsics", "points", "rays"):
        assert got[key].shape == ref[key].shape, key
        assert _rel(ref[key], got[key].numpy()) < 1e-4, key
    if weights == "seeded":  # the output is not flat: the comparison has teeth
        assert ref["depth"].max() > 1.5 * ref["depth"].min()


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("focal", [FOCAL, None])
def test_estimate_matches_jax(weights, focal):
    tm = _port_models(weights)
    got = tm.estimate(TInput(rgb=_frame_rgb(), focal_length=focal))
    assert got.depth.shape == (FRAME_H, FRAME_W) == got.confidence.shape
    torch.testing.assert_close(tm.estimate_depth(_frame_rgb(), focal), got.depth, rtol=0, atol=0)
    depth, conf = _JAX_NET.result("net")["estimate"][weights, focal]
    assert _rel(depth, got.depth.numpy()) < 1e-4
    assert _rel(conf, got.confidence.numpy()) < 1e-4


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("with_intrinsics", [True, False])
def test_estimate_sens_device_matches_jax(weights, with_intrinsics):
    tm = _port_models(weights)
    img = torch.from_numpy(_frame_u8(3))
    intr = torch.from_numpy(INTR) if with_intrinsics else None
    got = tm.estimate_sens_device(img, intr)
    assert got.shape == (FRAME_H // 8, FRAME_W // 8) and got.dtype == torch.float32
    assert bool((got > 0).all())
    refs = _JAX_SENS.result("sens")
    # the port's f32 path equals the JAX package's f32 path
    f32 = tm.estimate_sens_device(img, intr, dtype=torch.float32)
    assert _rel(refs["sens_f32"][weights, with_intrinsics], f32.numpy()) < 1e-4
    # the port's f32 path on the same pixels, on the bf16-rounded weights
    rounded = _port_model(weights, {k: v.float() for k, v in tm.net_bf16.state_dict().items()})
    ref = rounded.estimate_sens_device(img, intr, dtype=torch.float32)
    assert _rel(ref, got.numpy()) < SENS_RTOL
    assert _rel(refs["sens"][weights, with_intrinsics], got.numpy()) < SENS_RTOL
    if weights == "seeded" and with_intrinsics:
        # the bounds have teeth: the predicted camera in place of the given
        # rays moves the prior far outside either
        wrong = tm.estimate_sens_device(img, None, dtype=torch.float32)
        assert _rel(refs["sens_f32"][weights, True], wrong.numpy()) > 4 * SENS_RTOL


def test_update_disps_sens_matches_jax():
    """The UniDepth prior per keyframe, then, after the focal changed, on
    every keyframe again (a model-metric prior is not rescaled), as the
    JAX buffer runs it."""
    from vipe_tpu_torch.slam.buffer import GraphBuffer as TBuffer

    tm = _port_models("seeded")
    tb = TBuffer(height=FRAME_H, width=FRAME_W, buffer_size=4)
    feat = torch.zeros((FRAME_H // 8, FRAME_W // 8, 128))
    for k in range(2):
        tb.append_keyframe(k, torch.from_numpy(_frame_u8(10 + k)), feat, None, None,
                           intrinsics=INTR.copy())
        tb.update_disps_sens(tm, frame_idx=k)
    first = tb.disps_sens[:2].clone()
    tb.intrinsics[:2] *= 1.5
    tb.update_disps_sens(tm)
    # both keyframes ran again with the new focal, and nothing was rescaled
    assert not any(torch.equal(a, b) for a, b in zip(tb.disps_sens[:2], first))
    assert not torch.allclose(tb.disps_sens[:2], first / 1.5, rtol=1e-3)
    torch.testing.assert_close(tb.last_depth_intrinsics, tb.intrinsics)
    refs = _JAX_SENS.result("sens")
    assert _rel(refs["buffer_first"], first.numpy()) < SENS_RTOL
    assert _rel(refs["buffer_rerun"], tb.disps_sens[:2].numpy()) < SENS_RTOL
