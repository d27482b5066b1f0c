"""The port's post-SLAM depth stage (``post.depth_align_model``) against
``vipe_tpu``'s: KNN, the alignment and stitching helpers, the map's UV
coverage, the DPT head, the temporal modules, Depth Anything v2, Video
Depth Anything, PriorDA, UniDepth's batched metric path and
``AdaptiveDepthProcessor``.

Both sides run the same weights: the port's seeded initialisation
(``models.vit.init_seeded_``: weights with variance 1/fan_in, the
zero-initialised projections too) at ViT-S widths, handed to the JAX
package through its own converters (``convert_dav2``, ``convert_vda``,
``convert_unidepth``); the converters' inverses are checked on the
0.02-scale synthetic state dicts of ``tests/test_dav2.py``.  Inputs are
seeded numpy; nets run at ``input_size`` 70 and 32-frame windows.  The
JAX references of the nets run in two spawned processes
(``BackgroundJax``) that the module's first test starts; the port's own
work runs before the first wait on them.

Tolerances:
* ``knn`` on integer pixel coordinates (a grid full of ties, duplicate
  points): indices and squared distances exactly equal;
  ``knn_infill_depth``, ``project_map(knn_infill=True)``,
  ``uv_coverage_score``, the alignment functions and the window
  stitching: exactly equal;
* f32 nets against flax ``apply`` on f32 params (``TemporalModule``,
  ``DPTHead`` relative and metric, DAv2 plain and conditioned, the VDA
  net): within 1e-4 of the largest output;
* the port's bf16 VDA net (autocast) within 5e-2 of its f32 net, and its
  bf16 video inference within 5e-2 of the JAX package's bf16 one (whose
  activations are f32 from the positional embeddings on);
* the device preprocessing (torch bicubic) against ``cv2.INTER_CUBIC``:
  3e-4 of the pixel range in float (measured 1.2e-4, downscaling a 720p
  frame tenfold); in uint8 at most one step, on under 1 % of the pixels
  (measured 0.26 %: a rounding at .5 either way);
* ``knn_scale_shift_completion`` and PriorDA's coarse completion (a stub
  coarse net on both sides, see the test): the prompt pixels exactly;
  1e-4 relative to the largest value on the pixels whose weighted 2×2
  system has a condition number below ``COND_MAX`` (1e3); beyond it f32
  rounding in another order is amplified by the solve
  (``tests/test_priorda_warp.py``), and the test prints the worst such
  pixel (measured 2.7e-4); the fine stage through its inputs (the
  condition within 1e-6, the image within the preprocessing tolerance),
  its conditioned net (1e-4) and its resize and un-normalisation of one
  net output (``POST_RTOL``, 1e-6);
* UniDepth's batched metric path in parts: its preprocessing against
  ``cv2.INTER_LINEAR`` (3e-4 in float, at most one uint8 step on under
  1 % of the pixels; the rays within 1e-6), the f32 net on the port's
  inputs (1e-4), the resize and crop of one net depth (``POST_RTOL``),
  the whole f32 batch within one f16 step at every pixel of the JAX
  package's chain; the port's bf16 within 5e-2 of its f32;
* ``AdaptiveDepthProcessor`` on one shared SLAM output, metric branch
  (forced by the threshold) and PriorDA branch, both with VDA-S and frame
  masks: the same branch and coverage score, depths within ``PROC_RTOL``
  (5e-2) of the largest (measured 3.4e-2 on the metric branch, whose
  UniDepth the JAX package runs with bf16 rays, and 1.2e-3 on PriorDA's);
  the pipeline on a 2-view rig likewise (measured 2.9e-3 and 5.7e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dav2 import make_synthetic_dav2_sd
from tests.test_torch_slam import UNIDEPTH_BOUNDS, UNIDEPTH_NARROW, BackgroundJax, _rel
from vipe_tpu_torch.models import convert as tconvert
from vipe_tpu_torch.models import model_cache, zoo
from vipe_tpu_torch.utils.device import true_f32

H, W = 48, 64
INPUT_SIZE = 70
T_PROC = 10  # frames through the processor: one chunk of 8 and one of 2
NET_RTOL = 1e-4
BF16_RTOL = 5e-2
COND_MAX = 1e3
PROC_RTOL = 5e-2
POST_RTOL = 1e-6
FOCAL = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _torch_sd(sd):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _weights():
    """name → the port's seeded ViPE-layout state dict (numpy), alike in
    every process (a reference process draws them on one thread too)."""
    torch.set_num_threads(1)
    from vipe_tpu_torch.priors.depth.dav2 import build_dav2_net
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthConfig, UniDepthNet, init_unidepth_
    from vipe_tpu_torch.priors.depth.videodepthanything import build_vda_net

    return {
        "dav2": _np_sd(build_dav2_net("vits", None, 0)),
        "dav2_cond": _np_sd(build_dav2_net("vits", None, 1, cond_dim=3)),
        "dav2_metric": _np_sd(build_dav2_net("vits", None, 2, max_depth=20.0)),
        "vda": _np_sd(build_vda_net("vits", None, 0)),
        "unidepth": _np_sd(init_unidepth_(UniDepthNet("vits", UniDepthConfig(**UNIDEPTH_NARROW)),
                                          0)),
    }


def _frames(n=T_PROC, seed=5):
    """A textured canvas translated frame by frame, (H, W, 3) in [0, 1]
    with 1/255 steps, as a decoded video gives them."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H + 16, W + 16, 3)).astype(np.float32) / 255.0
    return [base[k % 16: k % 16 + H, (2 * k) % 16: (2 * k) % 16 + W].copy() for k in range(n)]


def _static_frames(n=T_PROC, seed=10):
    """A static camera: one canvas, each frame with its own ±1-step noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 255, (H, W, 3))
    return [(base + rng.integers(-1, 2, (H, W, 3))).astype(np.float32) / 255.0
            for _ in range(n)]


def _valid_mask():
    """A frame mask whose bottom 8 rows are invalid (left out of the VDA
    fit)."""
    mask = np.ones((H, W), bool)
    mask[-8:] = False
    return mask


def _stub_net(x):
    """The stub coarse net of the PriorDA tests: 1 + 0.2·(channel mean of
    the normalised NCHW image)."""
    return 1.0 + 0.2 * torch.mean(x, 1)


def _stub_disparity(rgb):
    """The stub coarse net's disparity for an (H, W, 3) frame, resized to
    it as PriorDA resizes its prediction."""
    from vipe_tpu_torch.ops.resize import resize_align_corners
    from vipe_tpu_torch.priors.depth.dav2 import preprocess

    x = preprocess(rgb[None], INPUT_SIZE)
    return resize_align_corners(_stub_net(x)[:, None], (H, W))[0, 0].numpy()


def _depth_of(disp, rng):
    """A metric depth that an affine map of ``disp`` explains, with 2 %
    noise."""
    return (1.0 / (0.8 * disp + 0.1) * (1 + 0.02 * rng.standard_normal(disp.shape))
            ).astype(np.float32)


def _slam_output_np():
    """One dense keyframe grid back-projected from the identity camera
    (every image cell hit: coverage 1) and identity poses, as in
    ``tests/test_full_pipeline_e2e.py``'s PriorDA branch test, as numpy;
    the map's depth is one that the stub coarse net's disparity of the
    static frames explains."""
    rng = np.random.default_rng(0)
    uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    z = _depth_of(_stub_disparity(_static_frames()[0]), rng)
    xyz = np.stack([(uu - W / 2) / FOCAL * z, (vv - H / 2) / FOCAL * z, z],
                   -1).astype(np.float32)[None]
    traj = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32), (T_PROC, 1))
    return dict(xyz=xyz, rgb=np.zeros((1, H, W, 3), np.float32), mask=np.ones((1, H, W), bool),
                frame_inds=np.zeros(1, np.int32), trajectory=traj,
                intrinsics=np.asarray([FOCAL, FOCAL, W / 2, H / 2], np.float32))


def _prompt_case(seed=0):
    """A predicted disparity and a sparse prompt: a 5-px grid (ties
    everywhere) plus scattered pixels."""
    rng = np.random.default_rng(seed)
    pred = (0.3 + rng.random((H, W))).astype(np.float32)
    mask = np.zeros((H, W), bool)
    mask[::5, ::5] = True
    mask[rng.integers(0, H, 40), rng.integers(0, W, 40)] = True
    sparse = np.where(mask, 0.2 + rng.random((H, W)), 0.0).astype(np.float32)
    return pred, sparse, mask


def _conditioning(pred, mask, K=5):
    """Per pixel, the condition number of the weighted 2×2 system of the
    KNN completion (f64, the port's neighbours)."""
    from vipe_tpu_torch.ops.knn import knn

    vy, vx = np.nonzero(mask)
    qy, qx = np.meshgrid(np.arange(pred.shape[0]), np.arange(pred.shape[1]), indexing="ij")
    d2, idx = knn(torch.tensor(np.stack([qx.ravel(), qy.ravel()], -1), dtype=torch.float32),
                  torch.tensor(np.stack([vx, vy], -1), dtype=torch.float32), K)
    pr = np.asarray(pred, np.float64)[vy, vx][idx.numpy()] + 1e-5 * np.arange(1, K + 1)
    w = 1.0 / np.sqrt(np.maximum(d2.numpy().astype(np.float64), 1e-8))
    w /= w.sum(1, keepdims=True)
    A = np.stack([np.stack([(w * pr * pr).sum(1), (w * pr).sum(1)], -1),
                  np.stack([(w * pr).sum(1), w.sum(1)], -1)], -2)
    return np.linalg.cond(A).reshape(pred.shape)


def _held(ref, got, cond, what):
    """``got`` within 1e-4 of the largest ``ref`` on the well-conditioned
    pixels; prints the worst of the others."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    good = cond < COND_MAX
    assert good.mean() > 0.5, f"{what}: only {good.mean():.2f} of the pixels well conditioned"
    err = np.abs(ref - got) / np.abs(ref).max()
    assert err[good].max() < NET_RTOL, (what, err[good].max())
    if (~good).any():
        print(f"{what}: worst pixel with condition ≥ {COND_MAX:g}: {err[~good].max():.3g} "
              f"({int((~good).sum())} pixels)")


# ------------------------------------------------------ the JAX references


def _jax_models(w):
    """The JAX package's small models on the seeded weights: VDA-S,
    UniDepth-S with the 64-wide decoder, PriorDA coarse-only and with the
    fine stage (ViT-S; both run the stub coarse net)."""
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.priors.depth import priorda as jpriorda
    from vipe_tpu.priors.depth import unidepth as jud
    from vipe_tpu.priors.depth.videodepthanything import VideoDepthAnythingModel

    vda = VideoDepthAnythingModel("vits", input_size=INPUT_SIZE,
                                  params=jconvert.convert_vda(w["vda"]))
    ud = jud.UniDepthModel("s", params=jconvert.convert_unidepth(w["unidepth"]), **UNIDEPTH_BOUNDS)
    ud.net = jud.UniDepthNet("vits", ud.net.params, cfg=jud.UniDepthConfig(**UNIDEPTH_NARROW))
    pda = {}
    for coarse_only in (True, False):
        pda[coarse_only] = jpriorda.PriorDAModel(
            "vits", INPUT_SIZE, 5, params=jconvert.convert_dav2(w["dav2"]),
            coarse_only=coarse_only, fine_params=jconvert.convert_dav2(w["dav2_cond"]),
            fine_variant="vits")
        pda[coarse_only].net = lambda x: 1.0 + 0.2 * jnp.mean(x, -1)  # the stub coarse net
    return vda, ud, pda


def _jax_modules_job():
    """Flax ``apply`` of the f32 modules and nets on the seeded weights."""
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.models.dpt import DPTHead as JDPTHead
    from vipe_tpu.models.temporal import TemporalModule as JTemporalModule
    from vipe_tpu.priors.depth.dav2 import DepthAnythingV2Net as JDAv2Net

    w = _weights()
    out = {}
    tm_sd, x = _temporal_case()
    tm = JTemporalModule(64)
    out["temporal"] = np.asarray(jax.jit(lambda p, x: tm.apply(p, x, 4))(
        {"params": jconvert.convert_vda_motion(tm_sd, "m.temporal_transformer")}, jnp.asarray(x)))
    for name, metric in (("dav2", False), ("dav2_metric", True)):
        taps, ph, pw = _head_case()
        head = JDPTHead(64, (48, 96, 192, 384), is_metric=metric)
        params = jconvert.convert_dpt_head(w[name], "depth_head")
        apply = jax.jit(lambda p, t: head.apply(p, t, ph, pw))  # noqa: B023
        out[f"head_{name}"] = np.asarray(apply(params, [tuple(map(jnp.asarray, t)) for t in taps]))
    img, cond = _net_inputs()
    for name, cond_dim in (("dav2", 0), ("dav2_cond", 3)):
        net = JDAv2Net("vits", params=jconvert.convert_dav2(w[name]), cond_dim=cond_dim)
        out[f"net_{name}"] = np.asarray(net(jnp.asarray(img),
                                            jnp.asarray(cond) if cond_dim else None))
    return out


def _jax_vda_net_job():
    """Flax ``apply`` of the VDA-S net (ViT and temporal head) in f32."""
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.priors.depth.videodepthanything import VideoDepthAnythingNet as JVDANet

    vnet = JVDANet("vits", params=jconvert.convert_vda(_weights()["vda"]))
    return np.asarray(jax.jit(lambda p, c: vnet.head.apply(
        p["head"], vnet.vit.apply(p["vit"], c, tap_layers=vnet.taps), 5, 5, 32))(
        vnet.params, jnp.asarray(_clip())))


def _port_unidepth():
    """The port's UniDepth-S with the 64-wide decoder, on the CPU."""
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthConfig, UniDepthModel

    return UniDepthModel("s", state_dict=_torch_sd(_weights()["unidepth"]), device="cpu",
                         cfg=UniDepthConfig(**UNIDEPTH_NARROW), **UNIDEPTH_BOUNDS)


def _unidepth_batch_inputs(m, focal):
    """The port's batch inputs for ``_unidepth_frames``: the net's input
    (NCHW), the rays (or None), the padded shape and the pads."""
    with torch.no_grad():
        rs, rays, hw_pad, pads = m._batch_inputs(_unidepth_frames(), focal)
        x = m._net_input(rs)
    return x, (None if rays is None else rays[None].expand(len(x), -1, -1, -1)), hw_pad, pads


def _unidepth_frames():
    return _frames(3, 7)


def _jax_unidepth_job():
    """The JAX package's f32 UniDepth net on the port's own batch inputs
    (the uint8-rounded, normalised frames and the rays of the focal, or
    the predicted camera), and its resize to the padded shape and crop
    (``_jit_infer``'s) of that depth."""
    _, ud, _ = _jax_models(_weights())
    m = _port_unidepth()
    out = {}
    for focal in (FOCAL, None):
        x, rays, (hp, wp), (pl, pr, pt, pb) = _unidepth_batch_inputs(m, focal)
        depth = ud.net(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                       None if rays is None else jnp.asarray(rays.numpy()))["depth"]
        post = jax.image.resize(depth.astype(jnp.float32), (len(x), hp, wp), "bilinear")
        out[focal] = np.asarray(depth), np.asarray(post[:, pt:hp - pb, pl:wp - pr])
    return out


def _jax_priorda_job():
    """PriorDA's KNN completion, ``complete_batch`` coarse and fine, and the
    fine stage's inputs and net output from the JAX package's own coarse
    results."""
    from vipe_tpu.priors.depth import priorda as jpriorda

    _, _, pda = _jax_models(_weights())
    out = {"kss": np.asarray(jpriorda.knn_scale_shift_completion(*_prompt_case(), 5))}
    rgbs, prompts = _priorda_case()
    for coarse_only, m in pda.items():
        out["priorda", coarse_only] = m.complete_batch(rgbs, prompts)
    # the fine stage of the prompted frames from the JAX package's own
    # coarse results (one stacked forward, as complete_batch runs it)
    m, args, imgs, conds, norms = pda[False], [], [], [], []
    for k in (0, 1):
        args.append(m._coarse_align(_stub_disparity(rgbs[k]), prompts[k], (H, W))[1])
        img, cond, masked_min, denom = m._fine_inputs(rgbs[k], *args[-1])
        imgs.append(img)
        conds.append(cond)
        norms.append((masked_min, denom))
    disp = np.asarray(m.fine_net(jnp.asarray(np.stack(imgs)), jnp.asarray(np.stack(conds))))
    out["priorda_fine"] = list(zip(args, conds, imgs, disp))
    # the frames' fine output from that net output: the align-corners
    # resize and the un-normalisation by each prompt's range
    m.fine_net = lambda img, cond: jnp.asarray(disp)
    out["priorda_fine_post"] = norms, m._fine_forward_batch(imgs, conds, norms, (H, W))
    return out


def _jax_video_job():
    """The JAX package's VDA video inference and the processor on its small
    models (held in its model cache, where the processor looks them up)."""
    import os

    from vipe_tpu.models import model_cache as jcache
    from vipe_tpu.ops.cameras import CameraType
    from vipe_tpu.pipeline.processors import AdaptiveDepthProcessor
    from vipe_tpu.priors.depth.priorda import PriorDAModel
    from vipe_tpu.priors.depth.videodepthanything import VideoDepthAnythingModel
    from vipe_tpu.slam.interface import SLAMMap, SLAMOutput
    from vipe_tpu.streams.base import VideoFrame

    os.environ["VIPE_WEIGHTS_DIR"] = os.devnull  # no weight files: PriorDA coarse only
    vda, ud, pda = _jax_models(_weights())
    out = {"vda_video": vda.infer_video_depth(_frames(40, 6))}
    s = _slam_output_np()
    slam_out = SLAMOutput(trajectory=s["trajectory"], intrinsics=s["intrinsics"],
                          camera_type=CameraType.PINHOLE,
                          slam_map=SLAMMap(s["xyz"], s["rgb"], s["mask"], s["frame_inds"]))
    jcache.cached_global(("depth_model", "unidepth-s"), lambda: ud)
    jcache.cached_global(("vda", VideoDepthAnythingModel, "vits"), lambda: vda)
    jcache.cached_global(("priorda", PriorDAModel, True), lambda: pda[True])
    for branch, thresh in (("metric", 1.5), ("priorda", 0.3)):
        proc = AdaptiveDepthProcessor("adaptive_unidepth-s_svda", slam_output=slam_out,
                                      coverage_thresh=thresh)
        frames = [VideoFrame(raw_frame_idx=k, rgb=rgb, intrinsics=s["intrinsics"].copy(),
                             mask=_valid_mask()) for k, rgb in enumerate(_static_frames())]
        depths = [f.metric_depth for f in proc.update_iterator(iter(frames))]
        out["proc", branch] = (proc._use_metric,
                               proc._coverage_score((H, W), s["intrinsics"]), np.stack(depths))
    out["pipeline"] = _run_pipeline("jax")
    return out


RIG = np.asarray([[0, 0, 0, 0, 0, 0, 1], [0.02, 0, 0, 0, 0, 0, 1]], np.float32)


def _run_pipeline(pkg):
    """``DefaultAnnotationPipeline`` of ``pkg`` ("jax" or "port") with
    ``adaptive_unidepth-s_svda``, its SLAM stubbed to return the map and
    identity poses of ``_slam_output_np`` (per view for a rig), on the
    static frames alone and as a 2-view rig (view 1 2 cm to the right), its
    small models in the package's model cache; returns {run: (the artifact
    tree, {view: depths read back by ``vipe_tpu``'s reader})}."""
    import tempfile

    from vipe_tpu.utils import io as jio

    if pkg == "jax":
        import vipe_tpu.pipeline.default as default
        from vipe_tpu.ops.cameras import CameraType
        from vipe_tpu.slam.interface import SLAMMap, SLAMOutput
        from vipe_tpu.streams.base import (FrameAttribute, MultiviewVideoList, VideoFrame,
                                           VideoStream)
        kw = {}
    else:
        import vipe_tpu_torch.pipeline.default as default
        from vipe_tpu_torch.ops.cameras import CameraType
        from vipe_tpu_torch.slam.interface import SLAMMap, SLAMOutput
        from vipe_tpu_torch.streams.base import (FrameAttribute, MultiviewVideoList, VideoFrame,
                                                 VideoStream)
        kw = {"device": "cpu"}
    s = _slam_output_np()

    class Static(VideoStream):
        def __init__(self, name):
            self._name = name

        def __len__(self):
            return T_PROC

        def frame_size(self):
            return (H, W)

        def fps(self):
            return 10.0

        def attributes(self):
            return {FrameAttribute.RGB}

        def __iter__(self):
            for k, rgb in enumerate(_static_frames()):
                yield VideoFrame(raw_frame_idx=k, rgb=rgb)

    class StubSLAM:
        def __init__(self, *a, **k):
            pass

        def run(self, stream, camera_type=None):
            views = len(stream) if isinstance(stream, MultiviewVideoList) else 1
            for frames in stream:
                for _ in (frames if views > 1 else [frames]):
                    pass
            return SLAMOutput(
                trajectory=s["trajectory"], camera_type=CameraType.PINHOLE,
                intrinsics=s["intrinsics"] if views == 1 else np.stack([s["intrinsics"]] * views),
                slam_map=SLAMMap(s["xyz"], s["rgb"], s["mask"], s["frame_inds"]),
                rig=RIG if views > 1 else None)

    orig, default.SLAMSystem = default.SLAMSystem, StubSLAM
    out = {}
    try:
        for run in ("rig",):
            root = tempfile.mkdtemp()
            pipe = default.DefaultAnnotationPipeline(
                init={"intrinsics": "fov"}, post={"depth_align_model": "adaptive_unidepth-s_svda"},
                output={"path": root}, **kw)
            pipe.run(MultiviewVideoList("rig", [Static("cam0"), Static("cam1")], RIG))
            tree = sorted(str(p.relative_to(root)) for p in __import__("pathlib").Path(
                root).rglob("*") if p.is_file())
            out[run] = tree, {n: np.stack(list(jio.read_depth_artifacts(jio.ArtifactPath(
                root, n)))) for n in ("cam0", "cam1")}
    finally:
        default.SLAMSystem = orig
    return out


def _temporal_case():
    """A ``TemporalModule(64)`` with every weight off its init (the port's
    module, as a numpy state dict under ``m.``) and a (2·4, 3, 5, 64)
    NHWC input."""
    from vipe_tpu_torch.models.temporal import TemporalModule
    from vipe_tpu_torch.models.vit import init_seeded_

    rng = np.random.default_rng(3)
    tm = TemporalModule(64)
    init_seeded_(tm, 3)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if p.dim() == 1:  # norms' scales and every bias off their init
                p.copy_(torch.as_tensor(1.0 * (name.endswith("weight")) + 0.3
                                        * rng.standard_normal(p.shape).astype(np.float32)))
    sd = {f"m.{k}": v for k, v in _np_sd(tm).items()}
    return sd, rng.standard_normal((8, 3, 5, 64)).astype(np.float32)


def _head_case():
    """Four taps of ViT-S width on a 5×6 patch grid."""
    rng = np.random.default_rng(4)
    taps = [(rng.standard_normal((2, 30, 384)).astype(np.float32),
             rng.standard_normal((2, 384)).astype(np.float32)) for _ in range(4)]
    return taps, 5, 6


def _net_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2, 70, 98, 3)).astype(np.float32),
            rng.standard_normal((2, 70, 98, 3)).astype(np.float32))


def _clip():
    return np.random.default_rng(6).standard_normal((32, 70, 70, 3)).astype(np.float32)


def _priorda_case():
    """Three frames and prompts: a depth that the stub coarse net's
    disparity explains, on a 4-px grid and 20 scattered pixels; the third
    prompt is empty (a NaN frame)."""
    rng = np.random.default_rng(8)
    rgbs = _frames(3, 9)
    prompts = []
    for k in range(3):
        p = np.zeros((H, W), np.float32)
        if k < 2:
            depth = _depth_of(_stub_disparity(rgbs[k]), rng)
            keep = np.zeros((H, W), bool)
            keep[::4, ::4] = True
            keep[rng.integers(0, H, 20), rng.integers(0, W, 20)] = True
            p[keep] = depth[keep]
        prompts.append(p)
    return rgbs, prompts


# two processes, each running its jobs in order
_JAX_NETS = BackgroundJax({"modules": (_jax_modules_job, ()), "vda_net": (_jax_vda_net_job, ()),
                           "priorda": (_jax_priorda_job, ()),
                           "unidepth": (_jax_unidepth_job, ())})
_JAX_VIDEO = BackgroundJax({"video": (_jax_video_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_NETS.start()
    _JAX_VIDEO.start()
    yield
    _JAX_NETS.stop()
    _JAX_VIDEO.stop()


# ------------------------------------------- host code (JAX in this process)


@pytest.mark.parametrize("case", ["grid_k5", "grid_k1", "duplicates_k5", "few_points_k5"])
def test_knn_matches_jax(case, monkeypatch):
    """Indices and squared distances exactly equal, ties included: every
    query of a 48×64 image against a 5-px grid (ties everywhere), against
    points with duplicates, and against 6 points; the distances made 1000
    queries at a time, so that the queries span several chunks."""
    from vipe_tpu.ops.knn import knn as jknn
    from vipe_tpu_torch.ops import knn as knn_mod
    from vipe_tpu_torch.ops.knn import knn

    rng = np.random.default_rng(len(case))
    qy, qx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    queries = np.stack([qx.ravel(), qy.ravel()], -1).astype(np.float32)
    if case.startswith("grid"):
        gy, gx = np.meshgrid(np.arange(0, H, 5), np.arange(0, W, 5), indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel()], -1)
    elif case.startswith("duplicates"):
        pts = rng.integers(0, (W, H), (60, 2))
        pts = np.concatenate([pts, pts[::3]])
    else:
        pts = rng.integers(0, (W, H), (6, 2))
    pts = pts.astype(np.float32)
    k = int(case[-1])
    monkeypatch.setattr(knn_mod, "CHUNK_PAIRS", 1000 * len(pts))
    jd, ji = jknn(jnp.asarray(queries), jnp.asarray(pts), k)
    td, ti = knn(torch.from_numpy(queries), torch.from_numpy(pts), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_knn_infill_and_projected_infill_match_jax():
    from vipe_tpu.ops.knn import knn_infill_depth as jinfill
    from vipe_tpu.ops.cameras import CameraType as JCam
    from vipe_tpu.slam.interface import SLAMMap as JMap
    from vipe_tpu_torch.ops.cameras import CameraType
    from vipe_tpu_torch.ops.knn import knn_infill_depth
    from vipe_tpu_torch.slam.interface import SLAMMap

    rng = np.random.default_rng(1)
    depth = np.zeros((H, W), np.float32)
    depth[::7, ::6] = rng.uniform(1, 3, depth[::7, ::6].shape)
    np.testing.assert_array_equal(knn_infill_depth(depth), jinfill(depth))
    s = _slam_output_np()
    keep = rng.random(s["mask"].shape) < 0.05
    args = (np.asarray([0.02, -0.01, 0.0, 0.0, 0.0, 0.0, 1.0], np.float32), s["intrinsics"])
    got = SLAMMap(s["xyz"], s["rgb"], keep, s["frame_inds"]).project_map(
        *args, CameraType.PINHOLE, (H, W), frame_idx=0, knn_infill=True)
    ref = JMap(s["xyz"], s["rgb"], keep, s["frame_inds"]).project_map(
        *args, JCam.PINHOLE, (H, W), frame_idx=0, knn_infill=True)
    assert (got > 0).mean() > 2 * (keep.mean())  # the infill filled
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("camera", ["pinhole", "panorama"])
def test_uv_coverage_score_matches_jax(camera):
    from vipe_tpu.ops.cameras import CameraType as JCam
    from vipe_tpu.slam.interface import SLAMMap as JMap
    from vipe_tpu_torch.ops.cameras import CameraType
    from vipe_tpu_torch.slam.interface import SLAMMap

    rng = np.random.default_rng(2)
    s = _slam_output_np()
    scores = []
    for frac in (0.002, 1.0):
        keep = rng.random(s["mask"].shape) < frac
        for tx in (0.0, -0.8):
            pose = np.asarray([tx, 0.05, 0.0, 0.0, 0.0, 0.0, 1.0], np.float32)
            got = SLAMMap(s["xyz"], s["rgb"], keep, s["frame_inds"]).uv_coverage_score(
                pose, s["intrinsics"], CameraType(camera), (H, W), frame_idx=0)
            ref = JMap(s["xyz"], s["rgb"], keep, s["frame_inds"]).uv_coverage_score(
                pose, s["intrinsics"], JCam(camera), (H, W), frame_idx=0)
            assert got == ref
            scores.append(got)
    assert len(set(scores)) > 2  # the cases span several scores


def test_alignment_matches_jax():
    from vipe_tpu.priors.depth import alignment as ja
    from vipe_tpu_torch.priors.depth import alignment as ta

    rng = np.random.default_rng(3)
    disp = rng.uniform(0.1, 2.0, (H, W)).astype(np.float32)
    depth = (1.0 / (0.7 * disp + 0.2) * rng.uniform(0.95, 1.05, (H, W))).astype(np.float32)
    depth[:5] = 0.0
    mask = rng.random((H, W)) > 0.2
    for m in (None, mask, np.zeros((H, W), bool)):
        assert ta.align_inv_depth_to_depth(disp, depth, m) == ja.align_inv_depth_to_depth(
            disp, depth, m)
        assert ta.align_depth_to_depth(disp, depth, m) == ja.align_depth_to_depth(disp, depth, m)
    s, b = ta.align_inv_depth_to_depth(disp, depth, mask)
    assert abs(s - 0.7) < 0.05 and abs(b - 0.2) < 0.05
    np.testing.assert_array_equal(ta.apply_inv_depth_alignment(disp, s, b),
                                  ja.apply_inv_depth_alignment(disp, s, b))


def test_stitch_depth_windows_matches_jax():
    """Three windows of 32 frames that differ by affine drifts."""
    from vipe_tpu.priors.depth import videodepthanything as jv
    from vipe_tpu_torch.priors.depth import videodepthanything as tv

    rng = np.random.default_rng(4)
    depth_list = [((rng.random((6, 7)) + 0.5) * (1 + 0.3 * (k // 32)) + 0.1 * (k // 32))
                  .astype(np.float32) for k in range(96)]
    got = tv.stitch_depth_windows(depth_list, 70)
    np.testing.assert_array_equal(got, jv.stitch_depth_windows(depth_list, 70))
    assert got.shape == (70, 6, 7)
    assert tv.compute_scale_and_shift(depth_list[0], depth_list[40]) == \
        jv.compute_scale_and_shift(depth_list[0], depth_list[40])


@pytest.mark.parametrize("hw", [(48, 64), (720, 1280), (37, 23)])
def test_preprocess_matches_cv2(hw):
    """The device's bicubic resize against the JAX package's
    ``cv2.INTER_CUBIC``: DAv2's normalised float input and VDA's uint8
    pixels (at most one step, rarely)."""
    from vipe_tpu.priors.depth.dav2 import preprocess as jpre
    from vipe_tpu.priors.depth.videodepthanything import preprocess_u8 as jpre_u8
    from vipe_tpu_torch.priors.depth.dav2 import preprocess
    from vipe_tpu_torch.priors.depth.videodepthanything import preprocess_u8

    rgb = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,)).astype(np.float32) / 255.0
    ref, _ = jpre(rgb, INPUT_SIZE)
    got = preprocess(rgb[None], INPUT_SIZE)[0].permute(1, 2, 0).numpy()
    assert got.shape == ref.shape
    # normalised values: 1/0.225 per unit of the [0, 1] range
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-4 / 0.225)
    ref8 = jpre_u8(rgb, INPUT_SIZE).astype(np.int32)
    got8 = preprocess_u8(torch.from_numpy(rgb)[None], INPUT_SIZE)[0].permute(1, 2, 0)
    diff = np.abs(got8.numpy().astype(np.int32) - ref8)
    assert diff.max() <= 1 and diff.mean() < 1e-2


def test_converters_invert_jax_ones():
    """``dav2_state_dict_from_flax`` (plain and conditioned) and
    ``vda_state_dict_from_flax`` give back the synthetic ViPE state dicts
    (``refinenet4``'s unused ``resConfUnit1`` aside), which load
    ``strict=True``; the ViPE keys the port's nets do not hold are exactly
    that unit's."""
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu_torch.priors.depth.dav2 import DepthAnythingV2Net
    from vipe_tpu_torch.priors.depth.videodepthanything import VideoDepthAnythingNet

    cases = [("plain", _synthetic("plain"), jconvert.convert_dav2,
              tconvert.dav2_state_dict_from_flax, lambda: DepthAnythingV2Net("vits")),
             ("cond", _synthetic("cond"), jconvert.convert_dav2,
              tconvert.dav2_state_dict_from_flax, lambda: DepthAnythingV2Net("vits", cond_dim=3)),
             ("vda", _synthetic("vda"), jconvert.convert_vda,
              tconvert.vda_state_dict_from_flax, lambda: VideoDepthAnythingNet("vits"))]
    for name, sd, to_flax, from_flax, make in cases:
        got = from_flax(to_flax(sd))
        unused = {k for k in sd if ".refinenet4.resConfUnit1." in k}
        assert len(unused) == 4 and set(got) == set(sd) - unused, name
        for k, v in got.items():
            assert v.dtype == torch.float32 and np.array_equal(v.numpy(), sd[k]), (name, k)
        with torch.device("meta"):
            net = make()
        net.to_empty(device="cpu").load_state_dict(got, strict=True)


@functools.lru_cache(maxsize=None)
def _synthetic(name):
    """The 0.02-scale synthetic ViPE state dicts (numpy) of
    ``tests/test_dav2.py``: "plain", "cond" (``cond_dim`` 3) and "vda" (the
    DAv2 one under ``head.`` and the four motion modules)."""
    rng = np.random.default_rng(len(name))
    if name == "vda":
        return _synthetic_vda_sd(rng)
    return make_synthetic_dav2_sd(rng, cond_dim=3 if name == "cond" else 0)


def _synthetic_vda_sd(rng):
    sd = make_synthetic_dav2_sd(rng, head_prefix="head")

    def add(key, shape):
        sd[key] = rng.normal(size=shape).astype(np.float32) * 0.02

    for m, C in enumerate((192, 384, 64, 64)):
        t = f"head.motion_modules.{m}.temporal_transformer"
        add(f"{t}.norm.weight", (C,))
        add(f"{t}.norm.bias", (C,))
        add(f"{t}.proj_in.weight", (C, C))
        add(f"{t}.proj_in.bias", (C,))
        b = f"{t}.transformer_blocks.0"
        for i in range(2):
            a = f"{b}.attention_blocks.{i}"
            for name in ("to_q", "to_k", "to_v", "to_out.0"):
                add(f"{a}.{name}.weight", (C, C))
            add(f"{a}.to_out.0.bias", (C,))
            add(f"{b}.norms.{i}.weight", (C,))
            add(f"{b}.norms.{i}.bias", (C,))
        add(f"{b}.ff_norm.weight", (C,))
        add(f"{b}.ff_norm.bias", (C,))
        add(f"{b}.ff.net.0.proj.weight", (8 * C, C))
        add(f"{b}.ff.net.0.proj.bias", (8 * C,))
        add(f"{b}.ff.net.2.weight", (C, 4 * C))
        add(f"{b}.ff.net.2.bias", (C,))
        add(f"{t}.proj_out.weight", (C, C))
        add(f"{t}.proj_out.bias", (C,))
    return sd


def test_zoo_reads_depth_families(tmp_path, monkeypatch):
    """``priorda`` from a ViPE ``.pth`` (with keys the nets do not hold) and
    ``priorda_fine`` from the JAX package's flax tree as ``.npz`` (the DAv2
    and VDA families read the same way, with the converters of
    ``test_converters_invert_jax_ones``); ``has_weights`` sees only the
    directory."""
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.models.zoo import flatten_tree
    from vipe_tpu_torch.priors.depth.priorda import PriorDAModel

    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))
    plain, cond = _synthetic("plain"), _synthetic("cond")
    assert not zoo.has_weights("priorda") and zoo.load_state_dict("dav2_vits") is None
    torch.save({"model": _torch_sd({**plain, "pretrained.mask_token": np.zeros((1, 384))})},
               tmp_path / "priorda.pth")
    np.savez(tmp_path / "priorda_fine.npz", **flatten_tree(jconvert.convert_dav2(cond)))
    assert zoo.has_weights("priorda") and zoo.has_weights("priorda_fine")
    assert not zoo.has_weights("vda_vits")
    model = PriorDAModel(device="cpu")  # the ViT size comes from the weights
    assert model.net.variant == model.fine_net.variant == "vits"
    for net, sd in ((model.net, plain), (model.fine_net, cond)):
        own = net.state_dict()
        assert all(np.array_equal(own[k].numpy(), v) for k, v in sd.items() if k in own)
    assert zoo.load_state_dict("metric3d_small") is None  # a family, without a file here


def test_factory_builds_depth_families_once_per_device():
    from vipe_tpu_torch.priors.depth.dav2 import DepthAnythingV2Model
    from vipe_tpu_torch.priors.depth.factory import make_depth_model
    from vipe_tpu_torch.priors.depth.videodepthanything import VideoDepthAnythingModel

    try:
        for name, cls, variant in (("dav2-vits", DepthAnythingV2Model, "vits"),
                                   ("vda-vits", VideoDepthAnythingModel, "vits"),
                                   ("videodepthanything-vits", VideoDepthAnythingModel, "vits")):
            m = make_depth_model(name, device="cpu")
            assert isinstance(m, cls) and make_depth_model(name, device="cpu") is m
            assert m.depth_type.name == "AFFINE_DISP" and m.device == torch.device("cpu")
        m = make_depth_model("metric3d-small", device="cpu")
        assert m.depth_type.name == "METRIC_DEPTH" and make_depth_model(
            "metric3d-small", device="cpu") is m
    finally:
        model_cache.clear()


def test_dav2_estimate_is_resized_net_output():
    """``DepthAnythingV2Model.estimate``: the net on the preprocessed frame,
    align-corners back to the frame's size; a metric checkpoint scales the
    sigmoid by its max depth."""
    from vipe_tpu_torch.ops.resize import resize_align_corners
    from vipe_tpu_torch.priors.depth.dav2 import DepthAnythingV2Model, preprocess

    rgb = _frames(1)[0]
    for ckpt, name in (("metric-indoor", "dav2_metric"),):
        m = DepthAnythingV2Model("vits", ckpt, INPUT_SIZE, _torch_sd(_weights()[name]),
                                 device="cpu")
        with torch.no_grad():
            ref = resize_align_corners(m.net(preprocess(rgb[None], INPUT_SIZE))[:, None],
                                       (H, W))[0, 0]
        got = m.estimate_depth(rgb)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        if ckpt == "metric-indoor":
            assert m.depth_type.name == "METRIC_DEPTH" and float(got.max()) <= 20.0


# ------------------------------------------ the nets (JAX in the background)


def _port_vda(dtype):
    from vipe_tpu_torch.priors.depth.videodepthanything import VideoDepthAnythingModel

    return VideoDepthAnythingModel("vits", INPUT_SIZE, _torch_sd(_weights()["vda"]),
                                   device="cpu", dtype=dtype)


_port_vdas = functools.lru_cache(maxsize=None)(_port_vda)


def test_vda_bf16_within_f32():
    """The port's VDA-S in bf16 (autocast) against its f32 net on one
    window; with ``out_hw`` the output is the f32 one resized and rounded
    to f16."""
    clip = torch.from_numpy(_clip()).permute(0, 3, 1, 2)
    f32 = _port_vdas(torch.float32).forward(clip)
    b16 = _port_vdas(torch.bfloat16).forward(clip)
    f16 = _port_vdas(torch.float32).forward(clip, (H, W))
    assert b16.dtype == torch.float32 and _rel(f32, b16) < BF16_RTOL
    from vipe_tpu_torch.ops.resize import resize_align_corners

    assert f16.dtype == torch.float16 and f16.shape == (32, H, W)
    torch.testing.assert_close(f16, resize_align_corners(f32[:, None], (H, W))[:, 0].half(),
                               rtol=0, atol=0)


def test_temporal_module_matches_jax():
    from vipe_tpu_torch.models.temporal import TemporalModule

    sd, x = _temporal_case()
    tm = TemporalModule(64)
    tm.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    ref = _JAX_NETS.result("modules")["temporal"]
    assert _rel(ref, got.numpy()) < NET_RTOL
    assert _rel(x, got.numpy()) > 0.1  # the module is not the identity


@pytest.mark.parametrize("name", ["dav2", "dav2_metric"])
def test_dpt_head_matches_jax(name):
    from vipe_tpu_torch.models.dpt import DPTHead

    taps, ph, pw = _head_case()
    head = DPTHead(384, 64, (48, 96, 192, 384), is_metric=name == "dav2_metric")
    sd = {k[len("depth_head."):]: v for k, v in _torch_sd(_weights()[name]).items()
          if k.startswith("depth_head.")}
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = head([tuple(map(torch.from_numpy, t)) for t in taps], ph, pw)
    ref = _JAX_NETS.result("modules")[f"head_{name}"]
    assert got.shape == ref.shape == (2, 70, 84) and _rel(ref, got.numpy()) < NET_RTOL
    assert ref.std() > 1e-3 * np.abs(ref).max()  # the output is not flat


@pytest.mark.parametrize("name", ["dav2", "dav2_cond"])
def test_dav2_net_matches_jax(name):
    from vipe_tpu_torch.priors.depth.dav2 import build_dav2_net

    cond_dim = 3 if name == "dav2_cond" else 0
    net = build_dav2_net("vits", _torch_sd(_weights()[name]), cond_dim=cond_dim)
    img, cond = _net_inputs()
    with torch.no_grad():
        got = net(torch.from_numpy(img).permute(0, 3, 1, 2),
                  torch.from_numpy(cond).permute(0, 3, 1, 2) if cond_dim else None)
    ref = _JAX_NETS.result("modules")[f"net_{name}"]
    assert got.shape == ref.shape == (2, 70, 98) and _rel(ref, got.numpy()) < NET_RTOL
    assert ref.std() > 1e-3 * np.abs(ref).max()


def test_vda_net_matches_jax():
    got = _port_vdas(torch.float32).forward(torch.from_numpy(_clip()).permute(0, 3, 1, 2))
    ref = _JAX_NETS.result("vda_net")
    assert got.shape == ref.shape == (32, 70, 70) and _rel(ref, got.numpy()) < NET_RTOL
    assert ref.std() > 1e-3 * np.abs(ref).max()


def test_knn_scale_shift_completion_matches_jax():
    from vipe_tpu_torch.priors.depth.priorda import knn_scale_shift_completion

    pred, sparse, mask = _prompt_case()
    got = knn_scale_shift_completion(pred, sparse, mask, 5)
    ref = _JAX_NETS.result("priorda")["kss"]
    np.testing.assert_array_equal(got.numpy()[mask], ref[mask])
    _held(ref, got.numpy(), _conditioning(pred, mask), "knn_scale_shift_completion")


@pytest.mark.parametrize("coarse_only", [True, False])
def test_priorda_complete_batch_matches_jax(coarse_only, monkeypatch):
    """``complete_batch`` of both packages on two prompted frames and an
    empty prompt (NaN on both).  The seeded DAv2 predicts a nearly flat
    disparity, on which every pixel's 2×2 system is ill-conditioned; so
    both sides run the same stub coarse net, 1 + 0.2·(channel mean of the
    normalised image) (the DAv2 net itself is held in
    ``test_dav2_net_matches_jax``); the fine stage's net is the seeded
    conditioned DAv2.  Coarse: equal on the well-conditioned pixels.
    Fine: its inputs from the JAX package's coarse results (the condition
    within 1e-6, the image within the preprocessing tolerance), the
    conditioned net on the JAX package's inputs (1e-4) and the frames'
    output from the JAX package's net output (the resize and the
    un-normalisation, ``POST_RTOL``) are held, each on the same
    inputs on both sides; the frames' fine output of the whole chain is
    not, since the condition's third channel, 1/((depth − min)/range),
    and the final 1/disparity amplify the coarse stage's ill-conditioned
    pixels (measured 3.2e-2 of the largest depth)."""
    from vipe_tpu_torch.priors.depth import priorda

    seen = []
    orig = priorda.knn_scale_shift_completion

    def spy(pred, sparse, mask, K=5):
        seen.append((pred.cpu().numpy(), mask))
        return orig(pred, sparse, mask, K)

    monkeypatch.setattr(priorda, "knn_scale_shift_completion", spy)
    w = _weights()
    m = priorda.PriorDAModel("vits", INPUT_SIZE, 5, _torch_sd(w["dav2"]), coarse_only,
                             _torch_sd(w["dav2_cond"]), "vits", device="cpu")
    m.net = _stub_net
    rgbs, prompts = _priorda_case()
    got = m.complete_batch(rgbs, prompts)
    ref = _JAX_NETS.result("priorda")["priorda", coarse_only]
    assert len(seen) == 2 and np.isnan(got[2]).all() and np.isnan(ref[2]).all()
    for k, (pred, mask) in enumerate(seen):
        assert got[k].shape == (H, W) and np.isfinite(got[k]).all()
        # the coarse stage's system conditions every pixel of the frame
        # the fine stage sees through its normalised condition
        if coarse_only:
            _held(ref[k], got[k], _conditioning(pred, mask), f"PriorDA coarse, frame {k}")
    if not coarse_only:
        for k, (args, cond, img, disp) in enumerate(_JAX_NETS.result("priorda")["priorda_fine"]):
            t_img, t_cond, _, _ = m._fine_inputs(rgbs[k], *args)
            assert _rel(cond, t_cond[0].permute(1, 2, 0).numpy()) < 1e-6
            np.testing.assert_allclose(t_img[0].permute(1, 2, 0).numpy(), img, rtol=0,
                                       atol=3e-4 / 0.225)
            with torch.no_grad():
                t_disp = m.fine_net(torch.from_numpy(img[None]).permute(0, 3, 1, 2),
                                    torch.from_numpy(cond[None]).permute(0, 3, 1, 2))[0]
            assert _rel(disp, t_disp.numpy()) < NET_RTOL
        # the frames' fine output from the JAX package's net output
        norms, ref_post = _JAX_NETS.result("priorda")["priorda_fine_post"]
        disp = np.stack([d for _, _, _, d in _JAX_NETS.result("priorda")["priorda_fine"]])
        m.fine_net = lambda img, cond: torch.from_numpy(disp)
        post = m._fine_forward_batch([torch.zeros(1, 3, 1, 1)] * 2, [torch.zeros(1, 3, 1, 1)] * 2,
                                     norms, (H, W))
        for k in (0, 1):
            assert post[k].shape == ref_post[k].shape == (H, W) and post[k].dtype == np.float32
            assert np.isfinite(ref_post[k]).all() and ref_post[k].std() > 0
            assert _rel(ref_post[k], post[k]) < POST_RTOL, k


@pytest.mark.parametrize("hw", [(H, W), (20, 80)])
def test_unidepth_batch_preprocess_matches_cv2(hw):
    """The batch's preprocessing against the JAX package's: the frame on a
    canvas of the ImageNet mean (the 20×80 frame padded to the aspect
    ratio bounds), ``cv2.INTER_LINEAR`` to the net's size, rounded to
    uint8.  3e-4 of the pixel range in float, and in uint8 at most one
    step, on under 1 % of the pixels; the rays of the focal within 1e-6
    of the f64 camera's."""
    import cv2

    from vipe_tpu.priors.depth import unidepth as jud

    rgb = np.random.default_rng(hw[1]).integers(0, 256, hw + (3,)).astype(np.float32) / 255.0
    m = _port_unidepth()
    with torch.no_grad():
        rs, rays, (hp, wp), pads = m._batch_inputs([rgb, rgb[::-1].copy()], FOCAL)
        u8 = (m._net_input(rs) * m._std[:, None, None] + m._mean[:, None, None]) * 255.0
    (pl, pr, pt, pb), (jhp, jwp) = jud.get_paddings(hw, m.ratio_bounds)
    rf, (nh, nw) = jud.get_resize_factor((jhp, jwp), jud.resolution_level_bounds(
        m.pixels_min, m.pixels_max, m.resolution_level))
    assert (hp, wp, tuple(pads)) == (jhp, jwp, (pl, pr, pt, pb)) and rs.shape == (2, 3, nh, nw)
    assert hw == (H, W) or hp > hw[0]  # the wide frame is padded
    for k, frame in enumerate((rgb, rgb[::-1])):
        canvas = np.empty((hp, wp, 3), np.float32)
        canvas[:] = jud.IMAGENET_MEAN
        canvas[pt:hp - pb, pl:wp - pr] = frame
        ref = cv2.resize(canvas, (nw, nh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(rs[k].permute(1, 2, 0).numpy(), ref, rtol=0, atol=3e-4)
        ref8 = np.clip(np.round(ref * 255.0), 0, 255).astype(np.int32)
        got8 = u8[k].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got8, np.round(got8), rtol=0, atol=1e-3)  # uint8 pixels
        diff = np.abs(np.round(got8).astype(np.int32) - ref8)
        assert diff.max() <= 1 and diff.mean() < 1e-2
    v, u = np.meshgrid(np.arange(nh) + 0.5, np.arange(nw) + 0.5, indexing="ij")
    r = np.stack([(u - (hw[1] / 2 + pl) * rf) / (FOCAL * rf),
                  (v - (hw[0] / 2 + pt) * rf) / (FOCAL * rf), np.ones_like(u)], -1)
    np.testing.assert_allclose(rays.numpy(), r / np.linalg.norm(r, axis=-1, keepdims=True),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("focal", [FOCAL, None])
def test_unidepth_estimate_depth_batch_matches_jax(focal):
    """UniDepth-S (64-wide decoder) on three frames, given focal or
    predicted camera, held in parts on the same inputs on both sides: the
    port's f32 net on its own batch inputs within 1e-4 of the JAX
    package's f32 net on them; the port's resize and crop of the JAX
    package's net depth within ``POST_RTOL`` of the JAX package's; the
    port's f32 batch output within one f16 step, at every pixel, of the
    JAX package's chain rounded to f16, as its batch returns it.  The
    preprocessing is held in ``test_unidepth_batch_preprocess_matches_cv2``.
    The port's bf16 batch, the path that runs, within 5e-2 of its f32
    batch (one frame alone too, as the processor's fallback runs it)."""
    m = _port_unidepth()
    frames = _unidepth_frames()
    got = np.stack(m.estimate_depth_batch(frames, focal))
    f32 = np.stack(m.estimate_depth_batch(frames, focal, dtype=torch.float32))
    assert got.shape == (3, H, W) and np.isfinite(got).all()
    assert _rel(f32, got) < BF16_RTOL
    assert _rel(got[1], m.estimate_depth_batch(frames[1:2], focal)[0]) < BF16_RTOL
    x, rays, hw_pad, pads = _unidepth_batch_inputs(m, focal)
    with torch.no_grad(), true_f32():
        net_depth = m.net(x, rays)["depth"]
    ref_net, ref_post = _JAX_NETS.result("unidepth")[focal]
    assert net_depth.shape == ref_net.shape and _rel(ref_net, net_depth.numpy()) < NET_RTOL
    assert ref_net.std() > 1e-3 * np.abs(ref_net).max()  # the output is not flat
    post = m._batch_depth(torch.from_numpy(ref_net), hw_pad, pads).numpy()
    assert post.shape == ref_post.shape == (3, H, W) and _rel(ref_post, post) < POST_RTOL
    ref16 = ref_post.astype(np.float16)
    step = np.spacing(np.abs(ref16)).astype(np.float32)
    assert (np.abs(f32 - ref16.astype(np.float32)) <= step).all()


def test_vda_video_matches_jax():
    frames = _frames(40, 6)
    got = _port_vdas(torch.bfloat16).infer_video_depth(frames)
    ref = _JAX_VIDEO.result("video")["vda_video"]
    err = _rel(ref, got)
    print(f"VDA video (bf16 on both sides): {err:.3g} of the largest disparity")
    assert got.shape == ref.shape == (40, H, W) and err < BF16_RTOL


def _fill_port_cache():
    """The port's model cache holds the small seeded models (on the CPU)
    that the processor looks up: UniDepth-S with the 64-wide decoder,
    VDA-S and PriorDA coarse-only with the stub coarse net."""
    from vipe_tpu_torch.priors.depth.priorda import PriorDAModel
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthModel
    from vipe_tpu_torch.priors.depth.videodepthanything import VideoDepthAnythingModel

    w = _weights()
    model_cache.cached_global(("depth_model", UniDepthModel, "unidepth-s", "cpu"),
                              _port_unidepth)
    model_cache.cached_global(("vda", VideoDepthAnythingModel, "vits", "cpu"),
                              lambda: _port_vdas(torch.bfloat16))
    pda = model_cache.cached_global(("priorda", PriorDAModel, True, "cpu"), lambda: PriorDAModel(
        "vits", INPUT_SIZE, 5, _torch_sd(w["dav2"]), True, device="cpu"))
    pda.net = _stub_net


def _port_processor(branch):
    """The port's processor on ``_slam_output_np`` and the static frames."""
    from vipe_tpu_torch.ops.cameras import CameraType
    from vipe_tpu_torch.pipeline.processors import AdaptiveDepthProcessor
    from vipe_tpu_torch.slam.interface import SLAMMap, SLAMOutput
    from vipe_tpu_torch.streams.base import VideoFrame

    _fill_port_cache()
    s = _slam_output_np()
    slam_out = SLAMOutput(trajectory=s["trajectory"], intrinsics=s["intrinsics"],
                          camera_type=CameraType.PINHOLE,
                          slam_map=SLAMMap(s["xyz"], s["rgb"], s["mask"], s["frame_inds"]))
    proc = AdaptiveDepthProcessor("adaptive_unidepth-s_svda", slam_output=slam_out,
                                  coverage_thresh=1.5 if branch == "metric" else 0.3,
                                  device="cpu")
    frames = [VideoFrame(raw_frame_idx=k, rgb=rgb, intrinsics=s["intrinsics"].copy(),
                         mask=_valid_mask()) for k, rgb in enumerate(_static_frames())]
    return proc, np.stack([f.metric_depth for f in proc.update_iterator(iter(frames))])


@pytest.mark.parametrize("branch", ["metric", "priorda"])
def test_adaptive_depth_processor_matches_jax(branch, tmp_path, monkeypatch):
    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))  # no priorda_fine: coarse only
    try:
        proc, got = _port_processor(branch)
    finally:
        model_cache.clear()
    use_metric, coverage, ref = _JAX_VIDEO.result("video")["proc", branch]
    assert proc.use_metric == use_metric == (branch == "metric")
    assert proc.coverage == coverage == 1.0
    assert got.shape == ref.shape == (T_PROC, H, W) and got.dtype == np.float32
    assert np.isfinite(got).all() and (got > 0).all()
    err = _rel(ref, got)
    print(f"processor, {branch} branch: {err:.3g} of the largest depth")
    assert err < PROC_RTOL


@pytest.mark.parametrize("run", ["rig"])
def test_pipeline_depth_artifacts_match_jax(run, tmp_path, monkeypatch):
    """``DefaultAnnotationPipeline`` with the post-SLAM depth on a 2-view
    rig (SLAM stubbed, ``_run_pipeline``; the single view's artifacts are
    ``tests/test_torch_pipeline.py``'s): the same artifact tree, one depth
    entry per frame and view, within ``PROC_RTOL``."""
    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))
    try:
        _fill_port_cache()
        tree, depths = _run_pipeline("port")[run]
    finally:
        model_cache.clear()
    ref_tree, ref_depths = _JAX_VIDEO.result("video")["pipeline"][run]
    assert tree == ref_tree and any(p.startswith("depth/") for p in tree)
    assert set(depths) == set(ref_depths) == {"cam0", "cam1"}
    for name, d in depths.items():
        assert d.shape == ref_depths[name].shape == (T_PROC, H, W)
        assert np.isfinite(d).all() and (d > 0).all()
        err = _rel(ref_depths[name], d)
        print(f"pipeline {run}, {name}: {err:.3g} of the largest depth")
        assert err < PROC_RTOL
