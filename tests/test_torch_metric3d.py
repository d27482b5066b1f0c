"""The port's Metric3D v2 (``vipe_tpu_torch.priors.depth.metric3d``: SLAM's
``keyframe_depth: metric3d-<small|large>`` and the depth stage's
``adaptive_metric3d-…``) against ``vipe_tpu``'s.

Weights: the synthetic ViPE-layout state dict of ``tests/test_metric3d.py``
(0.02-scale, which leaves the net close to constant) and the port's seeded
initialisation (``models.vit.init_seeded_``: variance 1/fan_in), both
handed to the JAX package through ``convert_metric3d`` and to the port as
they are (``strict=True``).  Metric3D-small runs at a 70×84 canvas with 2
refinement steps (one JAX compile serves both weight sets).  The JAX
references run in two spawned processes (``BackgroundJax``) that the
module's first test starts; the port's own work runs first.

Tolerances:
* ``resize_nearest`` against ``jax.image.resize(..., "nearest")``, the
  converter round trip and the key sets of both variants: exactly equal;
* the net, and the decoder alone on the JAX encoder's taps (f32 on both
  sides, convolutions and sums in another order): depth, normals and
  confidence within 1e-4 of the largest value;
* ``estimate`` (f32; the letterbox resize is torch's half-pixel bilinear
  against ``cv2.INTER_LINEAR`` on f32), seeded weights: within 1e-4 of the
  largest depth, on a frame whose final resize shrinks one axis and grows
  the other (focal 50) and on a letterboxed one (focal 120);
* SLAM's keyframe prior (``keyframe_depth: metric3d-…``) through each
  package's ``GraphBuffer``: one call per keyframe at the live focal, the
  priors within 1e-4 of the largest, and after a focal change every prior
  rescaled by the focal ratio with no new call (``SLAMSystem`` with the
  prior runs in ``tests/test_torch_slam_tracks.py``);
* ``AdaptiveDepthProcessor`` with ``adaptive_metric3d-small_svda`` on its
  metric branch (the depth stage's tests' SLAM output and frames; a stub
  VDA giving both processors the same disparities, since VDA runs in bf16
  and is held to the JAX package in ``tests/test_torch_depth_align.py``):
  the same branch, Metric3D's per-frame depths and the aligned depths
  within 1e-4 of the largest.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_metric3d import make_synthetic_metric3d_sd
from tests.test_torch_slam import BackgroundJax, _rel
from vipe_tpu.priors.depth import metric3d as jm3d
from vipe_tpu_torch.models import model_cache, zoo
from vipe_tpu_torch.models.convert import metric3d_state_dict_from_flax
from vipe_tpu_torch.priors.depth import metric3d as tm3d
from vipe_tpu_torch.priors.depth.base import DepthEstimationInput, DepthType

CANVAS = (70, 84)
ITERS = 2
NET_RTOL = 1e-4
# final resize (69, 83) ← (68, 84): rows grow, columns shrink; (60, 90) is
# letterboxed and grows both; one focal each
FRAMES = ((69, 83), (60, 90))
FOCALS = (50.0, 120.0)
# the processor's Metric3D: the seeded net's depth spans three decades on
# these frames, and VDA's affine fit to it is ill-posed (scale −48, depths
# clipped at 1e4); the synthetic net's near-constant depth is fitted stably
PROC_WEIGHTS = "synthetic"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _weights():
    """name → Metric3D-small weights in ViPE's layout (numpy): the 0.02-scale
    synthetic ones and the port's seeded ones, alike in every process."""
    torch.set_num_threads(1)
    with torch.device("meta"):
        net = tm3d.Metric3DNet("small")
    seeded = zoo.load_net(net, None, 0)
    return {"synthetic": make_synthetic_metric3d_sd(np.random.default_rng(0), "small"),
            "seeded": {k: v.numpy() for k, v in seeded.state_dict().items()}}


def _frame(hw, seed=1):
    return np.random.default_rng(seed).random(hw + (3,)).astype(np.float32)


def _net_input():
    return np.random.default_rng(2).random((1,) + CANVAS + (3,)).astype(np.float32)


def _jax_nets_job():
    """The JAX net, its decoder on its own taps, ``estimate`` and the SLAM
    buffer's prior path, per weight set."""
    import jax
    import jax.numpy as jnp

    from vipe_tpu.models.convert import convert_metric3d
    from vipe_tpu.priors.depth.base import DepthEstimationInput as JInput

    out = {}
    model = None
    for name, sd in _weights().items():
        params = convert_metric3d(sd)
        if model is None:
            model = jm3d.Metric3DModel("small", params=params, input_size=CANVAS, iters=ITERS)
            vit, dec, taps_at = model.net.vit, model.net.decoder, model.net.taps
            encode = jax.jit(lambda p, x: vit.apply(p, x, tap_layers=taps_at))
            decode = jax.jit(lambda p, t: dec.apply(p, t, CANVAS[0] // 14, CANVAS[1] // 14))
        model.net.params = params
        net = model.net
        x = jnp.asarray(_net_input())
        taps = encode(params["vit"], x)
        out["net", name] = [np.asarray(a) for a in net(x)]
        out["taps", name] = [(np.asarray(p), np.asarray(e)) for p, e in taps]
        out["decoder", name] = [np.asarray(a) for a in decode(params["decoder"], taps)]
        if name == "seeded":
            for hw, f in zip(FRAMES, FOCALS):
                out["estimate", hw, f] = np.asarray(model.estimate(JInput(_frame(hw), f)).depth)
            out["buffer"] = _buffer_priors("jax", model)
    return out


def _buffer_priors(pkg, model):
    """``pkg``'s ("jax" or "port") SLAM buffer with ``model`` as its keyframe
    prior: the priors of 3 keyframes, then (the focal refined by 5 %) all
    of them again, rescaled by the focal ratio; and the model's calls."""
    if pkg == "jax":
        import jax.numpy as jnp

        from vipe_tpu.slam.buffer import GraphBuffer
    else:
        from vipe_tpu_torch.slam.buffer import GraphBuffer
    calls, est = [], model.estimate_depth

    def spy(rgb, focal_length=None):
        calls.append(focal_length)
        return est(rgb, focal_length)

    model.estimate_depth = spy
    buf = GraphBuffer(height=48, width=64, buffer_size=4)
    intr = np.asarray([70.0, 70.0, 32.0, 24.0], np.float32)
    feat = np.zeros((6, 8, 128), np.float32)
    for k in range(3):
        img = (np.random.default_rng(10 + k).random((48, 64, 3)) * 255).astype(np.uint8)
        if pkg == "jax":
            buf.append_keyframe(k, jnp.asarray(img), feat, None, None, intrinsics=intr.copy())
        else:
            buf.append_keyframe(k, torch.from_numpy(img), torch.from_numpy(feat), None, None,
                                intrinsics=intr.copy())
        buf.update_disps_sens(model, frame_idx=k)
    first = np.array(buf.disps_sens[:3])
    if pkg == "jax":
        buf.intrinsics = buf.intrinsics.at[:2].multiply(1.05)
    else:
        buf.intrinsics[:2] *= 1.05
    buf.update_disps_sens(model)
    del model.estimate_depth
    return first, np.array(buf.disps_sens[:3]), calls


# ------------------------------------------------- the processor, metric branch


def _vda_disparities(n):
    """The disparities a stub VDA gives both processors: smooth, positive,
    one map per frame."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:48, 0:64] / 16.0
    return np.stack([0.5 + 0.2 * np.sin(xx + rng.random()) * np.cos(yy + rng.random())
                     for _ in range(n)]).astype(np.float32)


class StubVDA:
    """VDA-S's place in the processors' model caches (VDA is held to the
    JAX package in ``tests/test_torch_depth_align.py``)."""

    def infer_video_depth(self, frames):
        return _vda_disparities(len(frames))


def _jax_processor_job():
    """``adaptive_metric3d-small_svda`` on the metric branch, Metric3D-small
    and the stub VDA in the JAX package's model cache.  Returns the branch,
    Metric3D's depth of each frame and the aligned depths."""
    from tests.test_torch_depth_align import _slam_output_np, _static_frames, _valid_mask
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.models import model_cache as jcache
    from vipe_tpu.ops.cameras import CameraType
    from vipe_tpu.pipeline.processors import AdaptiveDepthProcessor
    from vipe_tpu.priors.depth.videodepthanything import VideoDepthAnythingModel
    from vipe_tpu.slam.interface import SLAMMap, SLAMOutput
    from vipe_tpu.streams.base import VideoFrame

    m3d = jm3d.Metric3DModel("small", params=jconvert.convert_metric3d(_weights()[PROC_WEIGHTS]),
                             input_size=CANVAS, iters=ITERS)
    metric, est = [], m3d.estimate_depth

    def est_spy(rgb, focal_length=None):
        metric.append(np.asarray(est(rgb, focal_length)))
        return metric[-1]

    m3d.estimate_depth = est_spy
    jcache.cached_global(("depth_model", "metric3d-small"), lambda: m3d)
    jcache.cached_global(("vda", VideoDepthAnythingModel, "vits"), StubVDA)
    s = _slam_output_np()
    slam_out = SLAMOutput(trajectory=s["trajectory"], intrinsics=s["intrinsics"],
                          camera_type=CameraType.PINHOLE,
                          slam_map=SLAMMap(s["xyz"], s["rgb"], s["mask"], s["frame_inds"]))
    proc = AdaptiveDepthProcessor("adaptive_metric3d-small_svda", slam_output=slam_out,
                                  coverage_thresh=1.5)
    frames = [VideoFrame(raw_frame_idx=k, rgb=rgb, intrinsics=s["intrinsics"].copy(),
                         mask=_valid_mask()) for k, rgb in enumerate(_static_frames())]
    depths = np.stack([f.metric_depth for f in proc.update_iterator(iter(frames))])
    return proc._use_metric, np.stack(metric), depths


_JAX_NETS = BackgroundJax({"nets": (_jax_nets_job, ()), "processor": (_jax_processor_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_NETS.start()
    yield
    _JAX_NETS.stop()


def _torch_sd(sd):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _port_model(name):
    return tm3d.Metric3DModel("small", state_dict=_torch_sd(_weights()[name]), input_size=CANVAS,
                              iters=ITERS, device="cpu")


# ------------------------------------------------ the port alone, while JAX works


def test_constants_are_the_jax_ones():
    assert tm3d.METRIC3D_CFGS == jm3d.METRIC3D_CFGS
    assert tm3d.METRIC3D_TAPS == jm3d.METRIC3D_TAPS
    assert tm3d.CANONICAL_SIZE == jm3d.CANONICAL_SIZE
    assert (tm3d.MIN_DEPTH, tm3d.MAX_DEPTH, tm3d.NUM_ANCHORS) == (
        jm3d.MIN_DEPTH, jm3d.MAX_DEPTH, jm3d.NUM_ANCHORS)


@pytest.mark.parametrize("hw,out_hw", [((5, 6), (17, 21)), ((44, 76), (154, 266)),
                                       ((10, 35), (35, 122)), ((7, 9), (3, 4))])
def test_resize_nearest_matches_jax(hw, out_hw):
    """``Token2Feature``'s 3.5× resize (and a shrink): the same pixel picked
    everywhere."""
    import jax
    import jax.numpy as jnp

    from vipe_tpu_torch.ops.resize import resize_nearest

    x = np.random.default_rng(3).random((1,) + hw + (2,)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + out_hw + (2,), "nearest"))
    got = resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_converter_round_trip_is_exact():
    """``metric3d_state_dict_from_flax`` inverts ``convert_metric3d`` key for
    key and bit for bit, and the port's net takes the result strictly."""
    from vipe_tpu.models.convert import convert_metric3d

    sd = _weights()["synthetic"]
    got = metric3d_state_dict_from_flax(convert_metric3d(sd))
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    tm3d.Metric3DNet("small").load_state_dict(got, strict=True)


class _ShapeOnly:
    """A stand-in for numpy's generator that records shapes only (the large
    variant's 412 M weights are not drawn)."""

    class _A:
        def __init__(self, shape):
            self.shape = tuple(shape)

        def astype(self, _):
            return self

        def __mul__(self, _):
            return self

    def normal(self, size):
        return self._A(size)


@pytest.mark.parametrize("variant", ["small", "large"])
def test_state_dict_keys_are_vipes(variant):
    """The port's ``Metric3DNet`` holds exactly the keys and shapes of a
    ViPE checkpoint (``make_synthetic_metric3d_sd``), and loads them with
    ``strict=True``."""
    ref = {k: v.shape for k, v in make_synthetic_metric3d_sd(_ShapeOnly(), variant).items()}
    with torch.device("meta"):
        net = tm3d.Metric3DNet(variant)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == ref
    net.load_state_dict({k: torch.empty(s, device="meta") for k, s in ref.items()}, strict=True)


def test_zoo_reads_metric3d_families(tmp_path, monkeypatch):
    """``metric3d_small|large``: the JAX package's flax tree as ``.npz`` or a
    ViPE ``.pth``; no file → None."""
    from vipe_tpu.models.convert import convert_metric3d

    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))
    assert zoo.load_state_dict("metric3d_small") is None
    assert zoo.load_state_dict("metric3d_large") is None and not zoo.has_weights("metric3d_large")
    sd = _weights()["synthetic"]
    flat = {}

    def flatten(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            flatten(v, key) if isinstance(v, dict) else flat.__setitem__(key, np.asarray(v))

    flatten(convert_metric3d(sd), "")
    np.savez(tmp_path / "metric3d_small.npz", **flat)
    got = zoo.load_state_dict("metric3d_small")
    assert set(got) == set(sd) and all(np.array_equal(got[k].numpy(), v) for k, v in sd.items())
    (tmp_path / "metric3d_small.npz").unlink()
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "metric3d_small.pth")
    got = zoo.load_state_dict("metric3d_small")
    assert set(got) == set(sd)


def test_factory_builds_metric3d_once_per_device():
    """``metric3d-small`` (and ``metric3d``, whose default variant is small):
    the seeded model on the device asked for, ``METRIC_DEPTH``, cached."""
    from vipe_tpu_torch.priors.depth.factory import make_depth_model

    try:
        m = make_depth_model("metric3d-small", device="cpu")
        assert isinstance(m, tm3d.Metric3DModel) and m.net.variant == "small"
        assert m.depth_type == DepthType.METRIC_DEPTH and m.input_size == tm3d.CANONICAL_SIZE
        assert make_depth_model("metric3d-small", device="cpu") is m
        assert make_depth_model("metric3d", device="cpu").net.variant == "small"
    finally:
        model_cache.clear()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_depth_model("metric3d-large")


def test_estimate_scales_with_focal():
    """``METRIC_DEPTH``: the depth is linear in the focal, and the frame's
    size comes back."""
    m = _port_model("seeded")
    rgb = _frame((60, 90))
    d1 = m.estimate(DepthEstimationInput(rgb, 50.0)).depth
    d2 = m.estimate(DepthEstimationInput(torch.from_numpy(rgb), 100.0)).depth
    assert d1.shape == (60, 90)
    torch.testing.assert_close(d2, 2.0 * d1, rtol=1e-6, atol=0)


# ------------------------------------------------------------- against JAX


def _port_net(name):
    m = _port_model(name)
    with torch.no_grad():
        return [a.numpy() for a in m.net(torch.from_numpy(_net_input()).permute(0, 3, 1, 2))]


@pytest.mark.parametrize("name", ["synthetic", "seeded"])
def test_net_matches_jax(name):
    got = _port_net(name)
    ref = _JAX_NETS.result("nets")["net", name]
    assert [a.shape for a in got] == [a.shape for a in ref] == [
        (1, 68, 84), (1, 68, 84, 4), (1, 68, 84)]
    for what, r, g in zip(("depth", "normals", "confidence"), ref, got):
        assert _rel(r, g) < NET_RTOL, what
    assert got[0].std() > 1e-3 * got[0].mean()  # not a constant map


@pytest.mark.parametrize("name", ["synthetic", "seeded"])
def test_decoder_on_jax_taps_matches_jax(name):
    """The decoder alone, on the JAX encoder's taps (the register tokens
    among the extras)."""
    res = _JAX_NETS.result("nets")
    taps = [(torch.from_numpy(p), torch.from_numpy(e)) for p, e in res["taps", name]]
    assert taps[0][1].shape == (1, 5, 384)
    with torch.no_grad():
        got = _port_model(name).net.depth_model.decoder(taps, CANVAS[0] // 14, CANVAS[1] // 14)
    for what, r, g in zip(("depth", "normals", "confidence"), res["decoder", name], got):
        assert _rel(r, g.numpy()) < NET_RTOL, what


@pytest.mark.parametrize("hw,focal", list(zip(FRAMES, FOCALS)))
def test_estimate_matches_jax(hw, focal):
    got = _port_model("seeded").estimate(DepthEstimationInput(_frame(hw), focal)).depth.numpy()
    ref = _JAX_NETS.result("nets")["estimate", hw, focal]
    assert got.shape == ref.shape == hw
    assert _rel(ref, got) < NET_RTOL


def test_adaptive_metric3d_processor_matches_jax(tmp_path, monkeypatch):
    """``adaptive_metric3d-small_svda``, metric branch: the port's processor
    builds Metric3D through the factory (found in the model cache) and
    aligns the (stub) VDA disparities to its depth, in f32 as the JAX
    package's does."""
    from tests.test_torch_depth_align import _slam_output_np, _static_frames, _valid_mask
    from vipe_tpu_torch.ops.cameras import CameraType
    from vipe_tpu_torch.pipeline.processors import AdaptiveDepthProcessor
    from vipe_tpu_torch.priors.depth.videodepthanything import VideoDepthAnythingModel
    from vipe_tpu_torch.slam.interface import SLAMMap, SLAMOutput
    from vipe_tpu_torch.streams.base import VideoFrame

    m = _port_model(PROC_WEIGHTS)
    metric, est = [], m.estimate_depth

    def est_spy(rgb, focal_length=None):
        metric.append(est(rgb, focal_length).numpy())
        return metric[-1]

    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))
    m.estimate_depth = est_spy
    try:
        model_cache.cached_global(("depth_model", tm3d.Metric3DModel, "metric3d-small", "cpu"),
                                  lambda: m)
        model_cache.cached_global(("vda", VideoDepthAnythingModel, "vits", "cpu"), StubVDA)
        s = _slam_output_np()
        slam_out = SLAMOutput(trajectory=s["trajectory"], intrinsics=s["intrinsics"],
                              camera_type=CameraType.PINHOLE,
                              slam_map=SLAMMap(s["xyz"], s["rgb"], s["mask"], s["frame_inds"]))
        proc = AdaptiveDepthProcessor("adaptive_metric3d-small_svda", slam_output=slam_out,
                                      coverage_thresh=1.5, device="cpu")
        assert proc.metric_model is m
        frames = [VideoFrame(raw_frame_idx=k, rgb=rgb, intrinsics=s["intrinsics"].copy(),
                             mask=_valid_mask()) for k, rgb in enumerate(_static_frames())]
        got = np.stack([f.metric_depth for f in proc.update_iterator(iter(frames))])
    finally:
        del m.estimate_depth
        model_cache.clear()
    use_metric, metric_j, ref = _JAX_NETS.result("processor")
    assert proc.use_metric and use_metric
    assert len(metric) == len(metric_j) == len(frames)
    assert _rel(metric_j, np.stack(metric)) < NET_RTOL
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and (got > 0).all()
    err = _rel(ref, got)
    print(f"processor, metric3d metric branch: {err:.3g} of the largest depth")
    assert err < NET_RTOL


def test_buffer_prior_matches_jax():
    """SLAM's keyframe prior path (``slam.keyframe_depth: metric3d-…``): the
    buffer samples each keyframe's depth into its disparity prior (one call
    at the live focal), and when the focal changes rescales every prior by
    the focal ratio instead of calling Metric3D again."""
    first, rescaled, calls = _buffer_priors("port", _port_model("seeded"))
    ref_first, ref_rescaled, ref_calls = _JAX_NETS.result("nets")["buffer"]
    assert calls == ref_calls == [70.0] * 3
    assert np.isfinite(first).all() and (first > 0).all()
    assert _rel(ref_first, first) < NET_RTOL and _rel(ref_rescaled, rescaled) < NET_RTOL
    np.testing.assert_allclose(rescaled, first / 1.05, rtol=1e-6)
