"""The port's GeoCalib (``vipe_tpu_torch.priors.geocalib``, the pipeline's
``init.intrinsics: geocalib``) against ``vipe_tpu``'s, and the port's
deterministic segment sum against ``index_add_``.

Both sides run the same weights: the synthetic ViPE-layout state dict of
``tests/test_geocalib.py`` goes through ``convert_geocalib`` to the JAX
package and, as is, into the port (``strict=True``); the port's NMF bases
are the JAX package's (``PRNGKey(42)``).  The JAX network is jitted once, at
64×96, and shared by every JAX ``GeoCalib`` here; the JAX references of the
network, the preprocessing, the calibration and the LM run in two spawned
processes, while the port's own tests run first.

Tolerances: the fields and ``nmf2d`` are the same f32 formulas, 1e-5; the
network stacks 21 MSCAN blocks and two decoders of f32 convolutions summed
in another order, 1e-4; the LM must stop at the same step with parameters
within 1e-4 relative (its cost is a float sum in another order, and the
stop tests an f32 difference against 1e-8); ``_preprocess`` (torch bilinear
against ``cv2.resize`` on float32) 1e-4; ``GeoCalib.calibrate`` 1e-4
relative.  The segment sum is bit-equal to ``index_add_`` on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_geocalib import make_synthetic_geocalib_sd
from tests.test_torch_slam import BackgroundJax
from vipe_tpu.models import model_cache as jax_model_cache
from vipe_tpu.models.convert import convert_geocalib
from vipe_tpu.pipeline import processors as jax_processors
from vipe_tpu.priors import geocalib as jgc
from vipe_tpu.priors.geocalib import fields as jf
from vipe_tpu.priors.geocalib import network as jnet
from vipe_tpu_torch.models import model_cache, zoo
from vipe_tpu_torch.models.convert import geocalib_state_dict_from_flax
from vipe_tpu_torch.ops.segment import segment_sum
from vipe_tpu_torch.pipeline import processors as torch_processors
from vipe_tpu_torch.priors import geocalib as tgc
from vipe_tpu_torch.priors.geocalib import fields as tf
from vipe_tpu_torch.priors.geocalib import network as tnet
from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

INFER = 64
FRAME_H, FRAME_W = 48, 72  # → 64×96 at the inference size
K1 = {"pinhole": None, "simple_radial": 0.08, "simple_divisional": -0.12, "simple_mei": 0.35}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _weights():
    """(ViPE-layout numpy state dict, its flax variables, the JAX bases),
    made alike in every process."""
    sd = make_synthetic_geocalib_sd(np.random.default_rng(0))
    bases = jax.random.uniform(jax.random.PRNGKey(42), (1, 512, 64))
    bases = bases / jnp.maximum(jnp.linalg.norm(bases, axis=1, keepdims=True), 1e-6)
    return sd, convert_geocalib(sd), np.array(bases)


@pytest.fixture(scope="module")
def weights():
    return _weights()


def _jax_models():
    """JAX ``GeoCalib`` for pinhole and simple_mei sharing one jitted net."""
    _, variables, _ = _weights()
    pin = jgc.GeoCalib("pinhole", params=variables, infer_size=INFER)
    mei = jgc.GeoCalib("simple_mei", params=variables, infer_size=INFER)
    mei._forward = pin._forward
    return {"pinhole": pin, "simple_mei": mei}


def _torch_model(weights, camera_type):
    sd, _, bases = weights
    m = tgc.GeoCalib(camera_type, state_dict={k: torch.from_numpy(v) for k, v in sd.items()},
                     infer_size=INFER, device="cpu")
    m.bases = torch.from_numpy(bases)
    return m


def _frames(seed, n, h=FRAME_H, w=FRAME_W):
    rng = np.random.default_rng(seed)
    return [rng.random((h, w, 3)).astype(np.float32) for _ in range(n)]


# ------------------------------------------------------- JAX references
#
# The JAX network, preprocessing and calibration references, and the LM's,
# run in two spawned processes (``BackgroundJax``) started by the module's
# first test; their tests come last, after the port's own.

PREPROCESS_SHAPES = ((FRAME_H, FRAME_W), (100, 150))
CALIBRATE_CASES = (("pinhole", 3), ("simple_mei", 1))
LM_SCENES = ("focal_and_gravity", "shared_intrinsics", "k1_simple_radial",
             "k1_simple_divisional", "k1_simple_mei")


def _net_input():
    return np.random.default_rng(2).random((1, 64, 96, 3)).astype(np.float32)


def _scene(name):
    """(model, h, w, focal, rolls, pitches, k1) of ``tests/test_geocalib.py``'s
    recovery scenes."""
    if name == "focal_and_gravity":
        return "pinhole", 24, 32, 40.0, [0.25], [-0.15], None
    if name == "shared_intrinsics":
        return "pinhole", 20, 24, 30.0, [0.1, -0.2, 0.3], [-0.1, 0.15, 0.05], None
    model = name.removeprefix("k1_")
    return model, 24, 40, 36.0, [0.15], [-0.1], K1[model]


def _jax_net_job():
    """The JAX network on one input, ``_preprocess`` per shape and
    ``GeoCalib.calibrate`` per case, as numpy."""
    _, variables, _ = _weights()
    models = _jax_models()
    ref = models["pinhole"]._forward(variables, jnp.asarray(_net_input()))
    return {"net": {k: np.asarray(v) for k, v in ref.items()},
            "preprocess": {shape: np.asarray(models["pinhole"]._preprocess(_frames(3, 1, *shape)[0]))
                           for shape in PREPROCESS_SHAPES},
            "calibrate": {(ct, n): np.asarray(models[ct].calibrate(_frames(4, n)))
                          for ct, n in CALIBRATE_CASES}}


def _jax_lm_job():
    """Per LM scene: the fields JAX makes eagerly (the observations) and
    its LM's result on them, as numpy."""
    out = {}
    for name in LM_SCENES:
        model, h, w, focal, rolls, pitches, k1 = _scene(name)
        ups = np.stack([np.asarray(jf.up_field(h, w, focal, r, p, k1=k1, model=model))
                        for r, p in zip(rolls, pitches)])
        lats = np.stack([np.asarray(jf.latitude_field(h, w, focal, r, p, k1=k1, model=model))
                         for r, p in zip(rolls, pitches)])
        ref = jgc.calibrate_from_fields(ups, lats, focal_init=float(w), model=model)
        out[name] = ups, lats, {k: np.asarray(getattr(ref, k))
                                for k in ("roll", "pitch", "focal", "k1", "cost", "n_iters")}
    return out


_JAX_NET = BackgroundJax({"net": (_jax_net_job, ())})
_JAX_LM = BackgroundJax({"lm": (_jax_lm_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_NET.start()
    _JAX_LM.start()
    yield
    _JAX_LM.stop()
    _JAX_NET.stop()


# ------------------------------------------------------------------ fields


@functools.lru_cache(maxsize=None)
def _jax_fields_fn(model):
    h, w, k1 = 12, 17, K1[model]

    def fields(focal, roll, pitch):
        out = {"up": jf.up_field(h, w, focal, roll, pitch, k1=k1, model=model),
               "lat": jf.latitude_field(h, w, focal, roll, pitch, k1=k1, model=model)}
        if model == "pinhole":
            g = jf.gravity_from_rp(roll, pitch)
            out["g"] = g
            out["rp"] = jnp.stack(jf.rp_from_gravity(g))
            out["grid"] = jf.normalized_grid(h, w, focal)
            out["grid_c"] = jf.normalized_grid(h, w, focal, 7.25, 4.5)
        else:
            uv = jf.normalized_grid(h, w, focal)
            out["scale"] = jf.distort_scale(model, uv, k1)
            out["scale_grad"] = jf.distort_scale_grad(model, uv, k1)
            out["undistort"] = jf.undistort(model, uv, k1)
        return out

    return jax.jit(fields)


@pytest.mark.parametrize("model", list(K1))
def test_fields(model):
    h, w, k1 = 12, 17, K1[model]
    focal = np.float32(15.0)
    roll = np.array([0.1, -0.25, 0.3], np.float32)
    pitch = np.array([-0.15, 0.2, 0.05], np.float32)
    ref = _jax_fields_fn(model)(focal, roll, pitch)
    ft, rt, pt = torch.tensor(focal), torch.from_numpy(roll), torch.from_numpy(pitch)
    got = {"up": tf.up_field(h, w, ft, rt, pt, k1=k1, model=model),
           "lat": tf.latitude_field(h, w, ft, rt, pt, k1=k1, model=model)}
    if model == "pinhole":
        g = tf.gravity_from_rp(rt, pt)
        got["g"] = g
        got["rp"] = torch.stack(tf.rp_from_gravity(g))
        got["grid"] = tf.normalized_grid(h, w, ft)
        got["grid_c"] = tf.normalized_grid(h, w, ft, 7.25, 4.5)
    else:
        uv = tf.normalized_grid(h, w, ft)
        got["scale"] = tf.distort_scale(model, uv, k1)
        got["scale_grad"] = tf.distort_scale_grad(model, uv, k1)
        got["undistort"] = tf.undistort(model, uv, k1)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-5,
                                   err_msg=f"{model}: {key}")


# ------------------------------------------------------------ the network


def test_nmf2d():
    rng = np.random.default_rng(1)
    x = np.abs(rng.standard_normal((2, 40, 16))).astype(np.float32)
    bases = rng.random((2, 16, 4)).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)
    ref = jax.jit(lambda a, b: jnet.nmf2d(a, bases=b))(x, bases)
    got = tnet.nmf2d(torch.from_numpy(x), torch.from_numpy(bases))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_converter_round_trip(weights):
    sd, variables, _ = weights
    back = geocalib_state_dict_from_flax(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32 and np.array_equal(back[k].numpy(), v), k


# --------------------------------------------------------- GeoCalib itself


class _FakeGeoCalib:
    """Records which frames it was given (their index is their value)."""

    def __init__(self):
        self.seen = []

    def calibrate(self, frames):
        self.seen.append([int(f[0, 0, 0]) for f in frames])
        return np.array([100.0, 100.0, 2.0, 2.0], np.float32)


class _IndexStream:
    def __init__(self, n, fps):
        self.n, self._fps = n, fps

    def __len__(self):
        return self.n

    def fps(self):
        return self._fps

    def __iter__(self):
        for k in range(self.n):
            yield VideoFrame(raw_frame_idx=k, rgb=np.full((4, 4, 3), k, np.float32))


@pytest.mark.parametrize("camera_type", ["pinhole", "mei"])
def test_processor_samples_jax_frames(camera_type):
    model = {"pinhole": "pinhole", "mei": "simple_mei"}[camera_type]
    jax_fake, torch_fake = _FakeGeoCalib(), _FakeGeoCalib()
    try:
        jax_model_cache.cached_global(("geocalib", jgc.GeoCalib, model), lambda: jax_fake)
        model_cache.cached_global(("geocalib", tgc.GeoCalib, model, "cpu"), lambda: torch_fake)
        for n, fps in ((100, 30.0), (20, 30.0), (7, 2.5), (1, 30.0), (50, 0.0)):
            jax_processors.GeoCalibIntrinsicsProcessor(camera_type,
                                                       sample_stream=_IndexStream(n, fps))
            torch_processors.GeoCalibIntrinsicsProcessor(
                camera_type, sample_stream=_IndexStream(n, fps), device="cpu")
    finally:
        jax_model_cache.clear()
        model_cache.clear()
    assert torch_fake.seen == jax_fake.seen and len(jax_fake.seen) == 5


def test_pipeline_geocalib_stamps_and_runs_slam(weights):
    """``init.intrinsics: geocalib`` on the CPU: the GeoCalib result of
    frames 0, gap, 2·gap is stamped on the frames, and SLAM runs on it."""
    from tests.test_torch_pipeline import H, W
    from vipe_tpu_torch.pipeline.default import DefaultAnnotationPipeline

    n = 12
    base = np.random.default_rng(5).random((H + 32, W + 32, 3)).astype(np.float32)
    frames = [base[k % 32:k % 32 + H, 2 * k % 32:2 * k % 32 + W] for k in range(n)]

    class Stream(VideoStream):
        def __len__(self):
            return n

        def fps(self):
            return 10.0

        def frame_size(self):
            return (H, W)

        def name(self):
            return "geocalib_clip"

        def attributes(self):
            return {FrameAttribute.RGB}

        def __iter__(self):
            for k, rgb in enumerate(frames):
                yield VideoFrame(raw_frame_idx=k, rgb=rgb)

    tiny = _torch_model(weights, "pinhole")
    expected = tiny.calibrate([frames[0], frames[5], frames[10]])  # gap min(10, 5)
    try:
        model_cache.cached_global(("geocalib", tgc.GeoCalib, "pinhole", "cpu"), lambda: tiny)
        pipe = DefaultAnnotationPipeline(
            init={"intrinsics": "geocalib"},
            slam={"optimize_intrinsics": False, "resize_area": 3072, "warmup": 4,
                  "backend_iters": 2, "infill_chunk_size": 8},
            output={"path": None}, device="cpu", return_payload=True)
        out = pipe.run(Stream())
    finally:
        model_cache.clear()
    assert out.trajectory.shape == (n, 7) and np.isfinite(out.trajectory).all()
    np.testing.assert_allclose(np.linalg.norm(out.trajectory[:, 3:], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out.intrinsics, expected, rtol=1e-5)


# ----------------------------------------------------------------- the zoo


def test_zoo_reads_pth_and_flax_npz(weights, tmp_path, monkeypatch):
    sd, variables, _ = weights
    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))
    assert zoo.load_state_dict("geocalib_pinhole") is None
    assert zoo.load_state_dict("metric3d_small") is None
    with pytest.raises(NotImplementedError):
        zoo.load_state_dict("droidnet")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "geocalib_distorted.pth")
    flat = {}

    def flatten(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            flatten(v, key) if isinstance(v, dict) else flat.__setitem__(key, np.asarray(v))

    flatten(variables, "")
    np.savez(tmp_path / "geocalib_pinhole.npz", **flat)
    for family in ("geocalib_pinhole", "geocalib_distorted"):
        got = zoo.load_state_dict(family)
        assert set(got) == set(sd), family
        assert all(np.array_equal(got[k].numpy(), v) for k, v in sd.items()), family


# ------------------------------------------------------- the segment sum


@pytest.mark.parametrize("rows,tail,n", [(48, (16, 5, 7), 12), (200, (36,), 121), (7, (), 3),
                                         (0, (6,), 4)])
def test_segment_sum_equals_index_add(rows, tail, n):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows,) + tail).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, rows))
    ref = torch.zeros((n,) + tail).index_add_(0, idx, x)
    got = segment_sum(x, idx, n)
    assert got.shape == ref.shape and torch.equal(got, ref)


# ------------------------------------ against the JAX references


def test_network_matches_jax(weights):
    m = _torch_model(weights, "pinhole")
    with torch.no_grad():
        got = m.net(torch.from_numpy(_net_input()).permute(0, 3, 1, 2), m.bases)
    ref = _JAX_NET.result("net")["net"]
    got["up_field"] = got["up_field"].permute(0, 2, 3, 1)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("name", LM_SCENES)
def test_lm_calibrate(name):
    model, h, w, focal, rolls, pitches, k1 = _scene(name)
    ups, lats, ref = _JAX_LM.result("lm")[name]
    got = tgc.calibrate_from_fields(ups, lats, focal_init=float(w), model=model)
    if model == "simple_divisional":
        # The divisional model's f32 fields cancel in 1 − √(1 − 4k1r²):
        # XLA's fused evaluation inside the LM and its eager one (which
        # made the observed fields) differ by ~1e-5, so JAX's cost stalls
        # at ~1e-8, where the stop's 1e-8 cannot tell steps apart; it
        # stops after 13 steps on this host, the port (whose fields match
        # the eager ones) after 5.  Both stop on that floor, at the same
        # parameters.
        assert max(float(got.cost), float(ref["cost"])) < 1e-7
    else:
        assert got.n_iters == int(ref["n_iters"])
    for key in ("roll", "pitch", "focal", "k1"):
        np.testing.assert_allclose(getattr(got, key).numpy(), ref[key],
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    # the JAX package's own recovery bounds
    distorted = model != "pinhole"
    assert abs(float(got.focal) - focal) / focal < (0.05 if distorted else 0.02)
    np.testing.assert_allclose(got.roll.numpy(), rolls, atol=0.02 if distorted else 0.01)
    np.testing.assert_allclose(got.pitch.numpy(), pitches, atol=0.02 if distorted else 0.01)
    if distorted:
        assert abs(float(got.k1) - k1) < 0.05


@pytest.mark.parametrize("shape", PREPROCESS_SHAPES)
def test_preprocess_matches_cv2(weights, shape):
    rgb = _frames(3, 1, *shape)[0]
    got = _torch_model(weights, "pinhole")._preprocess(rgb)[0].permute(1, 2, 0)
    ref = _JAX_NET.result("net")["preprocess"][shape]
    assert got.shape == ref.shape == (64, 96, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("camera_type,n_frames", CALIBRATE_CASES)
def test_calibrate_matches_jax(weights, camera_type, n_frames):
    got = _torch_model(weights, camera_type).calibrate(_frames(4, n_frames))
    ref = _JAX_NET.result("net")["calibrate"][camera_type, n_frames]
    assert got.shape == ref.shape == ((4,) if camera_type == "pinhole" else (5,))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
