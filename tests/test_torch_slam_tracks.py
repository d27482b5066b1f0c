"""The port's remaining SLAM options, and its keyframe prior from Metric3D,
against ``vipe_tpu``'s: ``slam.sparse_tracks`` (``slam/sparse_tracks.py``,
the motion filter's keypoint score, the BA's second flow term),
``slam.infill_dense_disp`` (the inner filler's disparities) and
``slam.visualize`` (``utils/telemetry.py``).

* The slice as a whole: one ``SLAMSystem.run`` of each package on the
  geometric-oracle scene of ``tests/test_torch_slam.py`` (its first 8
  poses, its disparities and configuration, every frame a keyframe, one
  filler chunk, 4 backend steps), whose frames are a textured canvas
  panning 3 px a frame with one frame of another canvas
  (so that OpenCV's LK tracks, loses and re-detects keypoints), with
  ``sparse_tracks: {name: lk}``, ``infill_dense_disp: true``,
  ``visualize: true`` and the Metric3D-small keyframe prior (the synthetic
  weights of ``tests/test_metric3d.py`` on both sides, 70×84 canvas, 2
  refinement steps).  The
  JAX run goes in a spawned process (``BackgroundJax``) that the module's
  first test starts; the port's run and its own tests go first.  Equal:
  keyframes, every track observation, the splatted targets and weights on
  every pair of frames, the prior's inputs, the snapshot's keys, keyframe
  count, timestamps and colours.  Within 1e-4 (f32 BA rounding in another
  order over ~300 Gauss-Newton iterations, as ``tests/test_torch_slam.py``
  bounds the oracle runs): the trajectory and the snapshot's poses and
  cloud (absolute), the filler's disparities and the priors (relative to
  the largest).
* The motion filter's keypoint score (mean flow since the last keyframe,
  the +100 bump when a fifth of the tracks vanish) on a drifting keypoint
  grid, decisions equal frame by frame (``tests/test_sparse_tracks_wiring.py``'s
  tracker and its no-op dense flow).
* The frontend leaves its speculative ordering with tracks on, as the JAX
  package leaves its fused step; the factory's three backends.
"""

import functools
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from tests.test_slam_system import H, HT, W, WD
from tests.test_sparse_tracks_wiring import GridTracker as JGridTracker
from tests.test_torch_slam import SYSTEM_CFG, BackgroundJax, _rel
from vipe_tpu.slam import sparse_tracks as jst
from vipe_tpu_torch.slam import sparse_tracks as tst

CANVAS = (70, 84)  # Metric3D-small's canvas and refinement steps in the prior
ITERS = 2
SCENE_SEED = 3
T = 8          # frames of the scene's first 8 poses
CUT_FRAME = 5  # the frame of another canvas: the tracks break there
# one filler chunk and 4 backend steps keep the JAX run (op by op, under
# the oracle) short
CONFIG = dict(SYSTEM_CFG, infill_chunk_size=8, backend_iters=4, sparse_tracks={"name": "lk"},
              infill_dense_disp=True, visualize=True, visualize_every=4)
ATOL = 1e-4
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _canvas(seed):
    import cv2

    c = np.random.default_rng(seed).random((H + 16, W + 3 * T + 8, 3)).astype(np.float32)
    return np.clip((cv2.GaussianBlur(c, (0, 0), 1.5) - 0.5) * 3 + 0.5, 0, 1)


@functools.lru_cache(maxsize=None)
def _frames():
    a, b = _canvas(1), _canvas(2)
    return [(b if k == CUT_FRAME else a)[8:8 + H, 3 * k:3 * k + W].copy() for k in range(T)]


def _stream(pkg, intr):
    """The panning stream, as ``pkg``'s ("jax" or "port") ``VideoStream``."""
    if pkg == "jax":
        from vipe_tpu.streams.base import FrameAttribute, VideoFrame, VideoStream
    else:
        from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

    class Panning(VideoStream):
        def __len__(self):
            return T

        def frame_size(self):
            return (H, W)

        def name(self):
            return "panning"

        def attributes(self):
            return {FrameAttribute.RGB, FrameAttribute.INTRINSICS}

        def __iter__(self):
            for k, rgb in enumerate(_frames()):
                yield VideoFrame(raw_frame_idx=k, rgb=rgb,
                                 intrinsics=np.asarray(intr, np.float32).copy())

    return Panning()


def _scene():
    from tests.test_slam_system import make_gt

    return make_gt(np.random.default_rng(SCENE_SEED))


@functools.lru_cache(maxsize=None)
def _prior_weights():
    """Metric3D-small weights for the prior: the 0.02-scale synthetic ones
    of ``tests/test_metric3d.py``, whose near-constant canonical depth (≈ 26
    m) puts the prior near the scene's disparity (the seeded ones give
    disparities from 0.1 to 100 on these frames, against which the oracle's
    BA diverges)."""
    from tests.test_metric3d import make_synthetic_metric3d_sd

    return make_synthetic_metric3d_sd(np.random.default_rng(0), "small")


def _observations(tracks):
    return {(v, k, f): np.asarray(uv) for v, obs in enumerate(tracks.observations)
            for k, d in obs.items() for f, uv in d.items()}


def _jax_run_job():
    """The JAX system on the scene with every option; returns its output,
    its tracks, the prior's inputs, the final priors, the filler's result
    and the snapshot."""
    import jax.numpy as jnp

    import vipe_tpu.slam.system as jsystem
    from tests.test_slam_system import make_oracle
    from tests.test_torch_slam import _run_with_spy
    from vipe_tpu.models.convert import convert_metric3d
    from vipe_tpu.priors.depth.metric3d import Metric3DModel
    from vipe_tpu.utils.telemetry import read_snapshot

    poses_w2c, disps, intr_full = _scene()
    ref = [None]
    oracle = make_oracle(ref, poses_w2c, disps, intr_full)
    prior = Metric3DModel("small", params=convert_metric3d(_prior_weights()),
                          input_size=CANVAS, iters=ITERS)
    calls, est = [], prior.estimate_depth

    def spy(rgb, focal_length=None):
        calls.append((np.asarray(rgb), focal_length))
        return est(rgb, focal_length)

    prior.estimate_depth = spy
    filled = []

    class Filler(jsystem.InnerFiller):
        def get_result(self):
            filled.append(super().get_result())
            return filled[-1]

    def ef(params, images):
        return jnp.zeros((images.shape[0], HT, WD, 128), jnp.float32)

    tmp = tempfile.mkdtemp()
    orig, jsystem.InnerFiller = jsystem.InnerFiller, Filler
    try:
        out = _run_with_spy(jsystem, ref, lambda: jsystem.SLAMSystem(
            config=dict(CONFIG, visualize_path=tmp, keyframe_spec_depth=1, proximity_spec=False),
            update_fn=oracle, params=None, encode_features=ef,
            encode_context=lambda p, im: (ef(p, im),) * 2, metric_depth=prior,
        ).run(_stream("jax", intr_full)))
    finally:
        jsystem.InnerFiller = orig
    buf = ref[0]
    n = len(out.slam_map.frame_inds)
    return dict(out=out, tracks=_observations(buf.sparse_tracks), calls=calls,
                sens=np.asarray(buf.disps_sens[:n]), dense_disps=filled[0].dense_disps,
                snapshot=read_snapshot(pathlib.Path(tmp) / "panning_live.npz"))


_JAX_RUN = BackgroundJax({"run": (_jax_run_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_RUN.start()
    yield
    _JAX_RUN.stop()


@functools.lru_cache(maxsize=None)
def _port_run():
    """The port on the scene with every option; returns what
    ``_jax_run_job`` returns, and the splats the BA took."""
    from tests.test_torch_slam import _run_with_spy, _torch_encoders, make_torch_oracle
    from vipe_tpu_torch.priors.depth.metric3d import Metric3DModel
    from vipe_tpu_torch.slam import system as tsystem
    from vipe_tpu_torch.utils.telemetry import read_snapshot

    poses_w2c, disps, intr_full = _scene()
    ref = [None]
    oracle = make_torch_oracle(ref, poses_w2c, disps, intr_full)
    prior = Metric3DModel("small", state_dict={k: torch.from_numpy(v) for k, v in
                                               _prior_weights().items()},
                          input_size=CANVAS, iters=ITERS, device="cpu")
    calls, est = [], prior.estimate_depth

    def spy(rgb, focal_length=None):
        calls.append((rgb.clone(), focal_length))
        return est(rgb, focal_length)

    prior.estimate_depth = spy
    filled, splats = [], []

    class Filler(tsystem.InnerFiller):
        def get_result(self):
            filled.append(super().get_result())
            return filled[-1]

    splat = tst.LKSparseTracks.compute_dense_disp_target_weight

    def splat_spy(self, *a, **k):
        splats.append(splat(self, *a, **k))
        return splats[-1]

    tmp = tempfile.mkdtemp()
    orig, tsystem.InnerFiller = tsystem.InnerFiller, Filler
    tst.LKSparseTracks.compute_dense_disp_target_weight = splat_spy
    try:
        out = _run_with_spy(tsystem, ref, lambda: tsystem.SLAMSystem(
            config=dict(CONFIG, visualize_path=tmp), device="cpu", update_fn=oracle,
            metric_depth=prior, **_torch_encoders()).run(_stream("port", intr_full)))
    finally:
        tsystem.InnerFiller = orig
        del tst.LKSparseTracks.compute_dense_disp_target_weight
    buf = ref[0]
    n = len(out.keyframes)
    return dict(out=out, tracks=_observations(buf.sparse_tracks), calls=calls,
                sens=buf.disps_sens[:n].numpy(), dense_disps=filled[0].dense_disps,
                snapshot=read_snapshot(pathlib.Path(tmp) / "panning_live.npz"),
                tracker=buf.sparse_tracks, splats=splats)


# ------------------------------------------ the port alone, while JAX works


class _Splat(jst.SparseTracks):
    def track_image(self, frame_idx, frames):
        pass


def test_build_sparse_tracks_backends():
    """``dummy`` (disabled), ``lk`` (its options passed on), ``instance`` (a
    dotted path, with the section's other keys); anything else raises."""
    assert not tst.build_sparse_tracks(None, 2).enabled
    lk = tst.build_sparse_tracks({"name": "lk", "max_corners": 50}, 2)
    assert isinstance(lk, tst.LKSparseTracks) and lk.enabled and lk.max_corners == 50
    assert lk.n_views == 2
    grid = tst.build_sparse_tracks({"name": "instance", "flow": 2.0,
                                    "instance": "tests.test_torch_slam_tracks.GridTracker"})
    assert isinstance(grid, GridTracker) and grid.flow == 2.0
    with pytest.raises(ValueError):
        tst.build_sparse_tracks({"name": "cuvslam"})


def test_splat_matches_jax_last_write_wins():
    """Two keypoints in one grid cell: the later one's target stands, in both
    packages; cross-view edges and frames without shared tracks get
    nothing."""
    t, j = _Splat(2), jst.SparseTracks(2)
    for tracks in (t, j):
        for f, (u0, u1) in enumerate(((3.0, 5.0), (9.0, 12.5))):
            tracks.add_observation(0, 0, f, [u0, 4.0])   # both in cell (0, 0)
            tracks.add_observation(0, 1, f, [u1, 6.0])
            tracks.add_observation(1, 2, f, [20.0 + f, 30.0])
    args = (np.asarray([0, 1, 0, 0]), np.asarray([0, 0, 0, 1]), np.asarray([0, 1, 1, 0]),
            np.asarray([1, 1, 1, 2]), (H, W), (HT, WD))
    got, ref = t.compute_dense_disp_target_weight(*args), j.compute_dense_disp_target_weight(*args)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0][0, 0, 0].tolist() == [12.5 / 8, 6.0 / 8] and got[1][0].sum() == 2
    assert got[1][1].sum() == 2 and got[1][2:].sum() == 0


class GridTracker(tst.SparseTracks):
    """The port's copy of ``tests/test_sparse_tracks_wiring.py``'s tracker:
    a 4×5 keypoint grid drifting ``flow`` px a frame; past ``drop_after``,
    every third track vanishes."""

    def __init__(self, n_views: int = 1, flow: float = 4.0, drop_after=None):
        super().__init__(n_views)
        self.flow, self.drop_after = flow, drop_after

    def track_image(self, frame_idx, frames):
        JGridTracker.track_image(self, frame_idx, frames)


@pytest.mark.parametrize("flow,drop_after", [(4.0, 1), (25.0, None), (2.0, 3)])
def test_motion_filter_sparse_score_matches_jax(flow, drop_after):
    """Decisions frame by frame with a dense flow that never passes the
    threshold alone: keyframes from the keypoint flow (more than twice the
    threshold) and from the bump when a fifth of the tracks vanish."""
    import jax.numpy as jnp

    from vipe_tpu.slam.motion_filter import MotionFilter as JFilter
    from vipe_tpu_torch.slam.motion_filter import MotionFilter as TFilter

    def ef_j(params, images):
        return jnp.zeros((images.shape[0], HT, WD, 128), jnp.float32)

    def uf_j(params, net, inp, corr, motn, ii, jj, num_frames):
        delta = jnp.full(motn.shape[:-1] + (2,), 0.01, jnp.float32)
        return net, delta, jnp.ones_like(delta), jnp.zeros((num_frames, HT, WD), jnp.float32)

    def ef_t(images):
        return torch.zeros((images.shape[0], HT, WD, 128))

    def uf_t(net, inp, corr, motn, ii, jj, num_frames):
        delta = torch.full(motn.shape[:-1] + (2,), 0.01)
        return net, delta, torch.ones_like(delta), torch.zeros((num_frames, HT, WD))

    uf_j.host_only = True
    tj, tt = JGridTracker(flow=flow, drop_after=drop_after), GridTracker(flow=flow,
                                                                        drop_after=drop_after)
    fj = JFilter(ef_j, lambda p, im: (ef_j(p, im),) * 2, uf_j, None, thresh=10.0,
                 sparse_tracks=tj)
    ft = TFilter(ef_t, lambda im: (ef_t(im),) * 2, uf_t, thresh=10.0, sparse_tracks=tt)
    dec_j, dec_t = [], []
    for k in range(8):
        tj.track_image(k, None)
        tt.track_image(k, None)
        dec_j.append(bool(fj.check(jnp.zeros((H, W, 3), jnp.float32))))
        dec_t.append(ft.resolve(ft.submit(torch.zeros((H, W, 3), dtype=torch.uint8))))
        assert (ft.last_kf_frame_idx, ft.last_n_sparse_tracks) == (
            fj.last_kf_frame_idx, fj.last_n_sparse_tracks), k
    assert dec_t == dec_j and sum(dec_t) > 1


def test_frontend_leaves_speculation_with_tracks():
    """With tracks on, the port's frontend takes the sequential step, as the
    JAX package's leaves its fused one."""
    from vipe_tpu_torch.slam.buffer import GraphBuffer
    from vipe_tpu_torch.slam.frontend import SLAMFrontend

    def update_fn(*a):
        raise AssertionError("not called")

    for tracks, speculative in ((None, True), (tst.DummySparseTracks(), True),
                                (_Splat(), False)):
        buf = GraphBuffer(height=H, width=W, buffer_size=4)
        buf.sparse_tracks = tracks
        assert SLAMFrontend(buf, update_fn, {}).speculative == speculative


def test_port_run_exercises_every_option():
    """The port's run: LK tracks across the canvas cut, the BA's track rows
    (a splat with weight) in frontend, backend and filler, a snapshot, the
    filler's disparities, the prior on every keyframe."""
    r = _port_run()
    out, tracker = r["out"], r["tracker"]
    assert np.isfinite(out.trajectory).all()
    # keypoints followed across frames; most lost at the cut
    assert len(tracker.get_correspondences(0, 0, CUT_FRAME - 1)) >= 5
    before = len(tracker.get_correspondences(0, CUT_FRAME - 2, CUT_FRAME - 1))
    assert len(tracker.get_correspondences(0, CUT_FRAME - 1, CUT_FRAME)) < before / 2
    assert sum(int((w > 0).any()) for _, w in r["splats"]) > 10
    assert r["dense_disps"].shape == (T, HT, WD) and np.isfinite(r["dense_disps"]).all()
    assert len(r["calls"]) == len(out.keyframes) == T
    assert r["snapshot"]["n_keyframes"] == T


# --------------------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def runs():
    port = _port_run()
    return _JAX_RUN.result("run"), port


def test_keyframes_equal(runs):
    ref, got = runs
    np.testing.assert_array_equal(got["out"].keyframes, ref["out"].slam_map.frame_inds)


def test_tracks_equal(runs):
    ref, got = runs
    assert got["tracks"].keys() == ref["tracks"].keys()
    for key, uv in ref["tracks"].items():
        np.testing.assert_array_equal(got["tracks"][key], uv, err_msg=str(key))


def test_splats_equal(runs):
    """The splatted targets and weights of every ordered pair of frames,
    from each run's tracks."""
    ref, got = runs
    j = jst.SparseTracks(1)
    for (v, k, f), uv in ref["tracks"].items():
        j.add_observation(v, k, f, uv)
    fi, fj = (a.reshape(-1) for a in np.meshgrid(np.arange(T), np.arange(T), indexing="ij"))
    zeros = np.zeros_like(fi)
    args = (zeros, fi, zeros, fj, (H, W), (HT, WD))
    g, r = got["tracker"].compute_dense_disp_target_weight(*args), \
        j.compute_dense_disp_target_weight(*args)
    for a, b in zip(g, r):
        np.testing.assert_array_equal(a, b)
    assert r[1].sum() > 0


def test_trajectory_close(runs):
    ref, got = runs
    np.testing.assert_allclose(got["out"].trajectory, ref["out"].trajectory, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["out"].intrinsics, ref["out"].intrinsics, rtol=1e-5)


def test_infill_dense_disps_close(runs):
    ref, got = runs
    assert got["dense_disps"].shape == ref["dense_disps"].shape == (T, HT, WD)
    assert _rel(ref["dense_disps"], got["dense_disps"]) < RTOL


def test_prior_inputs_equal_and_priors_close(runs):
    ref, got = runs
    assert len(got["calls"]) == len(ref["calls"]) == T
    for (rgb, f), (rgb_j, f_j) in zip(got["calls"], ref["calls"]):
        np.testing.assert_array_equal(rgb.numpy(), rgb_j)
        assert f == f_j
    assert np.isfinite(got["sens"]).all() and (got["sens"] > 0).all()
    assert _rel(ref["sens"], got["sens"]) < RTOL


def test_snapshot_matches_jax(runs):
    ref, got = runs
    a, b = ref["snapshot"], got["snapshot"]
    assert a.keys() == b.keys()
    for key in ("n_keyframes", "tstamp", "cloud_rgb"):
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    for key in ("poses_w2c", "cloud_xyz"):
        assert b[key].shape == a[key].shape and b[key].dtype == a[key].dtype
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=ATOL, err_msg=key)
