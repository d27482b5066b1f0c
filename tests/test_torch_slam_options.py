"""The port's SLAM options against ``vipe_tpu.slam``.

* The speculative keyframe ordering (``keyframe_spec_depth: 2``) against
  the JAX package's fused frontend, which is the path JAX takes it on (a
  traceable update network): a tiny random DroidNet (the same weights on
  both sides through ``droidnet_state_dict_from_flax``, f32 on both sides),
  an 8-frame panning texture at 48×64, every frame a keyframe candidate,
  pass 1 only (the global backend is where a spy stops both runs).  Three
  removal thresholds with ``proximity_spec: true``: 0 keeps every
  keyframe, 1e9 removes every one after warm-up (late removals and
  removals by re-score among them), 0.55 mixes keeps and a late removal
  with a re-score; 0.55
  again with ``proximity_spec: false``.  Keyframe sets, ``n_removals``,
  ``t1`` and the frontend graph's edges must be equal; every distance the
  JAX run compares with the threshold lies at least 5 % away from it
  (asserted), so rounding cannot flip a decision.  The keyframe poses
  agree within 1e-2: both sides compute in f32, and the difference (f32
  rounding of two convolution libraries) grows over ~30 GRU/BA rounds of
  a random network to at most 1.8e-3 here.  The four JAX runs share one
  compile (the threshold is an argument of JAX's fused step, and
  ``proximity_spec`` does not enter it) and run in a second process
  (``BackgroundJax``) while the port's tests of the module run.
* The MEI and panorama oracle scenes of ``tests/test_slam_system.py``
  through the port only: aligned ATE < 0.03, the JAX tests' limit.
* A stream that gives its poses (``FrameAttribute.POSE``), through the
  port only: the frontend keeps them (every keyframe pose before the
  backend equals the given one to 1e-6), the backend refines them, and the
  trajectory recovers ground truth to 2e-2.
* ``SLAMSystem`` takes the port's default SLAM section, whose speculation
  keys are the JAX default's.
"""

import numpy as np
import pytest
import torch

import vipe_tpu.slam.system as jsystem
from tests.test_slam_system import H, HT, T, W, WD, SyntheticStream, make_gt
from tests.test_torch_slam import BackgroundJax, _run_with_spy
from vipe_tpu.utils.geometry import ate_rmse
from vipe_tpu_torch.ops import cameras as tcam
from vipe_tpu_torch.ops import geom as tgeom
from vipe_tpu_torch.ops import lie as tlie
from vipe_tpu_torch.slam import system as tsystem
from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream

SPEC_FRAMES = 8
ORACLE_CFG = dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=0.0, warmup=4,
                  buffer=64, infill_chunk_size=6, backend_iters=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------- omni cameras


def _torch_oracle(buffer_ref, poses_w2c, disps, intr_grid, camera_type, zero_top_row=False):
    """The GT-flow oracle of ``tests/test_slam_system.py`` for ``camera_type``
    (grid-scale intrinsics), in torch."""
    P = torch.from_numpy(np.array(poses_w2c))
    D = torch.from_numpy(np.array(disps))
    I_grid = torch.from_numpy(np.array(intr_grid)).float()

    def update_fn(net, inp, corr, motn, ii, jj, num_frames):
        E, ht, wd, _ = motn.shape
        coords1 = motn[..., :2] + tgeom.coords_grid(ht, wd)
        buf = buffer_ref[0]
        fi = torch.from_numpy(buf.tstamp[np.clip(ii.numpy(), 0, buf.buffer_size - 1)])
        fj = torch.from_numpy(buf.tstamp[np.clip(jj.numpy(), 0, buf.buffer_size - 1)])
        gt_coords, gt_valid = tgeom.reproject(P, D, I_grid, camera_type, fi, fj)
        weight = gt_valid[..., None].float().expand_as(gt_coords).clone()
        if zero_top_row:
            weight[:, 0] = 0.0  # the pole row, as the JAX panorama oracle does
        return net, gt_coords - coords1, weight, torch.full((num_frames, ht, wd), 0.01)

    update_fn.host_only = True
    return update_fn


def _zeros(images):
    return torch.zeros((images.shape[0], HT, WD, 128), dtype=torch.bfloat16)


def _port_oracle_run(stream, oracle_factory, camera_type, config=ORACLE_CFG):
    ref = [None]
    return _run_with_spy(tsystem, ref, lambda: tsystem.SLAMSystem(
        config=config, device="cpu", update_fn=oracle_factory(ref), encode_features=_zeros,
        encode_context=lambda im: (_zeros(im), _zeros(im)),
    ).run(stream, camera_type=camera_type))


def test_mei_oracle_scene_recovers_ground_truth():
    """``slam_result_mei`` of ``tests/test_slam_system.py`` through the port."""
    import jax.numpy as jnp

    from vipe_tpu.ops import lie as jlie

    rng = np.random.default_rng(5)
    poses_w2c, disps, _ = make_gt(rng)
    intr_full = np.asarray([W * 1.2, W * 1.2, W / 2.0, H / 2.0, 0.6], np.float32)
    stream = SyntheticStream(rng, disps, intr_full)
    ct = tcam.CameraType.MEI
    intr_grid = tcam.scaled_intrinsics(ct, torch.from_numpy(intr_full), 1 / 8.0)
    out = _port_oracle_run(stream, lambda ref: _torch_oracle(ref, poses_w2c, disps, intr_grid, ct),
                           ct)
    assert out.camera_type == ct and out.intrinsics.shape == (5,)
    err = ate_rmse(out.trajectory, np.asarray(jlie.se3_inv(jnp.asarray(poses_w2c))), align=True)
    assert err < 0.03, f"MEI ATE {err}"


def test_panorama_oracle_scene_recovers_ground_truth():
    """``slam_result_pano`` of ``tests/test_slam_system.py`` through the port:
    all-zero artifact intrinsics, a map that the equirect camera projects."""
    import jax.numpy as jnp

    from vipe_tpu.ops import lie as jlie

    rng = np.random.default_rng(11)
    poses_w2c, disps, _ = make_gt(rng)
    stream = SyntheticStream(rng, disps, np.zeros(4, np.float32))
    ct = tcam.CameraType.PANORAMA
    intr_grid = tcam.panorama_intrinsics(HT, WD)
    out = _port_oracle_run(stream, lambda ref: _torch_oracle(
        ref, poses_w2c, disps, intr_grid, ct, zero_top_row=True), ct)
    assert out.camera_type == ct
    np.testing.assert_array_equal(out.intrinsics, 0.0)
    err = ate_rmse(out.trajectory, np.asarray(jlie.se3_inv(jnp.asarray(poses_w2c))), align=True)
    assert err < 0.03, f"panorama ATE {err}"
    xyz, _ = out.slam_map.masked_points()
    assert len(xyz) > 50
    w2c = tlie.se3_inv(torch.from_numpy(out.trajectory[0])).numpy()
    depth = out.slam_map.project_map(w2c, out.intrinsics, ct, (H, W), frame_idx=0)
    assert depth.shape == (H, W) and (depth > 0).sum() > 50
    assert 0.5 < float(np.median(depth[depth > 0])) < 5.0


# -------------------------------------------------------- given poses


class PosedStream(VideoStream):
    """The oracle scene's frames with their ground-truth camera-to-world
    poses attached."""

    def __init__(self, rng, disps, intr_full, poses_c2w):
        self.inner = SyntheticStream(rng, disps, intr_full)
        self.poses_c2w = np.asarray(poses_c2w, np.float32)

    def __len__(self):
        return T

    def frame_size(self):
        return (H, W)

    def attributes(self):
        return {FrameAttribute.RGB, FrameAttribute.INTRINSICS, FrameAttribute.METRIC_DEPTH,
                FrameAttribute.POSE}

    def __iter__(self):
        for k, f in enumerate(self.inner):
            yield VideoFrame(raw_frame_idx=k, rgb=f.rgb, metric_depth=f.metric_depth,
                             intrinsics=f.intrinsics, pose=self.poses_c2w[k])


def test_given_poses_are_kept_by_the_frontend():
    import jax.numpy as jnp

    from tests.test_torch_slam import make_torch_oracle
    from vipe_tpu.ops import lie as jlie

    rng = np.random.default_rng(3)
    poses_w2c, disps, intr_full = make_gt(rng)
    gt_c2w = np.asarray(jlie.se3_inv(jnp.asarray(poses_w2c)))
    stream = PosedStream(rng, disps, intr_full, gt_c2w)
    at_backend = []

    class SpyBackend(tsystem.SLAMBackend):
        def run(self, *a, **k):
            if not at_backend:
                n = self.buffer.n_frames
                at_backend.append((self.buffer.tstamp[:n].copy(), self.buffer.poses[:n].clone()))
            return super().run(*a, **k)

    ref = [None]
    orig = tsystem.SLAMBackend
    tsystem.SLAMBackend = SpyBackend
    try:
        out = _run_with_spy(tsystem, ref, lambda: tsystem.SLAMSystem(
            config=dict(ORACLE_CFG, backend_iters=12), device="cpu",
            update_fn=make_torch_oracle(ref, poses_w2c, disps, intr_full),
            encode_features=_zeros, encode_context=lambda im: (_zeros(im), _zeros(im)),
        ).run(stream))
    finally:
        tsystem.SLAMBackend = orig
    tstamp, poses = at_backend[0]
    given = tlie.se3_inv(torch.from_numpy(gt_c2w[tstamp]))
    torch.testing.assert_close(poses, given, rtol=0, atol=1e-6)
    assert out.frontend_stats["host_waits"] == 0
    assert np.abs(out.trajectory[:, :3] - gt_c2w[:, :3]).max() < 2e-2


# ------------------------------------------------------ default config


def test_default_slam_section_is_accepted():
    """The port's default SLAM section (the JAX default's, with the
    speculative ordering) constructs a system; the runs above drive it."""
    from vipe_tpu_torch.utils.config import compose, get_config_path

    slam = compose(get_config_path(), "default", ["pipeline=default"])["pipeline"]["slam"]
    assert slam["keyframe_spec_depth"] == 2 and slam["proximity_spec"] is True
    system = tsystem.SLAMSystem(config=slam, device="cpu", update_fn=lambda *a: None,
                                encode_features=_zeros, encode_context=_zeros)
    assert system.config == slam


# ------------------------------------------------ speculative ordering


class _Pass1Done(Exception):
    pass


def _texture_frames(frame_cls):
    tex = np.random.default_rng(0).random((H + 32, W + 32, 3)).astype(np.float32)
    intr = np.asarray([W, W, W / 2, H / 2], np.float32)
    for k in range(SPEC_FRAMES):
        yield frame_cls(raw_frame_idx=k, rgb=tex[0:H, 2 * k: 2 * k + W], intrinsics=intr.copy())


def _texture_stream(module):
    """The panning texture as a stream of ``module``'s stream layer."""
    import vipe_tpu.streams.base as jstreams
    import vipe_tpu_torch.streams.base as tstreams

    mod = jstreams if module is jsystem else tstreams

    class Texture(mod.VideoStream):
        def __len__(self):
            return SPEC_FRAMES

        def frame_size(self):
            return (H, W)

        def attributes(self):
            return {mod.FrameAttribute.RGB, mod.FrameAttribute.INTRINSICS}

        def __iter__(self):
            return _texture_frames(mod.VideoFrame)

    return Texture()


def _pass1(module, make_system, resolving=None):
    """Run ``module``'s SLAMSystem until its global backend and return its
    frontend; ``resolving[0]`` is True while a pending decision resolves."""
    frontends = []
    resolving = [False] if resolving is None else resolving

    class SpyFrontend(module.SLAMFrontend):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            frontends.append(self)

        def _resolve_one(self):
            resolving[0] = True
            try:
                return super()._resolve_one()
            finally:
                resolving[0] = False

    class StopBackend(module.SLAMBackend):
        def run(self, *a, **k):
            raise _Pass1Done

    orig = module.SLAMFrontend, module.SLAMBackend
    module.SLAMFrontend, module.SLAMBackend = SpyFrontend, StopBackend
    try:
        make_system().run(_texture_stream(module))
    except _Pass1Done:
        pass
    finally:
        module.SLAMFrontend, module.SLAMBackend = orig
    return frontends[0]


def _jax_pass1(fns, params, cfg):
    """The JAX run, recording the removal distances it compares with the
    threshold: the deferred step distances (read in ``finish_fused_step``)
    and the re-scores of younger decisions (``frame_distance`` while a
    decision resolves)."""
    from vipe_tpu.slam import buffer as jbuffer
    from vipe_tpu.slam import factor_graph as jfg

    dists, resolving = [], [False]
    orig_finish, orig_fd = jfg.FactorGraph.finish_fused_step, jbuffer.GraphBuffer.frame_distance

    def finish(self, d, *a, **k):
        out = orig_finish(self, d, *a, **k)
        dists.append(("step", out))
        return out

    def frame_distance(self, *a, **k):
        out = orig_fd(self, *a, **k)
        if resolving[0]:
            dists.append(("rescore", float(np.max(np.asarray(out)))))
        return out

    jfg.FactorGraph.finish_fused_step = finish
    jbuffer.GraphBuffer.frame_distance = frame_distance
    ef, ec, uf = fns
    try:
        fe = _pass1(jsystem, lambda: jsystem.SLAMSystem(
            config=cfg, update_fn=uf, params=params, encode_features=ef, encode_context=ec),
            resolving)
    finally:
        jfg.FactorGraph.finish_fused_step = orig_finish
        jbuffer.GraphBuffer.frame_distance = orig_fd
    return fe, dists


SPEC_CASES = {"keep_all": (0.0, True), "remove_all": (1e9, True),
              "mixed": (0.55, True), "mixed_post_step": (0.55, False)}


def _spec_cfg(thresh, prox):
    return dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=thresh, warmup=4,
                buffer=32, infill_chunk_size=6, backend_iters=4, proximity_spec=prox)


def _jax_params_job():
    import jax

    from tests.test_torch_droidnet import jax_droidnet_params

    return jax.tree_util.tree_map(np.asarray, jax_droidnet_params(HT, WD))


def _frontend_record(fe):
    """What the tests read of a JAX frontend after pass 1, as host data."""
    from types import SimpleNamespace

    g, b = fe.graph, fe.buffer
    return SimpleNamespace(
        spec_depth=fe.spec_depth, _pending=[None] * len(fe._pending),
        n_removals=fe.n_removals, t1=fe.t1,
        buffer=SimpleNamespace(n_frames=b.n_frames, tstamp=b.tstamp.copy(),
                               poses=np.asarray(b.poses)),
        graph=SimpleNamespace(can_fuse_frontend_step=g.can_fuse_frontend_step,
                              n_edges=g.n_edges, ii=g.ii.copy(), jj=g.jj.copy(),
                              ii_inac=g.ii_inac.copy(), jj_inac=g.jj_inac.copy()),
    )


def _jax_spec_job():
    """The JAX runs of every case (one compile: the threshold is an argument
    of JAX's fused step, and ``proximity_spec`` does not enter it)."""
    import jax.numpy as jnp

    from tests.test_torch_droidnet import jax_droidnet_params
    from vipe_tpu.models.droidnet import DroidNet as JDroidNet

    params = jax_droidnet_params(HT, WD)
    jfns = jsystem.make_droidnet_fns(JDroidNet(dtype=jnp.float32))
    runs = {}
    for name, (thresh, prox) in SPEC_CASES.items():
        fe_j, dists = _jax_pass1(jfns, params, _spec_cfg(thresh, prox))
        runs[name] = (_frontend_record(fe_j), [(kind, float(d)) for kind, d in dists])
    return runs


_JAX_JOBS = BackgroundJax({"params": (_jax_params_job, ()), "spec": (_jax_spec_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_JOBS.start()
    yield
    _JAX_JOBS.stop()


@pytest.fixture(scope="module")
def spec_runs():
    from vipe_tpu_torch.models.convert import droidnet_state_dict_from_flax
    from vipe_tpu_torch.models.droidnet import DroidNet

    model = DroidNet()
    model.load_state_dict(droidnet_state_dict_from_flax(_JAX_JOBS.result("params")))
    ef, ec, uf = tsystem.droidnet_fns(model.float().eval().requires_grad_(False))
    fronts = {}
    for name, (thresh, prox) in SPEC_CASES.items():
        fronts[name] = _pass1(tsystem, lambda: tsystem.SLAMSystem(  # noqa: B023
            config=_spec_cfg(thresh, prox), device="cpu", update_fn=uf, encode_features=ef,
            encode_context=ec))
    jax_runs = _JAX_JOBS.result("spec")
    return {name: (SPEC_CASES[name][0], jax_runs[name][0], fronts[name], jax_runs[name][1])
            for name in SPEC_CASES}


@pytest.mark.parametrize("case", list(SPEC_CASES))
class TestSpeculativeOrdering:
    def test_decisions_have_margin(self, spec_runs, case):
        thresh, fe_j, _, dists = spec_runs[case]
        assert fe_j.graph.can_fuse_frontend_step and fe_j.spec_depth == 2
        if thresh == 0.0:
            return  # no distance is negative: nothing to flip
        assert dists, "the JAX run read no removal distance"
        for kind, d in dists:
            assert abs(d - thresh) >= 0.05 * thresh, (kind, d, thresh)

    def test_keyframes_and_removals_equal(self, spec_runs, case):
        _, fe_j, fe_t, _ = spec_runs[case]
        n = fe_j.buffer.n_frames
        assert fe_t.speculative and not fe_t._pending and not fe_j._pending
        np.testing.assert_array_equal(fe_t.buffer.tstamp[: fe_t.buffer.n_frames],
                                      fe_j.buffer.tstamp[:n])
        assert fe_t.n_removals == fe_j.n_removals and fe_t.t1 == fe_j.t1 == n

    def test_graph_edges_equal(self, spec_runs, case):
        _, fe_j, fe_t, _ = spec_runs[case]
        m = fe_j.graph.n_edges
        np.testing.assert_array_equal(fe_t.graph.ii, fe_j.graph.ii[:m])
        np.testing.assert_array_equal(fe_t.graph.jj, fe_j.graph.jj[:m])
        np.testing.assert_array_equal(fe_t.graph.ii_inac, fe_j.graph.ii_inac)
        np.testing.assert_array_equal(fe_t.graph.jj_inac, fe_j.graph.jj_inac)

    def test_keyframe_poses_close(self, spec_runs, case):
        _, fe_j, fe_t, _ = spec_runs[case]
        n = fe_j.buffer.n_frames
        np.testing.assert_allclose(fe_t.buffer.poses[:n].numpy(), np.asarray(fe_j.buffer.poses[:n]),
                                   rtol=0, atol=1e-2)

    def test_case_reaches_its_branch(self, spec_runs, case):
        thresh, fe_j, fe_t, dists = spec_runs[case]
        if case == "keep_all":
            assert fe_t.n_removals == 0 and fe_t.t1 == SPEC_FRAMES
        elif case == "remove_all":
            assert fe_t.n_removals == SPEC_FRAMES - 4 and fe_t.late_removals > 0
        else:
            assert 0 < fe_t.n_removals < SPEC_FRAMES - 4 and fe_t.late_removals > 0
            assert any(kind == "rescore" for kind, _ in dists)
