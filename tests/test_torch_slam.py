"""The port's SLAM layer against ``vipe_tpu.slam``.

* ``ba_iteration``: one Gauss-Newton step from the same state, f32 on both
  sides; the Jacobians come from forward-mode autodiff on both, the Schur
  sums run in another order, so poses/disps agree to 1e-5 and the shared
  focal (a sum over every pixel of every edge) to 1e-3 px; the same under
  the MEI camera (focal and k1 optimised), the panorama (the top grid row
  on its pole) and with every pose fixed (a stream that gives poses).
* one ``FactorGraph.update`` round from the same buffer state with the same
  DroidNet weights in bf16: atol 2e-2, the bound that
  ``tests/test_fused_update.py`` argues for one bf16 GRU+BA round; the same
  in ``corr_mode=alt`` (packed features, K2) and ``corr_dtype=int8``
  (quantised volumes with per-edge scales, K1), each against the JAX graph
  in the same mode.
* the graph's row machinery for packed and int8 rows: after removals the
  stored rows equal a fresh build for the surviving edges (packed: exactly;
  int8: within 1.5e-2 of the volume's magnitude, the JAX test's bound); a
  late removal (``rm_keyframe(ix, top)``, the speculative frontend's) in
  each correlation mode leaves the JAX graph's topology, ages, inactive
  store, buffer rows and correlation rows.
* the slice as a whole: ``SLAMSystem.run`` of both packages on the
  geometric-oracle stream of ``tests/test_slam_system.py`` (JAX in its
  reference-exact ordering, ``keyframe_spec_depth=1, proximity_spec=False``):
  equal keyframe sets; trajectories and intrinsics within 1e-4 (f32 BA
  rounding over ~300 Gauss-Newton iterations, measured ≤1e-6); the same in
  ``corr_mode=alt`` and ``corr_dtype=int8``, where the inner filler's graph
  must hold packed features (alt) or bf16 volumes (int8), as the JAX
  package's filler does; once more with per-frame masks, the
  ``constant-2.0`` keyframe depth prior and a keyframe stride; and with the
  UniDepth-S prior in its place (the port's seeded weights, a 64-wide
  decoder): equal keyframes and prior inputs, trajectory and intrinsics
  within 2e-2 (measured 5.2e-3 and 0), the port's f32 prior on those
  inputs within 1e-4 of the JAX package's f32 path (measured 4.0e-6), and
  the port's bf16 prior within 5e-2 of its f32 path (measured 9.5e-3).
  The JAX system runs once per scene, the oracle's in volume/bf16: with
  the oracle, which ignores the correlation features, its alt and int8
  runs give the same output bit for bit, so the port's alt and int8 runs
  are held against that one.  The JAX runs of the scenes go in a spawned
  process (``BackgroundJax``) that the module's first test starts, and the
  references of the BA steps and the graph rounds in a second one: they
  compile hundreds of XLA programs, which overlap the port's tests (with
  one process the file took 239 s against 203 s).  So the port's work
  runs first: the tests of the port alone, then the port runs of the
  volume, alt, int8 and options scenes before the first wait on JAX, the
  graph rounds last.  The masks' downsampling equals the JAX system's
  ``cv2.resize`` formula; the depth prior's refresh equals the JAX
  buffer's.
* random-weight DroidNet runs of the port (volume and alt): finite outputs
  of the right shape.  Random-weight trajectories diverge chaotically between frameworks
  (``tests/test_frontend_deferred.py``), so none is bounded.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_slam_system import (H, HT, T, W, WD, SyntheticStream, make_gt,
                                    make_oracle)
from vipe_tpu.streams.base import FrameAttribute as JFrameAttribute
from vipe_tpu.ops import cameras as jcam
from vipe_tpu.ops import lie as jlie
from vipe_tpu.slam import ba as jba
from vipe_tpu_torch.ops import cameras as tcam
from vipe_tpu_torch.ops import geom as tgeom
from vipe_tpu_torch.slam import ba as tba
from vipe_tpu_torch.slam import system as tsystem

SYSTEM_CFG = dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=0.0, warmup=4,
                  buffer=64, infill_chunk_size=6, backend_iters=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------ the port alone, while JAX works


def test_mask_grid_matches_cv2():
    """``mask_grid`` against the JAX system's ``cv2.resize(INTER_LINEAR)``
    formula on masks with edges at every offset of the 8-pixel cells, and
    at 2 sizes.  Exactly equal; no cell's valid fraction lies within 1e-3
    of the 0.9 threshold, so neither side's rounding could flip one."""
    import cv2
    import torch.nn.functional as F

    rng = np.random.default_rng(11)
    for h, w in ((48, 64), (96, 136)):
        ht, wd = h // 8, w // 8
        mask = np.ones((h, w), bool)
        mask[: h // 5] = False
        mask[rng.integers(0, h, 40), rng.integers(0, w, 40)] = False
        mask[10:10 + rng.integers(1, 20), 3:50] = False
        ref = ~(cv2.resize(mask.astype(np.float32), (wd, ht), interpolation=cv2.INTER_LINEAR) > 0.9)
        got = tsystem.mask_grid(mask, ht, wd)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < ref.sum() < ref.size
        frac = F.interpolate(torch.from_numpy(mask.astype(np.float32))[None, None], size=(ht, wd),
                             mode="bilinear", align_corners=False)[0, 0]
        assert float((frac - 0.9).abs().min()) > 1e-3


def test_update_disps_sens_matches_jax():
    """The keyframe depth prior per slot, then after the focal changed: a
    metric prior is rescaled by the focal ratio (no re-run), as the JAX
    buffer does; unchanged intrinsics leave it untouched."""
    from vipe_tpu.priors.depth.base import ConstantDepthModel as JConst
    from vipe_tpu.slam.buffer import GraphBuffer as JBuffer
    from vipe_tpu_torch.priors.depth.base import ConstantDepthModel as TConst
    from vipe_tpu_torch.slam.buffer import GraphBuffer as TBuffer

    rng = np.random.default_rng(2)
    jb, tb = JBuffer(height=H, width=W, buffer_size=8), TBuffer(height=H, width=W, buffer_size=8)
    intr = np.asarray([W, W, W / 2, H / 2], np.float32)
    jm, tm = JConst(1.7), TConst(1.7)
    for k in range(3):
        img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        feat = np.zeros((HT, WD, 128), np.float32)
        # copies: a CPU jax array may share the numpy buffer it came from
        jb.append_keyframe(k, jnp.asarray(img), feat, None, None, intrinsics=intr.copy())
        tb.append_keyframe(k, torch.from_numpy(img), torch.from_numpy(feat), None, None,
                           intrinsics=intr.copy())
        jb.update_disps_sens(jm, frame_idx=k)
        tb.update_disps_sens(tm, frame_idx=k)
    np.testing.assert_allclose(tb.disps_sens[:3].numpy(), np.asarray(jb.disps_sens[:3]), rtol=1e-6)
    for step in ("same", "focal"):
        if step == "focal":
            jb.intrinsics = jb.intrinsics.at[:2].multiply(1.25)
            tb.intrinsics[:2] *= 1.25
        jb.update_disps_sens(jm)
        tb.update_disps_sens(tm)
        np.testing.assert_allclose(tb.disps_sens[:4].numpy(), np.asarray(jb.disps_sens[:4]),
                                   rtol=1e-6, err_msg=step)
    assert float(tb.disps_sens[0, 0, 0]) == pytest.approx(1 / 1.7 / 1.25)


# ------------------------------------------------- random-weight DroidNet


def _random_weight_run(**corr_cfg):
    rng = np.random.default_rng(7)
    _, disps, intr_full = make_gt(rng)
    stream = SyntheticStream(rng, disps, intr_full, with_depth=False)
    return tsystem.SLAMSystem(
        config=dict(resize_area=H * W, filter_thresh=0.0, warmup=4, buffer=32,
                    infill_chunk_size=6, backend_iters=1, **corr_cfg),
        device="cpu",
    ).run(stream)


def _check_finite_run(out):
    assert out.trajectory.shape == (T, 7) and np.isfinite(out.trajectory).all()
    assert out.intrinsics.shape == (4,) and np.isfinite(out.intrinsics).all()
    assert out.keyframes[0] == 0 and out.keyframes[-1] == T - 1
    assert np.isfinite(out.slam_map.xyz).all()


def test_random_weight_droidnet_run_is_finite():
    _check_finite_run(_random_weight_run())


def test_random_weight_droidnet_alt_run_is_finite():
    _check_finite_run(_random_weight_run(corr_mode="alt"))


def _step_buffer(n):
    """A buffer of ``n`` frames of seeded images and zero features, the
    first two 0.1 apart in x, at the oracle scene's intrinsics."""
    from vipe_tpu_torch.slam.buffer import GraphBuffer

    rng = np.random.default_rng(5)
    buf = GraphBuffer(height=H, width=W, buffer_size=8)
    feat = torch.zeros((HT, WD, 128), dtype=torch.bfloat16)
    for k in range(n):
        img = torch.from_numpy((rng.random((H, W, 3)) * 255).astype(np.uint8))
        buf.append_keyframe(k, img, feat, feat, feat,
                            intrinsics=np.asarray([W * 1.2, W * 1.2, W / 2, H / 2], np.float32))
    buf.poses[1, 0] = 0.1
    return buf


@pytest.mark.parametrize("key,value", [
    ("visualize", True), ("infill_dense_disp", True), ("sparse_tracks", {"name": "lk"}),
])
def test_slam_options_build_and_step(key, value, tmp_path):
    """``SLAMSystem`` takes each option, and the option's own step runs on a
    small buffer: the telemetry snapshot, the filler's disparities, the LK
    tracker.  The whole runs are held against the JAX package in
    ``tests/test_torch_slam_tracks.py``."""
    from vipe_tpu_torch.slam.inner_filler import InnerFiller
    from vipe_tpu_torch.slam.sparse_tracks import LKSparseTracks, build_sparse_tracks
    from vipe_tpu_torch.utils.telemetry import TelemetryWriter, read_snapshot

    system = tsystem.SLAMSystem(config={key: value}, device="cpu", update_fn=lambda *a: None,
                                encode_features=None, encode_context=None)
    assert system.config[key] == value
    if key == "visualize":
        writer = TelemetryWriter(tmp_path, name="clip", every=2)
        assert not writer.update(_step_buffer(1))
        assert writer.update(_step_buffer(2))
        snap = read_snapshot(tmp_path / "clip_live.npz")
        assert set(snap) == {"n_keyframes", "tstamp", "poses_w2c", "cloud_xyz", "cloud_rgb",
                             "wall_time"}
        assert snap["n_keyframes"] == 2 and snap["cloud_xyz"].shape == (HT * WD, 3)
    elif key == "infill_dense_disp":
        buf = _step_buffer(3)

        def still(net, inp, corr, motn, ii, jj, num_frames):
            delta = torch.zeros(motn.shape[:-1] + (2,))
            return net, delta, torch.ones_like(delta), torch.full((num_frames, HT, WD), 0.01)

        filler = InnerFiller(buf, still, {key: value})
        assert filler.needs_context
        filler.set_start_idx(2)
        filler.compute()
        out = filler.get_result()
        assert out.poses.shape == (1, 7) and out.dense_disps.shape == (1, HT, WD)
        assert np.isfinite(out.dense_disps).all()
    else:
        tracks = build_sparse_tracks(value)
        assert isinstance(tracks, LKSparseTracks) and tracks.enabled
        rng = np.random.default_rng(6)
        canvas = rng.random((H, W + 8, 3)).astype(np.float32)
        for k in range(2):
            tracks.track_image(k, [type("Frame", (), {"rgb": canvas[:, 2 * k:2 * k + W]})])
        assert tracks.get_correspondences(0, 0, 1)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.SLAMSystem(config={}, update_fn=lambda *a: None)


# ------------------------------------------------------------------- BA


@functools.lru_cache(maxsize=None)
def _ba_state():
    rng = np.random.default_rng(0)
    N, ht, wd = 5, 6, 8
    P = ht * wd
    xi = (0.05 * rng.standard_normal((N, 6))).astype(np.float32)
    xi[:, 0] += 0.1 * np.arange(N)
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = (0.5 + 0.2 * rng.random((N, P))).astype(np.float32)
    intr = np.array([64.0, 64.0, 32.0, 24.0], np.float32)
    ii = np.array([0, 1, 1, 2, 2, 3, 3, 4, 0, 2])
    jj = np.array([1, 0, 2, 1, 3, 2, 4, 3, 2, 0])
    E = len(ii)
    target = (rng.random((E, P, 2)) * np.array([wd, ht])).astype(np.float32)
    weight = (0.001 * rng.random((E, P, 2))).astype(np.float32)
    edge_valid = np.ones(E, bool)
    edge_valid[-1] = False
    pose_mask = np.arange(N) >= 1
    disp_mask = np.ones(N, bool)
    damp = np.full((N, P), 0.2 * 0.01 + 1e-7, np.float32)
    sens = np.zeros((N, P), np.float32)
    sens_mask = np.zeros(N, np.float32)
    sens[2], sens_mask[2] = 0.5, 1.0
    return dict(N=N, ht=ht, wd=wd, poses=poses, disps=disps, intr=intr, ii=ii, jj=jj,
                target=target, weight=weight, edge_valid=edge_valid, pose_mask=pose_mask,
                disp_mask=disp_mask, damp=damp, sens=sens, sens_mask=sens_mask)


@pytest.fixture(scope="module")
def ba_state():
    return _ba_state()


def _ba_cases():
    """``_ba_state`` under the other cameras and with given poses:
    ``mei`` optimises the 5-parameter intrinsics (shared focal and k1);
    ``panorama`` takes the equirect intrinsics of the 48×64 frame, whose top
    grid row lies on the pole; ``fixed_poses`` fixes every pose, as the
    frontend does for a stream that gives its poses.  name → (state,
    optimize_intrinsics)."""
    base = _ba_state()
    cases = {"pinhole": (base, True)}
    s = dict(base, camera="mei", intr=np.array([64.0, 64.0, 32.0, 24.0, 0.6], np.float32))
    cases["mei"] = (s, True)
    s = dict(base, camera="panorama",
             intr=np.asarray(jcam.panorama_intrinsics(8 * base["ht"], 8 * base["wd"])))
    cases["panorama"] = (s, False)
    cases["fixed_poses"] = (dict(base, pose_mask=np.zeros(base["N"], bool)), False)
    return cases


def _jax_ba_job():
    """One JAX Gauss-Newton step of every case of ``_ba_cases``."""
    return {name: _ba_jax(s, oi) for name, (s, oi) in _ba_cases().items()}


# one compile per configuration instead of an eager dispatch per operation
_jax_ba_iteration = jax.jit(jba.ba_iteration, static_argnums=0)


def _ba_jax(s, optimize_intrinsics):
    cfg = jba.BAConfig(camera_type=jcam.CameraType(s.get("camera", "pinhole")), ht=s["ht"],
                       wd=s["wd"], optimize_intrinsics=optimize_intrinsics,
                       max_edges_per_frame=8)
    slot = jba.build_edge_slots(s["ii"], None, s["N"], 8)
    rig = np.asarray(jlie.se3_identity((1,)))
    z = np.zeros(len(s["ii"]), np.int32)
    args = (s["poses"], rig, s["disps"], s["intr"][None], s["target"], s["weight"], s["ii"], z,
            s["ii"], s["jj"], z, s["edge_valid"], slot, s["pose_mask"], s["disp_mask"],
            s["damp"], s["sens"], s["sens_mask"])
    p, _, d, intr, _ = _jax_ba_iteration(cfg, *map(jnp.asarray, args), 1e-3, 0.1)
    return np.asarray(p), np.asarray(d), np.asarray(intr[0])


def _ba_torch(s, optimize_intrinsics):
    cfg = tba.BAConfig(camera_type=tcam.CameraType(s.get("camera", "pinhole")), ht=s["ht"],
                       wd=s["wd"], optimize_intrinsics=optimize_intrinsics,
                       max_edges_per_frame=8)
    slot = tba.build_edge_slots(s["ii"], s["N"], 8)
    args = (s["poses"], s["disps"], s["intr"], s["target"], s["weight"], s["ii"], s["jj"],
            s["edge_valid"], slot, s["pose_mask"], s["disp_mask"], s["damp"], s["sens"],
            s["sens_mask"])
    p, d, intr = tba.ba_iteration(cfg, *(torch.from_numpy(np.array(a)) for a in args), 1e-3, 0.1)
    return p.numpy(), d.numpy(), intr.numpy()


def test_ba_iteration_matches_jax(ba_state):
    """With the shared focal optimised: the full (6N + 1) system."""
    optimize_intrinsics = True
    pt, dt, it = _ba_torch(ba_state, optimize_intrinsics)
    pj, dj, ij = _JAX_REFS.result("ba")["pinhole"]
    assert np.abs(pj - ba_state["poses"]).max() > 1e-2  # the step moves the poses
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-3)
    assert np.abs(it - ba_state["intr"]).max() > 1e-3  # the focal moved


@pytest.fixture(scope="module", params=["mei", "panorama", "fixed_poses"])
def ba_case(request):
    """A case of ``_ba_cases``: (name, state, optimize_intrinsics)."""
    return (request.param,) + _ba_cases()[request.param]


def test_ba_iteration_camera_matches_jax(ba_case):
    """One Gauss-Newton step at the bounds of ``test_ba_iteration_matches_jax``;
    the panorama's pole row stays finite."""
    name, s, optimize_intrinsics = ba_case
    pt, dt, it = _ba_torch(s, optimize_intrinsics)
    pj, dj, ij = _JAX_REFS.result("ba")[name]
    assert np.isfinite(pt).all() and np.isfinite(dt).all()
    assert np.abs(dj - s["disps"]).max() > 1e-3  # the step moves the disparities
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-3)
    if optimize_intrinsics:
        assert np.abs(it - s["intr"])[[0, 4]].min() > 1e-6  # focal and k1 moved
    if not s["pose_mask"].any():
        np.testing.assert_array_equal(pt, s["poses"])


def test_build_edge_slots_matches_jax(ba_state):
    s = ba_state
    np.testing.assert_array_equal(tba.build_edge_slots(s["ii"], s["N"], 8),
                                  np.asarray(jba.build_edge_slots(s["ii"], None, s["N"], 8)))
    with pytest.raises(ValueError):
        tba.build_edge_slots(s["ii"], s["N"], 1)


def test_singular_system_gives_nan_not_raise(ba_state):
    """A failed factorisation yields NaN steps (as JAX's ``cho_factor``)."""
    s = dict(ba_state)
    s["poses"] = s["poses"].copy()
    s["poses"][1, :3] = np.nan
    pt, _, _ = _ba_torch(s, False)
    assert np.isnan(pt[1:]).any()


# ----------------------------------------------------------- one GRU round


@functools.lru_cache(maxsize=None)
def _jax_update_fn():
    """One jitted JAX update function for every graph of this module, so
    its compiles are shared."""
    from vipe_tpu.models.droidnet import DroidNet
    from vipe_tpu.slam.system import make_droidnet_fns

    return make_droidnet_fns(DroidNet())[2]


def _jax_graph(seed=3, n=6, corr_mode="volume", corr_dtype="bf16"):
    """JAX buffer + graph as in tests/test_fused_update.py, with seeded
    random features in the slots (the encoders are held in
    test_torch_droidnet.py)."""
    import jax

    from tests.test_torch_droidnet import jax_droidnet_params
    from vipe_tpu.slam.buffer import GraphBuffer
    from vipe_tpu.slam.factor_graph import FactorGraph

    params = jax_droidnet_params(HT, WD)
    uf = _jax_update_fn()
    rng = np.random.default_rng(seed)
    buf = GraphBuffer(height=H, width=W, buffer_size=32)
    for k in range(n):
        img = jnp.asarray((rng.random((H, W, 3)) * 255).astype(np.uint8))
        fmap, net, inp = (jnp.asarray(rng.standard_normal((HT, WD, 128)), jnp.bfloat16)
                          for _ in range(3))
        buf.append_keyframe(k, img, fmap, jnp.tanh(net), jax.nn.relu(inp),
                            intrinsics=np.asarray([W, W, W / 2, H / 2], np.float32))
        buf.poses = buf.poses.at[k, 0].set(0.1 * k + 0.01 * rng.normal())
        buf.disps = buf.disps.at[k].add(0.1 * jnp.asarray(rng.random((HT, WD)), jnp.float32))
    g = FactorGraph(buf, uf, params, max_factors=16, incremental=True,
                    corr_mode=corr_mode, corr_dtype=corr_dtype)
    g.add_neighborhood_factors(0, n, r=1)
    return params, buf, g


def _torch_graph_like(params, jbuf, n=6, corr_mode="volume", corr_dtype="bf16"):
    """The port's buffer + graph holding the same state and weights."""
    import jax

    from vipe_tpu_torch.models.convert import droidnet_state_dict_from_flax
    from vipe_tpu_torch.models.droidnet import DroidNet
    from vipe_tpu_torch.slam.buffer import GraphBuffer
    from vipe_tpu_torch.slam.factor_graph import FactorGraph

    model = DroidNet()
    model.load_state_dict(droidnet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    model = model.to(torch.bfloat16).eval()
    _, _, uf = tsystem.droidnet_fns(model)
    buf = GraphBuffer(height=H, width=W, buffer_size=32)

    def f32(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))

    buf.n_frames = jbuf.n_frames
    buf.tstamp[:] = jbuf.tstamp
    buf.poses[:n] = f32(jbuf.poses[:n])
    buf.disps[:n] = f32(jbuf.disps[:n])
    buf.intrinsics = f32(jbuf.intrinsics)
    for name in ("fmaps", "nets", "inps"):
        getattr(buf, name)[:n] = f32(getattr(jbuf, name)[:n]).to(torch.bfloat16)
    g = FactorGraph(buf, uf, max_factors=16, incremental=True,
                    corr_mode=corr_mode, corr_dtype=corr_dtype)
    g.add_neighborhood_factors(0, n, r=1)
    return buf, g


def _check_corr_state(jg, tg):
    """The same correlation state from the same features: volumes to one
    bf16 ulp; packed features bit for bit; int8 rows, which can round the
    other way where the bf16 volumes differ by an ulp, to one quantisation
    step, and their scales to one bf16 ulp."""
    n = jg.n_edges
    assert len(tg.corr_pyr) == len(jg.corr_pyr)
    for lvl, (j, t) in enumerate(zip(jg.corr_pyr, tg.corr_pyr)):
        ref = np.asarray(j[:n].astype(jnp.float32))
        assert t.dtype == (torch.int8 if tg.corr_q else torch.bfloat16)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
        if tg.corr_alt:
            np.testing.assert_array_equal(t.float().numpy(), ref)
        elif tg.corr_q:
            assert np.abs(t.float().numpy() - ref).max() <= 1
            np.testing.assert_allclose(tg.corr_scale[lvl].numpy(),
                                       np.asarray(jg.corr_scale[lvl][:n]), rtol=2 ** -8)
        else:
            np.testing.assert_allclose(t.float().numpy(), ref, rtol=2 ** -8, atol=1e-6)


ROUND_MODES = (("volume", "bf16"), ("alt", "bf16"), ("volume", "int8"))


def _graph_record(jbuf, jg):
    """What the tests read of a JAX buffer and graph, copied to the host."""
    from types import SimpleNamespace

    def host(x):
        return None if x is None else np.array(x)

    buf = SimpleNamespace(n_frames=jbuf.n_frames, tstamp=jbuf.tstamp.copy(),
                          **{k: host(getattr(jbuf, k)) for k in (
                              "poses", "disps", "intrinsics", "fmaps", "nets", "inps")})
    scale = getattr(jg, "corr_scale", None)
    graph = SimpleNamespace(
        n_edges=jg.n_edges, corr_pyr=[host(p) for p in jg.corr_pyr],
        corr_scale=None if scale is None else [host(x) for x in scale],
        **{k: host(getattr(jg, k)) for k in (
            "ii", "jj", "age", "ii_inac", "jj_inac", "target_inac", "weight_inac", "target",
            "weight", "damping")})
    return buf, graph


def _late_removal_calls(buf, graph, n):
    """The late removal's calls, the same on either package's buffer and
    graph: an initialised next slot at ``n`` (the frontend's keep branch
    leaves one), aged edges, two evicted into the inactive store, then
    ``rm_keyframe(2, top=n)``."""
    if isinstance(buf.poses, torch.Tensor):
        buf.poses[n, 0], buf.disps[n] = 0.7, 0.8
    else:
        buf.poses = buf.poses.at[n, 0].set(0.7)
        buf.disps = buf.disps.at[n].set(0.8)
    graph.age[: graph.n_edges] = np.arange(graph.n_edges) % 5
    evict = np.zeros(graph.n_edges, bool)
    evict[[0, 3]] = True
    graph.rm_factors(evict, store=True)
    graph.rm_keyframe(2, top=n)


def _jax_rounds_job():
    """Per mode of ``ROUND_MODES``, host records of the JAX buffer and graph
    of ``_jax_graph``: before and after one ``update`` round, and before and
    after the late removal's calls; and the DroidNet params."""
    out = {}
    for mode in ROUND_MODES:
        params, jbuf, jg = _jax_graph(n=6, corr_mode=mode[0], corr_dtype=mode[1])
        before = _graph_record(jbuf, jg)
        jg.update(use_inactive=True)
        out["round", mode] = before, _graph_record(jbuf, jg)
        params, jbuf, jg = _jax_graph(n=6, corr_mode=mode[0], corr_dtype=mode[1])
        before = _graph_record(jbuf, jg)
        _late_removal_calls(jbuf, jg, 6)
        out["late", mode] = before, _graph_record(jbuf, jg)
    out["params"] = jax.tree_util.tree_map(np.asarray, params)
    return out


def _check_update_round(corr_mode="volume", corr_dtype="bf16"):
    n = 6
    rounds = _JAX_REFS.result("rounds")
    (jbuf, jg), (jbuf1, jg1) = rounds["round", (corr_mode, corr_dtype)]
    tbuf, tg = _torch_graph_like(rounds["params"], jbuf, n=n, corr_mode=corr_mode,
                                 corr_dtype=corr_dtype)
    np.testing.assert_array_equal(tg.ii, jg.ii[: jg.n_edges])
    np.testing.assert_array_equal(tg.jj, jg.jj[: jg.n_edges])
    _check_corr_state(jg, tg)

    with torch.no_grad():
        tg.update(use_inactive=True)
    pairs = {
        "poses": (tbuf.poses[:n], jbuf1.poses[:n]),
        "disps": (tbuf.disps[:n], jbuf1.disps[:n]),
        "target": (tg.target, jg1.target[: jg1.n_edges]),
        "weight": (tg.weight, jg1.weight[: jg1.n_edges]),
        "damping": (tg.damping[:8], jg1.damping[:8]),
    }
    for key, (t, j) in pairs.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-2,
                                   err_msg=f"mismatch in {key}")
    np.testing.assert_array_equal(tg.age, jg1.age[: jg1.n_edges])
    assert float(torch.abs(tbuf.poses[1:n, :3] - torch.from_numpy(
        np.array(jbuf1.poses[1:n, :3]))).max()) < 2e-2


# ------------------------------------------------------- the slice, oracle


def make_torch_oracle(buffer_ref, poses_w2c_gt, disps_gt, intr_full):
    """Torch copy of ``tests/test_slam_system.make_oracle``: GT flow targets,
    unit weights where the GT reprojection is valid, constant damping."""
    P = torch.from_numpy(np.array(poses_w2c_gt))
    D = torch.from_numpy(np.array(disps_gt))
    intr_grid = torch.from_numpy(np.array(intr_full) / 8.0).float()

    def update_fn(net, inp, corr, motn, ii, jj, num_frames):
        E, ht, wd, _ = motn.shape
        coords1 = motn[..., :2] + tgeom.coords_grid(ht, wd)
        buf = buffer_ref[0]
        fi = torch.from_numpy(buf.tstamp[np.clip(ii.numpy(), 0, buf.buffer_size - 1)])
        fj = torch.from_numpy(buf.tstamp[np.clip(jj.numpy(), 0, buf.buffer_size - 1)])
        gt_coords, gt_valid = tgeom.reproject(P, D, intr_grid, tcam.CameraType.PINHOLE, fi, fj)
        delta = gt_coords - coords1
        weight = gt_valid[..., None].float().expand_as(delta)
        return net, delta, weight, torch.full((num_frames, ht, wd), 0.01)

    update_fn.host_only = True  # reads host state: the sequential frontend, as in JAX
    return update_fn


def _run_with_spy(module, buffer_ref, run):
    orig = module.GraphBuffer

    class SpyBuffer(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            buffer_ref[0] = self

    module.GraphBuffer = SpyBuffer
    try:
        return run()
    finally:
        module.GraphBuffer = orig


ORACLE_SEED = 3
CORR_KEYS = ("corr_mode", "corr_dtype")


def _reference_env():
    """The environment of a JAX reference process: a compile cache of this
    test session's own (a directory under the session's temporary
    directory, named by the xdist run id) into which every compile is
    written, not only those over the session cache's 1 s threshold, so
    that a later reference process of the session loads what an earlier
    one compiled, and nothing outside the session sees it."""
    import tempfile

    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or str(os.getpid())
    return {"JAX_COMPILATION_CACHE_DIR": os.path.join(tempfile.gettempdir(),
                                                      f"vipe_tpu_torch_jax_refs_{run}"),
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}


class BackgroundJax:
    """JAX reference runs in one spawned process.  The JAX package runs the
    host-driven oracle scenes op by op, compiling hundreds of small XLA
    programs; in a process of their own they take another core while the
    module's other tests run, and the tests that compare wait for their
    results.  ``jobs`` maps a name to a picklable (function, args); they run
    in order, so later ones reuse the compiles of earlier ones.  ``start``
    runs from the module's first test, not at import: every xdist worker
    imports the module, one runs it."""

    def __init__(self, jobs):
        self.jobs = dict(jobs)
        self.pool = None
        self.futures = {}

    def start(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # a spawned process takes the environment of its parent at the
        # first submit, which starts it
        env = _reference_env()
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            self.pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
            self.futures = {name: self.pool.submit(fn, *args)
                            for name, (fn, args) in self.jobs.items()}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v

    def result(self, name):
        return self.futures[name].result()

    def stop(self):
        """Cancels the jobs not started, waits for a running one (killed, it
        could leave a truncated entry in the compile cache) and ends the
        process."""
        self.pool.shutdown(wait=True, cancel_futures=True)
        self.pool = None


@functools.lru_cache(maxsize=None)
def _oracle_scene(seed=ORACLE_SEED):
    rng = np.random.default_rng(seed)
    poses_w2c, disps, intr_full = make_gt(rng)
    return poses_w2c, disps, intr_full, SyntheticStream(rng, disps, intr_full)


def _jax_oracle_job():
    """The JAX system on the oracle scene in volume/bf16, run once for every
    parity test of this module.  The oracle update function ignores the
    correlation features, so JAX's ``corr_mode=alt`` and ``corr_dtype=int8``
    runs of the same scene give this output bit for bit; the port's runs in
    those modes are held against it, and each graph's correlation state
    against JAX's in the same mode (``test_factor_graph_update_round_*``).
    Returns (scene seed, config, output)."""
    import vipe_tpu.slam.system as jsystem

    poses_w2c, disps, intr_full, stream = _oracle_scene()
    ref_j = [None]
    oracle_j = make_oracle(ref_j, poses_w2c, disps, intr_full)

    def ef_j(params, images):
        return jnp.zeros((images.shape[0], HT, WD, 128), jnp.float32)

    def ec_j(params, images):
        z = ef_j(params, images)
        return z, z

    config = dict(SYSTEM_CFG, keyframe_spec_depth=1, proximity_spec=False)
    out_j = _run_with_spy(jsystem, ref_j, lambda: jsystem.SLAMSystem(
        config=config, update_fn=oracle_j, params=None, encode_features=ef_j,
        encode_context=ec_j,
    ).run(stream))
    return ORACLE_SEED, config, out_j


def _options_scene():
    rng = np.random.default_rng(ORACLE_SEED)
    poses_w2c, disps, intr_full = make_gt(rng)
    stream = MaskedNoDepthStream(rng, disps, intr_full, with_depth=False)
    return poses_w2c, disps, intr_full, stream, dict(SYSTEM_CFG, filter_thresh=float("inf"),
                                                     keyframe_stride=1)


def _jax_options_job():
    """The JAX system on the options scene of ``oracle_runs_options``."""
    import vipe_tpu.slam.system as jsystem
    from vipe_tpu.priors.depth.factory import make_depth_model as jmake

    poses_w2c, disps, intr_full, stream, cfg = _options_scene()
    ref_j = [None]
    oracle_j = make_oracle(ref_j, poses_w2c, disps, intr_full)

    def ef_j(params, images):
        return jnp.zeros((images.shape[0], HT, WD, 128), jnp.float32)

    return _run_with_spy(jsystem, ref_j, lambda: jsystem.SLAMSystem(
        config=dict(cfg, keyframe_spec_depth=1, proximity_spec=False), update_fn=oracle_j,
        params=None, encode_features=ef_j, encode_context=lambda p, im: (ef_j(p, im),) * 2,
        metric_depth=jmake("constant-2.0"),
    ).run(stream))


UNIDEPTH_BOUNDS = dict(pixels_min=3_000, pixels_max=6_000)  # a 48×64 frame → 56×70
# UniDepth-S with a 64-wide decoder (tests/test_torch_unidepth.py's)
UNIDEPTH_NARROW = dict(variant="vits", hidden_dim=64, num_heads=4)


def _unidepth_weights():
    """The port's seeded UniDepth-S weights, as numpy."""
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthConfig, UniDepthNet, init_unidepth_

    net = UniDepthNet("vits", UniDepthConfig(**UNIDEPTH_NARROW))
    return {k: v.numpy() for k, v in init_unidepth_(net, 0).state_dict().items()}


def _disparity_grid(depth):
    """A depth map → the (H/8, W/8) disparity prior's grid, as the SLAM
    prior samples and inverts it."""
    d = np.asarray(depth, np.float32)[3::8, 3::8]
    return np.where(d > 0, 1.0 / np.maximum(d, 1e-8), d)


def _jax_unidepth_job():
    """The JAX system on the options scene with the UniDepth-S prior (the
    port's seeded weights) in place of the constant one.  Returns the
    output, the inputs of every call of the prior (image, intrinsics row)
    and, on each, the JAX package's f32 path (``estimate`` at the row's
    focal) as a disparity grid."""
    import vipe_tpu.slam.system as jsystem
    from vipe_tpu.models.convert import convert_unidepth
    from vipe_tpu.priors.depth.base import DepthEstimationInput
    from vipe_tpu.priors.depth.unidepth import UniDepthConfig, UniDepthModel, UniDepthNet

    poses_w2c, disps, intr_full, stream, cfg = _options_scene()
    ref_j = [None]
    oracle_j = make_oracle(ref_j, poses_w2c, disps, intr_full)
    params = convert_unidepth(_unidepth_weights())
    prior = UniDepthModel("s", params=params, **UNIDEPTH_BOUNDS)
    prior.net = UniDepthNet("vits", params, cfg=UniDepthConfig(**UNIDEPTH_NARROW))
    calls, sens = [], prior.estimate_sens_device

    def spy(image, intrinsics=None):
        calls.append((np.asarray(image), np.asarray(intrinsics)))
        return sens(image, intrinsics)

    prior.estimate_sens_device = spy

    def ef_j(params, images):
        return jnp.zeros((images.shape[0], HT, WD, 128), jnp.float32)

    out = _run_with_spy(jsystem, ref_j, lambda: jsystem.SLAMSystem(
        config=dict(cfg, keyframe_spec_depth=1, proximity_spec=False), update_fn=oracle_j,
        params=None, encode_features=ef_j, encode_context=lambda p, im: (ef_j(p, im),) * 2,
        metric_depth=prior,
    ).run(stream))
    f32 = [_disparity_grid(prior.estimate(DepthEstimationInput(
        rgb=img.astype(np.float32) / 255.0, focal_length=float(row[0]))).depth)
        for img, row in calls]
    return out, calls, np.stack(f32)


# the options and UniDepth runs reuse the oracle run's compiles: the same
# keyframe set
_JAX_JOBS = BackgroundJax({"oracle": (_jax_oracle_job, ()), "options": (_jax_options_job, ()),
                           "unidepth": (_jax_unidepth_job, ())})
# the references of the BA steps and of the graph rounds, in a second process
_JAX_REFS = BackgroundJax({"ba": (_jax_ba_job, ()), "rounds": (_jax_rounds_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_JOBS.start()
    _JAX_REFS.start()
    yield
    _JAX_REFS.stop()
    _JAX_JOBS.stop()


CORR_CFGS = {"volume": {}, "alt": {"corr_mode": "alt"}, "int8": {"corr_dtype": "int8"}}


def _torch_encoders():
    def ef_t(images):
        return torch.zeros((images.shape[0], HT, WD, 128), dtype=torch.bfloat16)

    return dict(encode_features=ef_t, encode_context=lambda im: (ef_t(im), ef_t(im)))


@functools.lru_cache(maxsize=None)
def _port_oracle_run(corr):
    """The port on the oracle stream with the ``CORR_CFGS[corr]`` options;
    its inner-filler graphs are kept for inspection."""
    from vipe_tpu_torch.slam import inner_filler as tfiller

    poses_w2c, disps, intr_full, stream = _oracle_scene()
    ref_t = [None]
    oracle_t = make_torch_oracle(ref_t, poses_w2c, disps, intr_full)
    filler_graphs = []

    class SpyGraph(tfiller.FactorGraph):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            filler_graphs.append(self)

    orig_graph, tfiller.FactorGraph = tfiller.FactorGraph, SpyGraph
    try:
        out_t = _run_with_spy(tsystem, ref_t, lambda: tsystem.SLAMSystem(
            config=dict(SYSTEM_CFG, **CORR_CFGS[corr]), device="cpu", update_fn=oracle_t,
            **_torch_encoders()).run(stream))
    finally:
        tfiller.FactorGraph = orig_graph
    return out_t, filler_graphs


@functools.lru_cache(maxsize=None)
def _port_options_run(prior):
    """The port on the options scene with the ``constant-2.0`` prior
    (``oracle_runs_options``) or the UniDepth one (``oracle_runs_unidepth``);
    returns its output, its buffer, the arguments of every call of the prior
    and the prior."""
    from vipe_tpu_torch.priors.depth.base import ConstantDepthModel
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthConfig, UniDepthModel

    poses_w2c, disps, intr_full, stream, cfg = _options_scene()
    ref_t = [None]
    oracle_t = make_torch_oracle(ref_t, poses_w2c, disps, intr_full)
    if prior == "constant":
        model, method = ConstantDepthModel(2.0), "estimate_depth"
    else:
        model, method = UniDepthModel("s", state_dict={k: torch.from_numpy(v) for k, v in
                                                       _unidepth_weights().items()},
                                      device="cpu", cfg=UniDepthConfig(**UNIDEPTH_NARROW),
                                      **UNIDEPTH_BOUNDS), "estimate_sens_device"
    calls, orig = [], getattr(model, method)

    def spy(*a, **k):
        calls.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a))
        return orig(*a, **k)

    setattr(model, method, spy)
    try:
        out_t = _run_with_spy(tsystem, ref_t, lambda: tsystem.SLAMSystem(
            config=cfg, device="cpu", update_fn=oracle_t, metric_depth=model,
            **_torch_encoders()).run(stream))
    finally:
        delattr(model, method)
    return out_t, ref_t[0], calls, model


def _oracle_runs(corr):
    """Both systems on the oracle stream, the port's with the
    ``CORR_CFGS[corr]`` options.  The port's runs of these scenes and of
    the options scene go first, while the JAX runs finish in the
    background."""
    for key in CORR_CFGS:
        _port_oracle_run(key)
    _port_options_run("constant")
    out_t, filler_graphs = _port_oracle_run(corr)
    seed, config_j, out_j = _JAX_JOBS.result("oracle")
    # the JAX output is the same scene's under the same config, but for the
    # correlation options, which the oracle does not read
    assert seed == ORACLE_SEED and set(CORR_CFGS[corr]) <= set(CORR_KEYS)
    assert {k: v for k, v in config_j.items() if k not in CORR_KEYS} == dict(
        SYSTEM_CFG, keyframe_spec_depth=1, proximity_spec=False)
    return out_j, out_t, np.asarray(jlie.se3_inv(_oracle_scene()[0])), filler_graphs


@pytest.fixture(scope="module")
def oracle_runs():
    return _oracle_runs("volume")[:3]


@pytest.fixture(scope="module", params=["alt", "int8"])
def oracle_runs_corr(request):
    return (request.param,) + _oracle_runs(request.param)


class TestSystemOracleParity:
    def test_keyframes_equal(self, oracle_runs):
        out_j, out_t, _ = oracle_runs
        np.testing.assert_array_equal(out_t.keyframes, out_j.slam_map.frame_inds)
        np.testing.assert_array_equal(out_t.slam_map.frame_inds, out_j.slam_map.frame_inds)

    def test_trajectory_close(self, oracle_runs):
        out_j, out_t, gt = oracle_runs
        assert out_t.trajectory.shape == (T, 7)
        np.testing.assert_allclose(out_t.trajectory, out_j.trajectory, rtol=0, atol=1e-4)
        assert np.abs(out_t.trajectory[:, :3] - gt[:, :3]).max() < 2e-2

    def test_intrinsics_close(self, oracle_runs):
        out_j, out_t, _ = oracle_runs
        np.testing.assert_allclose(out_t.intrinsics, out_j.intrinsics, rtol=1e-5)

    def test_map_close(self, oracle_runs):
        out_j, out_t, _ = oracle_runs
        np.testing.assert_array_equal(out_t.slam_map.mask, out_j.slam_map.mask)
        np.testing.assert_allclose(out_t.slam_map.xyz, out_j.slam_map.xyz, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(out_t.slam_map.frame_inds, out_j.slam_map.frame_inds)

    def test_residual_small(self, oracle_runs):
        out_j, out_t, _ = oracle_runs
        assert 0.0 <= out_t.ba_residual < 1e-6 and out_j.ba_residual < 1e-6


class TestSystemOracleParityCorrOptions:
    """``TestSystemOracleParity`` at its limits, with ``corr_mode=alt`` and
    with ``corr_dtype=int8`` on both sides."""

    def test_keyframes_equal(self, oracle_runs_corr):
        _, out_j, out_t, _, _ = oracle_runs_corr
        np.testing.assert_array_equal(out_t.keyframes, out_j.slam_map.frame_inds)

    def test_trajectory_close(self, oracle_runs_corr):
        _, out_j, out_t, gt, _ = oracle_runs_corr
        assert out_t.trajectory.shape == (T, 7)
        np.testing.assert_allclose(out_t.trajectory, out_j.trajectory, rtol=0, atol=1e-4)
        assert np.abs(out_t.trajectory[:, :3] - gt[:, :3]).max() < 2e-2

    def test_intrinsics_and_map_close(self, oracle_runs_corr):
        _, out_j, out_t, _, _ = oracle_runs_corr
        np.testing.assert_allclose(out_t.intrinsics, out_j.intrinsics, rtol=1e-5)
        np.testing.assert_array_equal(out_t.slam_map.mask, out_j.slam_map.mask)
        np.testing.assert_allclose(out_t.slam_map.xyz, out_j.slam_map.xyz, rtol=0, atol=1e-4)
        assert 0.0 <= out_t.ba_residual < 1e-6 and out_j.ba_residual < 1e-6

    def test_filler_graph_corr_state(self, oracle_runs_corr):
        """The JAX filler with a real update network (``_compute_fused``)
        builds packed features in alt mode and bf16 volumes whatever
        ``corr_dtype`` says; the port's filler does the same."""
        mode, _, _, _, graphs = oracle_runs_corr
        assert graphs
        for g in graphs:
            if mode == "alt":
                assert len(g.corr_pyr) == 5 and all(p.dim() == 4 for p in g.corr_pyr)
            else:
                assert g.corr_scale is None and len(g.corr_pyr) == 4
                assert all(p.dim() == 5 and p.dtype == torch.bfloat16 for p in g.corr_pyr)


class MaskedNoDepthStream(SyntheticStream):
    """The oracle stream with a validity mask per frame (an invalid band
    along the top and a moving invalid block) and no metric depth, so the
    keyframe depth prior supplies the disparity prior."""

    def attributes(self):
        return super().attributes() | {JFrameAttribute.MASK}

    def __iter__(self):
        for k, f in enumerate(super().__iter__()):
            mask = np.ones((H, W), bool)
            mask[:9] = False
            mask[20:31, 4 * k: 4 * k + 13] = False
            yield type(f)(raw_frame_idx=f.raw_frame_idx, rgb=f.rgb, mask=mask,
                          intrinsics=f.intrinsics)


@pytest.fixture(scope="module")
def oracle_runs_options():
    """Masks, ``keyframe_depth: constant-2.0`` and ``keyframe_stride: 1``
    with a motion filter that passes no frame, so the stride alone makes
    every frame a keyframe (the keyframe set, and so every shape, of
    ``oracle_runs``: the JAX compiles are shared), in one oracle-scene run
    of each package; the port's buffer is kept."""
    out_t, buf, _, _ = _port_options_run("constant")
    out_j = _JAX_JOBS.result("options")
    return out_j, out_t, np.asarray(jlie.se3_inv(_options_scene()[0])), buf


class TestSystemOracleParityOptions:
    """``TestSystemOracleParity`` at its limits, with masks, the constant
    keyframe depth prior and a keyframe stride on both sides."""

    def test_keyframes_are_the_stride(self, oracle_runs_options):
        out_j, out_t, _, _ = oracle_runs_options
        np.testing.assert_array_equal(out_t.keyframes, out_j.slam_map.frame_inds)
        np.testing.assert_array_equal(out_t.keyframes, np.arange(T))

    def test_trajectory_close(self, oracle_runs_options):
        out_j, out_t, gt, _ = oracle_runs_options
        assert out_t.trajectory.shape == (T, 7)
        np.testing.assert_allclose(out_t.trajectory, out_j.trajectory, rtol=0, atol=1e-4)
        assert np.abs(out_t.trajectory[:, :3] - gt[:, :3]).max() < 2e-2

    def test_map_and_intrinsics_close(self, oracle_runs_options):
        out_j, out_t, _, _ = oracle_runs_options
        np.testing.assert_allclose(out_t.intrinsics, out_j.intrinsics, rtol=1e-5)
        np.testing.assert_array_equal(out_t.slam_map.mask, out_j.slam_map.mask)
        np.testing.assert_allclose(out_t.slam_map.xyz, out_j.slam_map.xyz, rtol=0, atol=1e-4)

    def test_masks_and_prior_reach_the_buffer(self, oracle_runs_options):
        """The invalid band is masked on every keyframe, the depth prior
        gives disparity 1/2 everywhere, and masked points leave the map."""
        _, out_t, _, buf = oracle_runs_options
        n = len(out_t.keyframes)
        assert bool(buf.masks[:n, 0].all()) and not bool(buf.masks[:n, 3:].all())
        torch.testing.assert_close(buf.disps_sens[:n], torch.full_like(buf.disps_sens[:n], 0.5))
        assert not out_t.slam_map.mask[:, 0].any()


@pytest.fixture(scope="module")
def oracle_runs_unidepth():
    """The options scene with a UniDepth-S keyframe prior (the port's seeded
    weights on both sides, the JAX run in the background): the prior runs
    on every keyframe.  Beside each run's output: the inputs of every call
    of the prior, and each package's f32 path on them as a disparity grid
    (the port's ``estimate_sens_device`` in f32, the JAX package's
    ``estimate``)."""
    out_t, buf, calls, model = _port_options_run("unidepth")
    f32_t = np.stack([model.estimate_sens_device(img, row, dtype=torch.float32).numpy()
                      for img, row in calls])
    out_j, calls_j, f32_j = _JAX_JOBS.result("unidepth")
    return out_j, calls_j, f32_j, out_t, buf, calls, f32_t, model


def _rel(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return np.abs(ref - got).max() / np.abs(ref).max()


# the port's bf16 prior against its f32 path, relative to the largest prior
# (tests/test_torch_unidepth.py's bound; measured here 9.5e-3)
UNIDEPTH_BF16_RTOL = 5e-2


class TestSystemOracleParityUniDepth:
    """``TestSystemOracleParityOptions`` with the UniDepth prior.  Both
    systems call the prior on the same images with the same intrinsics;
    the port's f32 path on those inputs equals the JAX package's f32 path
    within 1e-4 of the largest prior, and the port's bf16 prior, the one
    SLAM runs, lies within ``UNIDEPTH_BF16_RTOL`` of the port's f32 path.
    (The JAX package's own bf16 prior takes its ray angles in bf16, and its
    error grows with the focal: ``ROADMAP.md``; it is not the reference.)
    The oracle's flow fixes the poses, and the prior's small weight in the
    BA (``dense_disp_alpha``) lets the bf16 differences move them by less
    than 2e-2."""

    def test_keyframes_equal(self, oracle_runs_unidepth):
        out_j, out_t = oracle_runs_unidepth[0], oracle_runs_unidepth[3]
        np.testing.assert_array_equal(out_t.keyframes, out_j.slam_map.frame_inds)
        np.testing.assert_array_equal(out_t.keyframes, np.arange(T))

    def test_trajectory_and_intrinsics_close(self, oracle_runs_unidepth):
        out_j, out_t = oracle_runs_unidepth[0], oracle_runs_unidepth[3]
        np.testing.assert_allclose(out_t.trajectory, out_j.trajectory, rtol=0, atol=2e-2)
        np.testing.assert_allclose(out_t.intrinsics, out_j.intrinsics, rtol=2e-2)

    def test_priors_close_and_rerun(self, oracle_runs_unidepth):
        _, calls_j, f32_j, _, buf, calls, f32_t, model = oracle_runs_unidepth
        # once per keyframe, in order: the oracle keeps the true focal, so
        # the backend finds the intrinsics unchanged and runs the prior no
        # second time (the rerun is held in tests/test_torch_unidepth.py)
        assert len(calls) == len(calls_j) == T
        for k, ((img, row), (img_j, row_j)) in enumerate(zip(calls, calls_j)):
            assert torch.equal(img, buf.images[k])
            np.testing.assert_array_equal(img.numpy(), img_j)
            np.testing.assert_array_equal(row.numpy(), row_j)
        assert _rel(f32_j, f32_t) < 1e-4
        sens_t = buf.disps_sens[:T].numpy()
        assert np.isfinite(sens_t).all() and (sens_t > 0).all()
        assert sens_t.std() > 0.05 * sens_t.mean()  # a learned prior, not a constant
        assert _rel(f32_t, sens_t) < UNIDEPTH_BF16_RTOL
        # the bounds have teeth: the predicted camera in place of the given
        # rays moves the prior far outside either
        img, _ = calls[0]
        wrong = model.estimate_sens_device(img, None, dtype=torch.float32).numpy()
        assert _rel(f32_j[0], wrong) > 4 * UNIDEPTH_BF16_RTOL


# ------------------------------- one GRU round (JAX in the second process)


def test_factor_graph_update_round_matches_jax():
    _check_update_round()


@pytest.mark.parametrize("corr_mode,corr_dtype", [("alt", "bf16"), ("volume", "int8")])
def test_factor_graph_update_round_corr_options_match_jax(corr_mode, corr_dtype):
    """Mirrors ``test_corr_mode_alt_one_round`` / ``test_corr_dtype_int8_one_round``
    of ``tests/test_fused_update.py``, port against JAX in the same mode."""
    _check_update_round(corr_mode, corr_dtype)


@pytest.mark.parametrize("corr_mode,corr_dtype", [("alt", "bf16"), ("volume", "int8")])
def test_corr_rows_follow_removals(corr_mode, corr_dtype):
    """Mirrors ``test_corr_dtype_int8_row_machinery``: after evicting two
    edges into the inactive store and removing a keyframe, the stored rows
    equal a fresh build for the surviving edges."""
    from vipe_tpu_torch.ops import corr as tcorr
    from vipe_tpu_torch.slam.buffer import GraphBuffer
    from vipe_tpu_torch.slam.factor_graph import FactorGraph

    rng = np.random.default_rng(7)
    buf = GraphBuffer(height=H, width=W, buffer_size=32)
    for k in range(6):
        feats = [torch.from_numpy(rng.standard_normal((HT, WD, 128)).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(3)]
        buf.append_keyframe(k, torch.zeros((H, W, 3), dtype=torch.uint8), *feats,
                            intrinsics=np.asarray([W, W, W / 2, H / 2], np.float32))
    g = FactorGraph(buf, None, max_factors=16, incremental=True,
                    corr_mode=corr_mode, corr_dtype=corr_dtype)
    g.add_neighborhood_factors(0, 6, r=1)
    mask = np.zeros(g.n_edges, bool)
    mask[[1, 3]] = True
    g.rm_factors(mask, store=True)
    g.rm_keyframe(2)
    n = g.n_edges
    assert n > 0
    f1 = buf.fmaps[torch.from_numpy(g.ii)].float()
    f2 = buf.fmaps[torch.from_numpy(g.jj)].float()
    if corr_mode == "alt":
        fresh = tcorr.corr_feat_pack(f1, f2)
        assert len(g.corr_pyr) == 5
        for stored, ref in zip(g.corr_pyr, fresh):
            torch.testing.assert_close(stored, ref, rtol=0, atol=0)
    else:
        fresh = tcorr.corr_pyramid(f1, f2)
        for q, s, ref in zip(g.corr_pyr, g.corr_scale, fresh):
            assert q.dtype == torch.int8 and tuple(s.shape) == (n,)
            deq = q.float() * s[:, None, None, None, None]
            ref = ref.float()
            assert float((deq - ref).abs().max() / (ref.abs().max() + 1e-9)) < 1.5e-2


@pytest.mark.parametrize("corr_mode,corr_dtype", [("volume", "bf16"), ("alt", "bf16"),
                                                  ("volume", "int8")])
def test_late_removal_matches_jax(corr_mode, corr_dtype):
    """A late removal, ``rm_keyframe(ix, top)`` with ``top`` the slot above
    ``n_frames`` (the speculative frontend's), after aging and an eviction
    into the inactive store: the same topology, ages, inactive store,
    buffer rows (the slot at ``top`` shifted down too) and correlation rows
    as the JAX graph after the same calls, at the bounds of
    ``_check_corr_state``."""
    n = 6
    rounds = _JAX_REFS.result("rounds")
    (jbuf0, _), (jbuf, jg) = rounds["late", (corr_mode, corr_dtype)]
    tbuf, tg = _torch_graph_like(rounds["params"], jbuf0, n=n, corr_mode=corr_mode,
                                 corr_dtype=corr_dtype)
    _late_removal_calls(tbuf, tg, n)
    m = jg.n_edges
    assert m == tg.n_edges and m < 10 and jbuf.n_frames == tbuf.n_frames == n - 1
    np.testing.assert_array_equal(tg.ii, jg.ii[:m])
    np.testing.assert_array_equal(tg.jj, jg.jj[:m])
    np.testing.assert_array_equal(tg.age, jg.age[:m])
    np.testing.assert_array_equal(tg.ii_inac, jg.ii_inac)
    np.testing.assert_array_equal(tg.jj_inac, jg.jj_inac)
    k = len(jg.ii_inac)
    for name in ("target_inac", "weight_inac"):
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)[:k]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tbuf.tstamp[: n - 1], jbuf.tstamp[: n - 1])
    np.testing.assert_allclose(tbuf.poses[:n].numpy(), np.asarray(jbuf.poses[:n]), atol=1e-6)
    np.testing.assert_allclose(tbuf.disps[:n].numpy(), np.asarray(jbuf.disps[:n]), atol=1e-6)
    assert float(tbuf.poses[n - 1, 0]) == pytest.approx(0.7)  # the slot above moved down
    _check_corr_state(jg, tg)
