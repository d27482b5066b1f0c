"""The port's SLAM layer against ``vipe_tpu.slam``.

* ``ba_iteration``: one Gauss-Newton step from the same state, f32 on both
  sides; the Jacobians come from forward-mode autodiff on both, the Schur
  sums run in another order, so poses/disps agree to 1e-5 and the shared
  focal (a sum over every pixel of every edge) to 1e-3 px.
* one ``FactorGraph.update`` round from the same buffer state with the same
  DroidNet weights in bf16: atol 2e-2, the bound that
  ``tests/test_fused_update.py`` argues for one bf16 GRU+BA round.
* the slice as a whole: ``SLAMSystem.run`` of both packages on the
  geometric-oracle stream of ``tests/test_slam_system.py`` (JAX in its
  reference-exact ordering, ``keyframe_spec_depth=1, proximity_spec=False``):
  equal keyframe sets; trajectories and intrinsics within 1e-4 (f32 BA
  rounding over ~300 Gauss-Newton iterations, measured ≤1e-6).
* a random-weight DroidNet run of the port: finite outputs of the right
  shape.  Random-weight trajectories diverge chaotically between frameworks
  (``tests/test_frontend_deferred.py``), so none is bounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_slam_system import (H, HT, T, W, WD, SyntheticStream, make_gt,
                                    make_oracle)
from vipe_tpu.ops import lie as jlie
from vipe_tpu.slam import ba as jba
from vipe_tpu_torch.ops import cameras as tcam
from vipe_tpu_torch.ops import geom as tgeom
from vipe_tpu_torch.slam import ba as tba
from vipe_tpu_torch.slam import system as tsystem

SYSTEM_CFG = dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=0.0, warmup=4,
                  buffer=64, infill_chunk_size=6, backend_iters=12)


# ------------------------------------------------------------------- BA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



@pytest.fixture(scope="module")
def ba_state():
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


def _ba_jax(s, optimize_intrinsics):
    cfg = jba.BAConfig(ht=s["ht"], wd=s["wd"], optimize_intrinsics=optimize_intrinsics,
                       max_edges_per_frame=8)
    slot = jba.build_edge_slots(s["ii"], None, s["N"], 8)
    rig = np.asarray(jlie.se3_identity((1,)))
    z = np.zeros(len(s["ii"]), np.int32)
    args = (s["poses"], rig, s["disps"], s["intr"][None], s["target"], s["weight"], s["ii"], z,
            s["ii"], s["jj"], z, s["edge_valid"], slot, s["pose_mask"], s["disp_mask"],
            s["damp"], s["sens"], s["sens_mask"])
    p, _, d, intr, _ = jba.ba_iteration(cfg, *map(jnp.asarray, args), 1e-3, 0.1)
    return np.asarray(p), np.asarray(d), np.asarray(intr[0])


def _ba_torch(s, optimize_intrinsics):
    cfg = tba.BAConfig(ht=s["ht"], wd=s["wd"], optimize_intrinsics=optimize_intrinsics,
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
    pj, dj, ij = _ba_jax(ba_state, optimize_intrinsics)
    pt, dt, it = _ba_torch(ba_state, optimize_intrinsics)
    assert np.abs(pj - ba_state["poses"]).max() > 1e-2  # the step moves the poses
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-3)
    assert np.abs(it - ba_state["intr"]).max() > 1e-3  # the focal moved


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


def _jax_graph(seed=3, n=6):
    """JAX buffer + graph as in tests/test_fused_update.py, with seeded
    random features in the slots (the encoders are held in
    test_torch_droidnet.py)."""
    import jax

    from vipe_tpu.models.droidnet import init_droidnet
    from vipe_tpu.slam.buffer import GraphBuffer
    from vipe_tpu.slam.factor_graph import FactorGraph
    from vipe_tpu.slam.system import make_droidnet_fns

    model, params = init_droidnet(jax.random.PRNGKey(0), ht=HT, wd=WD)
    _, _, uf = make_droidnet_fns(model)
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
    g = FactorGraph(buf, uf, params, max_factors=16, incremental=True)
    g.add_neighborhood_factors(0, n, r=1)
    return params, buf, g


def _torch_graph_like(params, jbuf, n=6):
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
    g = FactorGraph(buf, uf, max_factors=16, incremental=True)
    g.add_neighborhood_factors(0, n, r=1)
    return buf, g


def test_factor_graph_update_round_matches_jax():
    n = 6
    params, jbuf, jg = _jax_graph(n=n)
    tbuf, tg = _torch_graph_like(params, jbuf, n=n)
    np.testing.assert_array_equal(tg.ii, jg.ii[: jg.n_edges])
    np.testing.assert_array_equal(tg.jj, jg.jj[: jg.n_edges])
    for j, t in zip(jg.corr_pyr, tg.corr_pyr):  # same volumes from the same features
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j[: jg.n_edges], np.float32),
                                   rtol=2 ** -8, atol=1e-6)

    with torch.no_grad():
        tg.update(use_inactive=True)
    jg.update(use_inactive=True)
    pairs = {
        "poses": (tbuf.poses[:n], jbuf.poses[:n]),
        "disps": (tbuf.disps[:n], jbuf.disps[:n]),
        "target": (tg.target, jg.target[: jg.n_edges]),
        "weight": (tg.weight, jg.weight[: jg.n_edges]),
        "damping": (tg.damping[:8], jg.damping[:8]),
    }
    for key, (t, j) in pairs.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-2,
                                   err_msg=f"mismatch in {key}")
    np.testing.assert_array_equal(tg.age, jg.age[: jg.n_edges])
    assert float(torch.abs(tbuf.poses[1:n, :3] - torch.from_numpy(
        np.array(jbuf.poses[1:n, :3]))).max()) < 2e-2


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


@pytest.fixture(scope="module")
def oracle_runs():
    import vipe_tpu.slam.system as jsystem

    rng = np.random.default_rng(3)
    poses_w2c, disps, intr_full = make_gt(rng)
    stream = SyntheticStream(rng, disps, intr_full)

    ref_j = [None]
    oracle_j = make_oracle(ref_j, poses_w2c, disps, intr_full)

    def ef_j(params, images):
        return jnp.zeros((images.shape[0], HT, WD, 128), jnp.float32)

    def ec_j(params, images):
        z = ef_j(params, images)
        return z, z

    out_j = _run_with_spy(jsystem, ref_j, lambda: jsystem.SLAMSystem(
        config=dict(SYSTEM_CFG, keyframe_spec_depth=1, proximity_spec=False),
        update_fn=oracle_j, params=None, encode_features=ef_j, encode_context=ec_j,
    ).run(stream))

    ref_t = [None]
    oracle_t = make_torch_oracle(ref_t, poses_w2c, disps, intr_full)

    def ef_t(images):
        return torch.zeros((images.shape[0], HT, WD, 128), dtype=torch.bfloat16)

    out_t = _run_with_spy(tsystem, ref_t, lambda: tsystem.SLAMSystem(
        config=SYSTEM_CFG, device="cpu", update_fn=oracle_t, encode_features=ef_t,
        encode_context=lambda im: (ef_t(im), ef_t(im)),
    ).run(stream))
    return out_j, out_t, np.asarray(jlie.se3_inv(poses_w2c))


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


# ------------------------------------------------- random-weight DroidNet


def test_random_weight_droidnet_run_is_finite():
    rng = np.random.default_rng(7)
    _, disps, intr_full = make_gt(rng)
    stream = SyntheticStream(rng, disps, intr_full, with_depth=False)
    out = tsystem.SLAMSystem(
        config=dict(resize_area=H * W, filter_thresh=0.0, warmup=4, buffer=32,
                    infill_chunk_size=6, backend_iters=1),
        device="cpu",
    ).run(stream)
    assert out.trajectory.shape == (T, 7) and np.isfinite(out.trajectory).all()
    assert out.intrinsics.shape == (4,) and np.isfinite(out.intrinsics).all()
    assert out.keyframes[0] == 0 and out.keyframes[-1] == T - 1
    assert np.isfinite(out.slam_map.xyz).all()


@pytest.mark.parametrize("key,value", [
    ("keyframe_spec_depth", 2), ("proximity_spec", True), ("corr_mode", "alt"),
    ("corr_dtype", "int8"), ("keyframe_depth", "constant-2.0"),
])
def test_unported_options_raise(key, value):
    with pytest.raises(NotImplementedError):
        tsystem.SLAMSystem(config={key: value}, device="cpu",
                           update_fn=lambda *a: None, encode_features=None, encode_context=None)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsystem.SLAMSystem(config={}, update_fn=lambda *a: None)
