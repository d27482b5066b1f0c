"""The PyTorch port's lie / cameras / geom ops against ``vipe_tpu.ops``.

Both sides get the same seeded numpy inputs and compute in f32 on the CPU;
they evaluate the same closed forms in a different operation order, so the
bound is f32 rounding (atol 1e-5 on unit-scale values, rtol 1e-5 on pixel
coordinates and flow magnitudes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipe_tpu.ops import cameras as jcam
from vipe_tpu.ops import geom as jgeom
from vipe_tpu.ops import lie as jlie
from vipe_tpu_torch.ops import cameras as tcam
from vipe_tpu_torch.ops import geom as tgeom
from vipe_tpu_torch.ops import lie as tlie

ATOL = 1e-5
N, HT, WD = 6, 6, 8
INTR = np.array([8.0, 8.5, 4.0, 3.0], np.float32)
INTR_MEI = np.array([8.0, 8.5, 4.0, 3.0, 0.6], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    xi = (0.05 * rng.standard_normal((N, 6))).astype(np.float32)
    xi[:, 0] += 0.1 * np.arange(N)
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = (0.4 + 0.3 * rng.random((N, HT, WD))).astype(np.float32)
    ii = np.array([0, 1, 2, 3, 4, 5, 0, 2])
    jj = np.array([1, 2, 3, 4, 5, 4, 2, 0])
    return poses, disps, ii, jj


@pytest.fixture(scope="module")
def tangents():
    rng = np.random.default_rng(1)
    xi = (0.5 * rng.standard_normal((7, 6))).astype(np.float32)
    xi[0] = 0.0       # identity
    xi[1, 3:] = 1e-7  # near-zero rotation: the small-angle branches
    pts = rng.standard_normal((7, 3)).astype(np.float32)
    return xi, pts


class TestLie:
    def test_identity(self):
        np.testing.assert_array_equal(_np(tlie.se3_identity((3,))), _np(jlie.se3_identity((3,))))

    @pytest.mark.parametrize("name", ["se3_exp", "so3_exp"])
    def test_exp(self, tangents, name):
        xi, _ = tangents
        arg = xi if name == "se3_exp" else xi[:, 3:]
        got = getattr(tlie, name)(_t(arg))
        ref = getattr(jlie, name)(jnp.asarray(arg))
        np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL)

    def test_log_inverts_exp(self, tangents):
        xi, _ = tangents
        X = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        np.testing.assert_allclose(_np(tlie.se3_log(_t(X))), _np(jlie.se3_log(jnp.asarray(X))),
                                   atol=ATOL)

    @pytest.mark.parametrize("name", ["se3_inv", "se3_matrix"])
    def test_unary(self, tangents, name):
        xi, _ = tangents
        X = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        np.testing.assert_allclose(_np(getattr(tlie, name)(_t(X))),
                                   _np(getattr(jlie, name)(jnp.asarray(X))), atol=ATOL)

    def test_mul(self, tangents):
        xi, _ = tangents
        X = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        Y = X[::-1].copy()
        np.testing.assert_allclose(_np(tlie.se3_mul(_t(X), _t(Y))),
                                   _np(jlie.se3_mul(jnp.asarray(X), jnp.asarray(Y))), atol=ATOL)

    def test_act_and_quat_rotate(self, tangents):
        xi, pts = tangents
        X = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        np.testing.assert_allclose(_np(tlie.se3_act(_t(X), _t(pts))),
                                   _np(jlie.se3_act(jnp.asarray(X), jnp.asarray(pts))), atol=ATOL)
        np.testing.assert_allclose(
            _np(tlie.quat_rotate(_t(X[:, 3:]), _t(pts))),
            _np(jlie.quat_rotate(jnp.asarray(X[:, 3:]), jnp.asarray(pts))), atol=ATOL)

    def test_retr(self, tangents):
        xi, _ = tangents
        X = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        d = 0.1 * xi[::-1].copy()
        np.testing.assert_allclose(_np(tlie.se3_retr(_t(X), _t(d))),
                                   _np(jlie.se3_retr(jnp.asarray(X), jnp.asarray(d))), atol=ATOL)


class TestCameras:
    def test_iproj_proj_roundtrip_matches(self, scene):
        _, disps, _, _ = scene
        u, v = (np.asarray(a) for a in jgeom.pixel_grid(HT, WD))
        pj = jcam.iproj_disp(jcam.CameraType.PINHOLE, jnp.asarray(INTR), jnp.asarray(u),
                             jnp.asarray(v), jnp.asarray(disps[0]))
        pt = tcam.iproj_disp(tcam.CameraType.PINHOLE, _t(INTR), _t(u), _t(v), _t(disps[0]))
        np.testing.assert_allclose(_np(pt), _np(pj), atol=ATOL)
        cj = jcam.proj_points(jcam.CameraType.PINHOLE, jnp.asarray(INTR), pj)
        ct = tcam.proj_points(tcam.CameraType.PINHOLE, _t(INTR), pt)
        np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-5, atol=ATOL)

    def test_scaled_intrinsics(self):
        np.testing.assert_allclose(
            _np(tcam.scaled_intrinsics(tcam.CameraType.PINHOLE, _t(INTR), 0.125)),
            _np(jcam.scaled_intrinsics(jcam.CameraType.PINHOLE, jnp.asarray(INTR), 0.125)))

    @pytest.mark.parametrize("name", ["mei", "panorama"])
    def test_other_models_raise(self, name):
        """MEI and panorama are ported (``TestOmniCameras``); the model that
        neither package implements still raises."""
        z = _t(np.zeros(2, np.float32))
        intr = _t(INTR_MEI if name == "mei" else INTR)
        assert tcam.iproj_disp(tcam.CameraType(name), intr, z, z, z + 1).shape == (2, 4)
        for fn, args in ((tcam.iproj_disp, (z, z, z + 1)),
                         (tcam.proj_points, (_t(np.ones((2, 4), np.float32)),)),
                         (tcam.pinhole_equivalent, ())):
            with pytest.raises(ValueError):
                fn(tcam.CameraType.SIMPLE_DIVISIONAL, _t(INTR), *args)


def _omni_case(name):
    """Camera type, full grid-scale intrinsics and a point set for a model:
    MEI with k1 = 0.6; the panorama at the SLAM grid, with the two poles,
    points on the x = z = 0 axis and on the ±π seam added."""
    ct = tcam.CameraType(name)
    intr = INTR_MEI if name == "mei" else np.asarray(jcam.panorama_intrinsics(HT, WD))
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.standard_normal((40, 3)), rng.uniform(0.2, 1.0, (40, 1))], -1)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.2
    if name == "panorama":
        pts[:, 2] = rng.standard_normal(40)
        pts[:4, :3] = [[0, 1, 0], [0, -1, 0], [0, 2.5, 0], [-1e-3, 0.3, -1.0]]
    return ct, intr.astype(np.float32), pts.astype(np.float32)


class TestOmniCameras:
    """MEI and panorama ``iproj_disp``/``proj_points``/``pinhole_equivalent``
    against ``vipe_tpu.ops.cameras`` to 1e-5 (f32), poles included."""

    @pytest.mark.parametrize("name", ["mei", "panorama"])
    def test_iproj(self, scene, name):
        ct, intr, _ = _omni_case(name)
        _, disps, _, _ = scene
        u, v = (np.asarray(a) for a in jgeom.pixel_grid(HT, WD))
        pj = jcam.iproj_disp(jcam.CameraType(name), jnp.asarray(intr), jnp.asarray(u),
                             jnp.asarray(v), jnp.asarray(disps[0]))
        pt = tcam.iproj_disp(ct, _t(intr), _t(u), _t(v), _t(disps[0]))
        np.testing.assert_allclose(_np(pt), _np(pj), rtol=0, atol=ATOL)

    @pytest.mark.parametrize("name", ["mei", "panorama"])
    def test_proj(self, name):
        ct, intr, pts = _omni_case(name)
        for lim in (True, False):
            cj = jcam.proj_points(jcam.CameraType(name), jnp.asarray(intr), jnp.asarray(pts), lim)
            ct_ = tcam.proj_points(ct, _t(intr), _t(pts), lim)
            np.testing.assert_allclose(_np(ct_), _np(cj), rtol=1e-5, atol=ATOL)

    @pytest.mark.parametrize("name", ["mei", "panorama"])
    def test_proj_derivative_finite_at_poles(self, name):
        """The pole guards: forward derivatives stay finite on every point,
        and equal JAX's."""
        ct, intr, pts = _omni_case(name)
        tan = np.ones_like(pts)
        _, dj = jax.jit(lambda p, t: jax.jvp(
            lambda q: jcam.proj_points(jcam.CameraType(name), jnp.asarray(intr), q), (p,), (t,))
        )(jnp.asarray(pts), jnp.asarray(tan))
        _, dt = torch.func.jvp(lambda p: tcam.proj_points(ct, _t(intr), p), (_t(pts),), (_t(tan),))
        assert np.isfinite(_np(dt)).all()
        np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("name", ["pinhole", "mei", "panorama"])
    def test_pinhole_equivalent_and_matrix(self, name):
        intr = {"pinhole": INTR, "mei": INTR_MEI}.get(name, np.zeros(4, np.float32))
        np.testing.assert_allclose(
            _np(tcam.pinhole_equivalent(tcam.CameraType(name), _t(intr))),
            _np(jcam.pinhole_equivalent(jcam.CameraType(name), jnp.asarray(intr))), rtol=1e-6)
        np.testing.assert_allclose(_np(tcam.intrinsics_matrix(_t(intr))),
                                   _np(jcam.intrinsics_matrix(jnp.asarray(intr))))

    def test_panorama_intrinsics(self):
        np.testing.assert_allclose(_np(tcam.panorama_intrinsics(384, 768)),
                                   _np(jcam.panorama_intrinsics(384, 768)), rtol=1e-6)


class TestGeom:
    def test_pixel_grid(self):
        for a, b in zip(tgeom.pixel_grid(HT, WD), jgeom.pixel_grid(HT, WD)):
            np.testing.assert_array_equal(_np(a), _np(b))

    def test_iproj_i_proj_j_disp(self, scene):
        poses, disps, ii, jj = scene
        Gij = np.asarray(jlie.se3_mul(jnp.asarray(poses[jj]), jlie.se3_inv(jnp.asarray(poses[ii]))))
        intr = np.broadcast_to(INTR, (len(ii), 4)).copy()
        cj, vj = jgeom.iproj_i_proj_j_disp(jnp.asarray(Gij), jnp.asarray(disps[ii]), jnp.asarray(intr),
                                           jnp.asarray(intr), jcam.CameraType.PINHOLE)
        ct, vt = tgeom.iproj_i_proj_j_disp(_t(Gij), _t(disps[ii]), _t(intr), _t(intr),
                                           tcam.CameraType.PINHOLE)
        np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(_np(vt), _np(vj))

    @pytest.mark.parametrize("name", ["reproject", "induced_flow"])
    def test_reproject(self, scene, name):
        poses, disps, ii, jj = scene
        cj, vj = getattr(jgeom, name)(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(INTR),
                                      jcam.CameraType.PINHOLE, jnp.asarray(ii), jnp.asarray(jj))
        ct, vt = getattr(tgeom, name)(_t(poses), _t(disps), _t(INTR), tcam.CameraType.PINHOLE,
                                      _t(ii), _t(jj))
        np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(_np(vt), _np(vj))

    @pytest.mark.parametrize("name", ["mei", "panorama"])
    def test_reproject_omni(self, scene, name):
        """Reprojection under MEI and the panorama (whose validity is a
        minimum range) against ``vipe_tpu.ops.geom``."""
        ct, intr, _ = _omni_case(name)
        poses, disps, ii, jj = scene
        cj, vj = jgeom.reproject(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
                                 jcam.CameraType(name), jnp.asarray(ii), jnp.asarray(jj))
        ct_, vt = tgeom.reproject(_t(poses), _t(disps), _t(intr), ct, _t(ii), _t(jj))
        np.testing.assert_allclose(_np(ct_), _np(cj), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(_np(vt), _np(vj))

    @pytest.mark.parametrize("name", ["mei", "panorama"])
    def test_frame_distance_omni(self, scene, name):
        """Frame distances take the camera's pinhole equivalent, as the
        JAX buffer does."""
        ct, intr, _ = _omni_case(name)
        poses, disps, ii, jj = scene
        pin_j = jcam.pinhole_equivalent(jcam.CameraType(name), jnp.asarray(intr))
        pin_t = tcam.pinhole_equivalent(ct, _t(intr))
        dj = jax.jit(jgeom.frame_distance)(jnp.asarray(poses), jnp.asarray(disps), pin_j,
                                           jnp.asarray(ii), jnp.asarray(jj))
        dt = tgeom.frame_distance(_t(poses), _t(disps), pin_t, _t(ii), _t(jj))
        np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-5, atol=ATOL)

    @pytest.mark.parametrize("beta", [0.3, 0.25])
    def test_frame_distance(self, scene, beta):
        poses, disps, ii, jj = scene
        fd = jax.jit(functools.partial(jgeom.frame_distance, beta=beta))
        dj = fd(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(INTR), jnp.asarray(ii),
                jnp.asarray(jj), di=jnp.asarray(jj))
        dt = tgeom.frame_distance(_t(poses), _t(disps), _t(INTR), _t(ii), _t(jj), di=_t(jj),
                                  beta=beta)
        np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-5, atol=ATOL)

    def test_frame_distance_saturates(self, scene):
        """Frames behind the camera: fewer than 75% valid pixels → 1000."""
        poses, disps, _, _ = scene
        far = poses.copy()
        far[1, 2] = -50.0
        ii, jj = np.array([0]), np.array([1])
        dj = jax.jit(jgeom.frame_distance)(jnp.asarray(far), jnp.asarray(disps),
                                           jnp.asarray(INTR), jnp.asarray(ii), jnp.asarray(jj))
        dt = tgeom.frame_distance(_t(far), _t(disps), _t(INTR), _t(ii), _t(jj))
        np.testing.assert_array_equal(_np(dt), _np(dj))
        assert float(dt[0]) == 1000.0

    def test_bilinear_sample(self, scene):
        _, disps, _, _ = scene
        rng = np.random.default_rng(2)
        coords = np.stack([rng.uniform(-2, WD + 1, (5, 7)), rng.uniform(-2, HT + 1, (5, 7))],
                          -1).astype(np.float32)
        img = np.stack([disps[0], disps[1]], -1)
        for im in (disps[0], img):
            np.testing.assert_allclose(_np(tgeom.bilinear_sample(_t(im), _t(coords))),
                                       _np(jgeom.bilinear_sample(jnp.asarray(im), jnp.asarray(coords))),
                                       atol=ATOL)

    def test_depth_filter(self, scene):
        poses, disps, _, _ = scene
        inds = np.arange(N)
        for th in (0.02, 0.3):
            thresh = np.full(N, th, np.float32)
            cj = jax.jit(jgeom.depth_filter)(jnp.asarray(poses), jnp.asarray(disps),
                                             jnp.asarray(INTR), jnp.asarray(inds),
                                             jnp.asarray(thresh))
            ct = tgeom.depth_filter(_t(poses), _t(disps), _t(INTR), _t(inds), _t(thresh))
            np.testing.assert_array_equal(_np(ct), _np(cj))

    def test_min_depth_constants(self):
        assert tgeom.MIN_DEPTH == jgeom.MIN_DEPTH
        assert tcam.MIN_DEPTH == jcam.MIN_DEPTH
