"""The port's multiview rigs against ``vipe_tpu``, on the CPU.

* ``reproject_mv`` and ``frame_distance_mv`` on random 2- and 3-view rigs,
  pinhole: f32 on both sides, within 1e-5.
* ``ba_solve_mv`` on the 2-view problem of ``tests/test_ba.py``
  (temporal and cross-view edges, a perturbed rig), with ``optimize_rig``
  off (disparities and the shared focal free) and on: 12 Gauss-Newton
  iterations, poses, rig and disparities within 1e-4, the focal within
  1e-3 px (a sum over every pixel of every edge, as in the single-view
  test).
* the buffer's integer machinery, exactly equal at V = 2: edge expansion
  with and without cross-view edges, the adaptive cross-view targets and
  ``remove_slot``'s shift of them.
* one GRU+BA round of a 2-view graph with cross-view edges, in volume/bf16,
  volume/int8 and alt, with the same DroidNet weights in bf16: atol 2e-2,
  the single-view round's bound (``tests/test_torch_slam.py``).
* the slice as a whole: ``SLAMSystem.run`` of both packages on the rig
  scene of ``tests/test_multiview.py`` (48×64, 2 views, a 0.12 m / 0.1 rad
  rig, GT-flow oracle), cut to 6 frames (warm-up 4, then tracking, the
  backend and the filler): equal keyframes; trajectory, rig, intrinsics
  and map within 1e-4; BA residual under 1e-6.  The JAX run is made once,
  in a spawned process (``BackgroundJax``) started by the module's first
  test, and shared; the JAX BA solves and graph rounds run in a second
  one, and their tests come after the port's own.  Then the port alone
  on the full 10 frames with
  ``optimize_rig_rotation``: unaligned ATE under 0.05 against ground truth
  and view 0's rig at identity within 1e-6.
* the pipeline's per-view artifacts beside ``vipe_tpu``'s for the same
  SLAM result; ``StreamList.make`` of a rig from two mp4s; the port's
  ``run.py`` entry on them on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slam import BackgroundJax, _jax_update_fn, _run_with_spy
from vipe_tpu.ops import cameras as jcam
from vipe_tpu.ops import geom as jgeom
from vipe_tpu.ops import lie as jlie
from vipe_tpu.slam import ba as jba
from vipe_tpu_torch.ops import cameras as tcam
from vipe_tpu_torch.ops import geom as tgeom
from vipe_tpu_torch.ops import lie as tlie
from vipe_tpu_torch.slam import ba as tba
from vipe_tpu_torch.slam import system as tsystem

H, W = 48, 64
HT, WD = H // 8, W // 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- geometry


@pytest.mark.parametrize("V", [2, 3])
def test_reproject_and_frame_distance_mv_match_jax(V):
    rng = np.random.default_rng(V)
    N, E = 4, 12
    xi = (0.05 * rng.standard_normal((N, 6))).astype(np.float32)
    xi[:, 0] += 0.1 * np.arange(N)
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    rig_xi = (0.1 * rng.standard_normal((V, 6))).astype(np.float32)
    rig_xi[0] = 0.0
    rig = np.asarray(jlie.se3_exp(jnp.asarray(rig_xi)))
    disps = (0.4 + 0.3 * rng.random((N * V, HT, WD))).astype(np.float32)
    intr = np.stack([[WD * (1.1 + 0.1 * v), WD * (1.1 + 0.1 * v), WD / 2, HT / 2]
                     for v in range(V)]).astype(np.float32)
    pi, pj = rng.integers(0, N, E), rng.integers(0, N, E)
    qi, qj = rng.integers(0, V, E), rng.integers(0, V, E)
    di = pi * V + qi
    idx = [pi, qi, di, pj, qj]
    cj, vj = jgeom.reproject_mv(*map(jnp.asarray, (poses, rig, disps, intr)),
                                jcam.CameraType.PINHOLE, *map(jnp.asarray, idx))
    ct, vt = tgeom.reproject_mv(*map(_t, (poses, rig, disps, intr)),
                                tcam.CameraType.PINHOLE, *map(_t, idx))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    dj = jgeom.frame_distance_mv(*map(jnp.asarray, (poses, rig, disps, intr)),
                                 *map(jnp.asarray, idx), beta=0.3)
    dt = tgeom.frame_distance_mv(*map(_t, (poses, rig, disps, intr)), *map(_t, idx), beta=0.3)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- BA


@functools.lru_cache(maxsize=None)
def _rig_ba_problem():
    """The 2-view problem of ``tests/test_ba.py``'s rig test: temporal
    edges per view, cross-view edges per frame, GT targets, perturbed
    poses (0 and 1 fixed) and a perturbed rig rotation of view 1."""
    from tests.test_ba import HT as BHT, P, WD as BWD, _rig_forward

    rng = np.random.default_rng(0)
    V, n = 2, 4
    intr = jnp.broadcast_to(jnp.asarray([BWD * 12.0, BWD * 12.0, BWD * 4.0, BHT * 4.0]), (V, 4))
    rig_gt = jnp.stack([jlie.se3_identity(), jlie.se3_exp(
        jnp.asarray([0.25, 0.0, 0.0, 0.0, 0.12, 0.0], jnp.float32))])
    poses_gt = jnp.stack([jlie.se3_exp(jnp.asarray(np.concatenate([
        [0.15 * k, 0.02 * rng.normal(), 0.02 * rng.normal()], 0.01 * rng.normal(size=3)]),
        jnp.float32)) for k in range(n)])
    u, v = jgeom.pixel_grid(BHT, BWD)
    base = 0.6 + 0.15 * jnp.sin(u / 3.0) * jnp.cos(v / 2.0)
    disps_gt = jnp.stack([base + 0.02 * k + 0.01 * w for k in range(n)
                          for w in range(V)]).reshape(n * V, P)
    pi, qi, pj, qj = [], [], [], []
    for i in range(n - 1):
        for w in range(V):
            pi += [i, i + 1]
            pj += [i + 1, i]
            qi += [w, w]
            qj += [w, w]
    for i in range(n):
        pi += [i, i]
        pj += [i, i]
        qi += [0, 1]
        qj += [1, 0]
    pi, qi, pj, qj = map(np.asarray, (pi, qi, pj, qj))
    di = pi * V + qi
    target, valid = _rig_forward(poses_gt, rig_gt, disps_gt, intr, pi, qi, di, pj, qj)
    E = len(pi)
    weight = jnp.ones((E, P, 2)) * valid[..., None]
    noise = jnp.asarray(rng.normal(size=(n, 6)) * 0.015, jnp.float32).at[:2].set(0.0)
    poses0 = jlie.se3_retr(poses_gt, noise)
    rig0 = rig_gt.at[1].set(jlie.se3_retr(
        rig_gt[1], jnp.asarray([0, 0, 0, 0.0, -0.04, 0.02], jnp.float32)))
    slot_edge = np.full((n * V, 16), E, np.int64)
    fill = np.zeros(n * V, np.int64)
    for e, d in enumerate(di):
        slot_edge[d, fill[d]] = e
        fill[d] += 1
    return dict(V=V, n=n, ht=BHT, wd=BWD, P=P, intr=intr, rig0=rig0, poses0=poses0,
                disps_gt=disps_gt, target=target, weight=weight,
                idx=(pi, qi, di, pj, qj), slot_edge=slot_edge,
                pose_mask=np.asarray([False, False] + [True] * (n - 2)))


def _ba_mv_case(optimize_rig):
    """(BAConfig keywords, the solve's arguments as numpy) for one case."""
    p = _rig_ba_problem()
    V, n, P = p["V"], p["n"], p["P"]
    kw = dict(ht=p["ht"], wd=p["wd"], max_edges_per_frame=16, n_views=V,
              optimize_rig=optimize_rig, optimize_intrinsics=not optimize_rig)
    disp_mask = np.full(n * V, not optimize_rig)
    disps0 = p["disps_gt"] if optimize_rig else p["disps_gt"] + 0.01
    args = (p["poses0"], p["rig0"], disps0, p["intr"], p["target"], p["weight"], *p["idx"],
            np.ones(len(p["idx"][0]), bool), p["slot_edge"], p["pose_mask"], disp_mask,
            np.full((n * V, P), 1e-4, np.float32), p["disps_gt"],
            np.zeros(n * V, np.float32))
    return kw, [np.asarray(a) for a in args]


def _jax_ba_mv_job():
    """The JAX solves of both cases, with their arguments, as numpy."""
    out = {}
    for optimize_rig in (False, True):
        kw, args = _ba_mv_case(optimize_rig)
        res = jba.ba_solve_mv(jba.BAConfig(**kw), *map(jnp.asarray, args),
                              jnp.int32(12), jnp.float32(1e-5), jnp.float32(1e-4))
        out[optimize_rig] = kw, args, [np.asarray(r) for r in res]
    return out


# --------------------------------------------------------------- buffer


def _buffers(n=5, seed=0):
    """A JAX and a port 2-view buffer with the same poses, rig and
    disparities in their first ``n`` frames."""
    from vipe_tpu.slam.buffer import GraphBuffer as JBuffer
    from vipe_tpu_torch.slam.buffer import GraphBuffer as TBuffer

    rng = np.random.default_rng(seed)
    V = 2
    rig = np.asarray(jlie.se3_exp(jnp.asarray([[0, 0, 0, 0, 0, 0],
                                                [0.12, 0, 0, 0, 0.1, 0]], jnp.float32)))
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(n)
    xi[:, 1:] = 0.01 * rng.standard_normal((n, 5))
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = (0.4 + 0.2 * rng.random((n * V, HT, WD))).astype(np.float32)
    intr = np.asarray([[W * 1.2, W * 1.2, W / 2, H / 2], [W * 1.15, W * 1.15, W / 2, H / 2]],
                      np.float32)
    jb = JBuffer(height=H, width=W, buffer_size=8, n_views=V, rig=rig)
    tb = TBuffer(height=H, width=W, buffer_size=8, n_views=V, rig=rig)
    jb.n_frames = tb.n_frames = n
    jb.tstamp[:n] = tb.tstamp[:n] = 3 * np.arange(n)
    jb.poses = jb.poses.at[:n].set(poses)
    jb.disps = jb.disps.at[: n * V].set(disps)
    jb.intrinsics = jnp.asarray(intr)
    tb.poses[:n], tb.disps[: n * V], tb.intrinsics = _t(poses), _t(disps), _t(intr)
    return jb, tb


def test_expand_edge_multiview_matches_jax():
    jb, tb = _buffers()
    custom = np.array([[[3, 1], [2, 0]], [[4, 0], [0, 0]]])
    for b in (jb, tb):
        b.cross_view_idx[1:3] = custom
    ii = np.array([0, 1, 1, 2, 4, 3])
    jj = np.array([1, 0, 1, 2, 3, 3])
    for cross in (True, False):
        for a, b in zip(tb.expand_edge_multiview(ii, jj, cross=cross),
                        jb.expand_edge_multiview(ii, jj, cross=cross)):
            np.testing.assert_array_equal(a, b)
    # edge 2 (1 → 1) is a cross-view edge: its rows target cross_view_idx[1]
    _, _, _, pj, qj, _ = tb.expand_edge_multiview(ii, jj)
    np.testing.assert_array_equal(np.stack([pj[4:6], qj[4:6]], -1), custom[0])


def test_adaptive_cross_view_idx_matches_jax():
    jb, tb = _buffers(seed=1)
    jb.build_adaptive_cross_view_idx()
    tb.build_adaptive_cross_view_idx()
    np.testing.assert_array_equal(tb.cross_view_idx, jb.cross_view_idx)
    # a threshold nothing passes leaves the defaults
    jb2, tb2 = _buffers(seed=1)
    tb2.build_adaptive_cross_view_idx(valid_thresh=0.0)
    np.testing.assert_array_equal(tb2.cross_view_idx, jb2.cross_view_idx)
    assert not np.array_equal(tb.cross_view_idx, tb2.cross_view_idx)


def test_remove_slot_shifts_cross_view_idx_like_jax():
    jb, tb = _buffers(seed=2)
    custom = np.array([[[4, 1], [2, 0]], [[3, 1], [0, 0]], [[1, 1], [4, 0]], [[0, 1], [3, 0]]])
    for b in (jb, tb):
        b.cross_view_idx[1:5] = custom
    jb.remove_slot(3)  # the second-newest frame: a rig removes no other
    tb.remove_slot(3)
    np.testing.assert_array_equal(tb.cross_view_idx, jb.cross_view_idx)
    np.testing.assert_array_equal(tb.tstamp, jb.tstamp)
    assert tb.n_frames == jb.n_frames == 4
    np.testing.assert_array_equal(tb.poses[:4].numpy(), np.asarray(jb.poses[:4]))
    np.testing.assert_array_equal(tb.disps[:8].numpy(), np.asarray(jb.disps[:8]))


# ---------------------------------------------------------- one GRU round

V2 = 2
RIG2 = np.asarray([[0, 0, 0, 0, 0, 0, 1], [0.2, 0, 0, 0, 0, 0, 1]], np.float32)
INTR2 = np.asarray([[W, W, W / 2, H / 2], [W * 1.1, W * 1.1, W / 2, H / 2]], np.float32)


ROUND_MODES = (("volume", "bf16"), ("volume", "int8"), ("alt", "bf16"))


def _jax_graph_mv(corr_mode, corr_dtype, n=6, seed=3):
    """The JAX 2-view graph over seeded slots: neighbourhood edges (r = 1)
    and two cross-view edges."""
    from tests.test_torch_droidnet import jax_droidnet_params
    from vipe_tpu.slam.buffer import GraphBuffer as JBuffer
    from vipe_tpu.slam.factor_graph import FactorGraph as JGraph

    params = jax_droidnet_params(HT, WD)
    rng = np.random.default_rng(seed)
    jbuf = JBuffer(height=H, width=W, buffer_size=16, n_views=V2, rig=RIG2)
    for k in range(n):
        img = jnp.asarray((rng.random((V2, H, W, 3)) * 255).astype(np.uint8))
        fmap, net, inp = (jnp.asarray(rng.standard_normal((V2, HT, WD, 128)), jnp.bfloat16)
                          for _ in range(3))
        jbuf.append_keyframe(k, img, fmap, jnp.tanh(net), jax.nn.relu(inp), intrinsics=INTR2)
        jbuf.poses = jbuf.poses.at[k, 0].set(0.1 * k + 0.01 * rng.normal())
        jbuf.disps = jbuf.disps.at[V2 * k: V2 * (k + 1)].add(
            0.1 * jnp.asarray(rng.random((V2, HT, WD)), jnp.float32))
    jg = JGraph(jbuf, _jax_update_fn(), params, max_factors=16, incremental=True,
                corr_mode=corr_mode, corr_dtype=corr_dtype)
    jg.add_neighborhood_factors(0, n, r=1)
    jg.add_factors([1, 4], [1, 4])
    return params, jbuf, jg


def _jax_rounds_mv_job():
    """Per mode of ``ROUND_MODES``, host records (``tests/test_torch_slam.py``'s
    ``_graph_record``, with the expanded rows) of the JAX buffer and graph
    before and after one ``update`` round; and the DroidNet params."""
    from tests.test_torch_slam import _graph_record

    out = {}
    for mode in ROUND_MODES:
        params, jbuf, jg = _jax_graph_mv(*mode)
        before = _graph_record(jbuf, jg)
        before[1].exp = np.array(jg.exp)
        jg.update(use_inactive=True)
        out[mode] = before, _graph_record(jbuf, jg)
    out["params"] = jax.tree_util.tree_map(np.asarray, params)
    return out


def _torch_graph_mv(params, jbuf, corr_mode, corr_dtype, n=6):
    """The port's 2-view buffer and graph holding a JAX record's state and
    the same weights, with the same edges."""
    from vipe_tpu_torch.models.convert import droidnet_state_dict_from_flax
    from vipe_tpu_torch.models.droidnet import DroidNet
    from vipe_tpu_torch.slam.buffer import GraphBuffer as TBuffer
    from vipe_tpu_torch.slam.factor_graph import FactorGraph as TGraph

    model = DroidNet()
    model.load_state_dict(droidnet_state_dict_from_flax(params))
    _, _, uf = tsystem.droidnet_fns(model.to(torch.bfloat16).eval())
    tbuf = TBuffer(height=H, width=W, buffer_size=16, n_views=V2, rig=RIG2)

    def f32(x):
        return _t(jnp.asarray(x, jnp.float32))

    nv = n * V2
    tbuf.n_frames = jbuf.n_frames
    tbuf.tstamp[:] = jbuf.tstamp
    tbuf.poses[:n], tbuf.disps[:nv] = f32(jbuf.poses[:n]), f32(jbuf.disps[:nv])
    tbuf.intrinsics = f32(jbuf.intrinsics)
    for name in ("fmaps", "nets", "inps"):
        getattr(tbuf, name)[:nv] = f32(getattr(jbuf, name)[:nv]).to(torch.bfloat16)
    tg = TGraph(tbuf, uf, max_factors=16, incremental=True, corr_mode=corr_mode,
                corr_dtype=corr_dtype)
    tg.add_neighborhood_factors(0, n, r=1)
    tg.add_factors([1, 4], [1, 4])
    return tbuf, tg


# ------------------------------------------------------ pipeline and entry


def test_pipeline_per_view_artifacts_match_jax_layout(tmp_path, monkeypatch):
    """Both pipelines with a stubbed SLAM returning the same rig result
    (``tests/test_pipeline.py``'s): the same artifact tree, each view's
    poses its camera's (``c2w · rig[v]``), the same intrinsics, camera and
    info files byte for byte."""
    import tests.test_pipeline as jtp
    import vipe_tpu.pipeline.default as jdefault
    import vipe_tpu_torch.pipeline.default as tdefault
    from vipe_tpu.streams.base import MultiviewVideoList as JList
    from vipe_tpu.utils import io as jio
    from vipe_tpu_torch.streams.base import MultiviewVideoList as TList

    rig = np.asarray(jlie.se3_exp(jnp.asarray([[0, 0, 0, 0, 0, 0],
                                                [0.1, 0, 0.02, 0, 0.1, 0]], jnp.float32)))

    class StubSLAM:
        def __init__(self, *a, **k):
            pass

        def run(self, stream, camera_type=None, rig=None):
            for s in stream:
                for _ in s:
                    pass
            out = jtp.canned_slam_output()
            out.intrinsics = np.stack([out.intrinsics] * len(stream))
            out.rig = stream.rig
            return out

    def views():
        s0, s1 = (jtp.TinyStream(with_depth=False, with_instance=False) for _ in range(2))
        s0._name, s1._name = "rig_v0", "rig_v1"
        return [s0, s1]

    monkeypatch.setattr(jdefault, "SLAMSystem", StubSLAM)
    monkeypatch.setattr(tdefault, "SLAMSystem", StubSLAM)
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    jdefault.DefaultAnnotationPipeline(init={"intrinsics": "fov"},
                                       output={"path": str(jroot)}).run(JList("rig", views(), rig))
    out = tdefault.DefaultAnnotationPipeline(
        init={"intrinsics": "fov"}, output={"path": str(troot)}, device="cpu",
        return_payload=True).run(TList("rig", views(), rig))
    assert len(out.payload["view_outputs"]) == 2
    tree = sorted(str(p.relative_to(troot)) for p in troot.rglob("*") if p.is_file())
    assert tree == sorted(str(p.relative_to(jroot)) for p in jroot.rglob("*") if p.is_file())
    assert any("rig_v1" in p for p in tree)
    for name in ("rig_v0", "rig_v1"):
        mt, it = jio.read_pose_artifacts(jio.ArtifactPath(troot, name))
        mj, ij = jio.read_pose_artifacts(jio.ArtifactPath(jroot, name))
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(it, ij)
        for rel in (f"intrinsics/{name}.npz", f"intrinsics/{name}_camera.txt",
                    f"vipe/{name}_info.pkl"):
            assert (troot / rel).read_bytes() == (jroot / rel).read_bytes(), rel


def _write_rig_mp4s(root, frames=8):
    import cv2

    rng = np.random.default_rng(5)
    base = (rng.random((H + 32, W + 48, 3)) * 255).astype(np.uint8)
    paths = []
    for v in range(2):
        path = root / f"cam{v}.mp4"
        w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
        for k in range(frames):
            w.write(base[k: k + H, 2 * k + 8 * v: 2 * k + 8 * v + W])
        w.release()
        paths.append(path)
    return paths


def test_stream_list_make_builds_rig_list_like_jax(tmp_path):
    from vipe_tpu.streams.base import StreamList as JStreamList
    from vipe_tpu_torch.streams.base import MultiviewVideoList, StreamList

    paths = [str(p) for p in _write_rig_mp4s(tmp_path, frames=5)]
    rig = [[0, 0, 0, 0, 0, 0, 1], [0.1, 0, 0, 0, 0, 0, 1]]
    cfg = {"videos": paths, "rig": rig}
    (mv,) = list(StreamList.make(
        {"instance": "vipe_tpu_torch.streams.raw_mp4_stream.MultiviewMp4StreamList", **cfg}))
    (jmv,) = list(JStreamList.make(
        {"instance": "vipe_tpu.streams.raw_mp4_stream.MultiviewMp4StreamList", **cfg}))
    assert isinstance(mv, MultiviewVideoList) and mv.cache() is mv
    assert (len(mv), mv.num_frames(), mv.name()) == (len(jmv), jmv.num_frames(), jmv.name())
    np.testing.assert_array_equal(mv.rig, jmv.rig)
    for v in range(2):
        for ft, fj in zip(mv[v], jmv[v]):
            np.testing.assert_array_equal(ft.rgb, fj.rgb)


def test_run_entry_writes_per_view_artifacts_on_cpu(tmp_path):
    """``python -m vipe_tpu_torch.run`` (in-process) on a rig of two mp4s
    with a ``.npy`` rig and ``pipeline.device=cpu``: each view's artifacts,
    view 1's camera offset from view 0's by the rig's translation."""
    from vipe_tpu.utils import io as jio
    from vipe_tpu_torch.run import main

    paths = _write_rig_mp4s(tmp_path)
    rig = np.asarray(jlie.se3_exp(jnp.asarray([[0, 0, 0, 0, 0, 0],
                                                [0.1, 0, 0, 0, 0.05, 0]], jnp.float32)))
    np.save(tmp_path / "rig.npy", rig)
    out = tmp_path / "out"
    main(["streams.instance=vipe_tpu_torch.streams.raw_mp4_stream.MultiviewMp4StreamList",
          f"streams.videos=[{paths[0]},{paths[1]}]", f"streams.rig={tmp_path / 'rig.npy'}",
          "pipeline.device=cpu", f"pipeline.output.path={out}",
          "pipeline.slam.resize_area=3072", "pipeline.slam.warmup=4",
          "pipeline.slam.backend_iters=2", "pipeline.slam.infill_chunk_size=8"])
    mats = []
    for name in ("cam0", "cam1"):
        m, inds = jio.read_pose_artifacts(jio.ArtifactPath(out, name))
        intr, camera_type = jio.read_intrinsics_artifacts(jio.ArtifactPath(out, name))
        assert m.shape == (8, 4, 4) and np.isfinite(m).all() and camera_type == "pinhole"
        assert intr.shape == (8, 4) and np.isfinite(intr).all()
        np.testing.assert_array_equal(inds, np.arange(8))
        mats.append(m)
    offset = np.einsum("tij,j->ti", mats[0][:, :3, :3], rig[1, :3])
    np.testing.assert_allclose(mats[1][:, :3, 3] - mats[0][:, :3, 3], offset, atol=1e-5)


def test_full_rig_scene_with_rig_rotation_recovers_gt():
    """The port alone on ``tests/test_multiview.py``'s full 10 frames, with
    the rig's rotation optimised in the global BA: its ATE limit, and
    view 0 of the rig held at identity."""
    from vipe_tpu.utils.geometry import ate_rmse

    out, gt, rig = _port_rig_run(RIG_T_FULL, dict(RIG_CFG, optimize_rig_rotation=True))
    assert out.trajectory.shape == (RIG_T_FULL, 7) and np.isfinite(out.trajectory).all()
    assert ate_rmse(out.trajectory, gt, align=False) < 0.05
    np.testing.assert_allclose(out.rig[0], [0, 0, 0, 0, 0, 0, 1], atol=1e-6)
    assert out.slam_map.xyz.shape[1:] == (HT, WD, 3)


# ------------------------------ BA and one GRU round (JAX in the second process)


@pytest.mark.parametrize("optimize_rig", [False, True])
def test_ba_solve_mv_matches_jax(optimize_rig):
    """Rig off: disparities and the shared focal move too; rig on: the
    disparities stay, as in the JAX test, and the rig's rotation moves."""
    kw, args, out_j = _JAX_REFS.result("ba")[optimize_rig]
    out_t = tba.ba_solve_mv(tba.BAConfig(**kw), *(_t(a) for a in args), 12, 1e-5, 1e-4)
    names = ("poses", "rig", "disps", "intrinsics")
    for name, t, j in zip(names, out_t, out_j):
        atol = 1e-3 if name == "intrinsics" else 1e-4
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol, err_msg=name)
    rig_t, rig0 = out_t[1].numpy(), args[1]
    np.testing.assert_allclose(rig_t[0], rig0[0], atol=1e-6)
    moved = np.abs(rig_t[1] - rig0[1]).max()
    assert (moved > 1e-3) if optimize_rig else (moved == 0.0)


@pytest.mark.parametrize("corr_mode,corr_dtype", list(ROUND_MODES))
def test_factor_graph_update_round_mv_matches_jax(corr_mode, corr_dtype):
    """Expanded edges, their correlation state (volumes to one bf16 ulp,
    int8 to one step, packed features exactly) and one round's result."""
    n = 6
    rounds = _JAX_REFS.result("rounds")
    (jbuf, jg), (jbuf1, jg1) = rounds[corr_mode, corr_dtype]
    tbuf, tg = _torch_graph_mv(rounds["params"], jbuf, corr_mode, corr_dtype, n=n)
    rows = jg.n_edges * V2
    assert tg.n_edges == jg.n_edges and len(tg.exp) == rows
    np.testing.assert_array_equal(tg.exp, jg.exp[:rows])
    cross = tg.exp[tg.exp[:, 0] == tg.exp[:, 3]]
    assert len(cross) == 4 and (cross[:, 1] != cross[:, 4]).all()
    for lvl, (j, t) in enumerate(zip(jg.corr_pyr, tg.corr_pyr)):
        ref = np.asarray(j[:rows].astype(jnp.float32))
        if tg.corr_alt:
            np.testing.assert_array_equal(t.float().numpy(), ref)
        elif tg.corr_q:
            assert np.abs(t.float().numpy() - ref).max() <= 1
            np.testing.assert_allclose(tg.corr_scale[lvl].numpy(),
                                       np.asarray(jg.corr_scale[lvl][:rows]), rtol=2 ** -8)
        else:
            np.testing.assert_allclose(t.float().numpy(), ref, rtol=2 ** -8, atol=1e-6)

    with torch.no_grad():
        tg.update(use_inactive=True)
    nv = n * V2
    pairs = {
        "poses": (tbuf.poses[:n], jbuf1.poses[:n]),
        "disps": (tbuf.disps[:nv], jbuf1.disps[:nv]),
        "target": (tg.target, jg1.target[:rows]),
        "weight": (tg.weight, jg1.weight[:rows]),
        "damping": (tg.damping[:nv], jg1.damping[:nv]),
    }
    for key, (t, j) in pairs.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-2,
                                   err_msg=f"mismatch in {key}")
    np.testing.assert_array_equal(tg.age, jg1.age[: jg1.n_edges])


# ------------------------------------------------------ the slice, oracle

RIG_T = 6          # frames of the JAX-parity scene
RIG_T_FULL = 10    # frames of tests/test_multiview.py
RIG_CFG = dict(resize_area=H * W, filter_thresh=-1.0, keyframe_thresh=0.0, warmup=4,
               buffer=64, infill_chunk_size=6, backend_iters=8)


def _rig_scene(T, seed=11):
    """``tests/test_multiview.py``'s scene over ``T`` frames: GT rig-base
    poses, the rig (view 1 0.12 m right, yawed 0.1 rad), per-slot
    disparities and per-view intrinsics, and the two views' streams (the
    oracle's own disparities as metric depth, each view's intrinsics)."""
    from vipe_tpu.streams.base import FrameAttribute, VideoFrame, VideoStream

    V = 2
    rng = np.random.default_rng(seed)
    c2w = [jlie.se3_identity()]
    for _ in range(1, T):
        xi = jnp.asarray([0.06, 0.004 * rng.normal(), 0.003 * rng.normal(),
                          0.002 * rng.normal(), 0.003 * rng.normal(), 0.002 * rng.normal()],
                         jnp.float32)
        c2w.append(jlie.se3_mul(c2w[-1], jlie.se3_exp(xi)))
    poses_w2c = jlie.se3_inv(jnp.stack(c2w))
    rig = jnp.stack([jlie.se3_identity(), jlie.se3_exp(
        jnp.asarray([0.12, 0.0, 0.0, 0.0, 0.1, 0.0], jnp.float32))])
    u, v = jgeom.pixel_grid(HT, WD)
    base = 0.5 * (1.0 + 0.1 * jnp.sin(u / 2.0) * jnp.cos(v / 1.5))
    disps = jnp.stack([base * (1.0 + 0.02 * ((k % (T * V)) % 3)) for k in range(T * V)])
    intr = jnp.asarray([[W * 1.2, W * 1.2, W / 2.0, H / 2.0],
                        [W * 1.15, W * 1.15, W / 2.0, H / 2.0]])

    class View(VideoStream):
        def __init__(self, view):
            self.view = view
            self.imgs = [rng.random((H, W, 3)).astype(np.float32) for _ in range(T)]

        def __len__(self):
            return T

        def frame_size(self):
            return (H, W)

        def attributes(self):
            return {FrameAttribute.RGB, FrameAttribute.INTRINSICS,
                    FrameAttribute.METRIC_DEPTH}

        def __iter__(self):
            for k in range(T):
                d = np.asarray(disps[k * V + self.view])
                yield VideoFrame(raw_frame_idx=k, rgb=self.imgs[k],
                                 metric_depth=np.kron(1.0 / d, np.ones((8, 8), np.float32)),
                                 intrinsics=np.asarray(intr[self.view], np.float32).copy())

    views = [View(vv) for vv in range(V)]
    return poses_w2c, rig, disps, intr, views


def _torch_rig_oracle(buffer_ref, poses_w2c, rig, disps, intr):
    """Torch copy of ``tests/test_multiview.make_oracle``: the update
    function gets source and target slots; GT flow through the rig chain,
    unit weights where valid, constant damping."""
    P, R, D = _t(poses_w2c), _t(rig), _t(disps)
    intr_grid = _t(intr) / 8.0
    V = R.shape[0]

    def update_fn(net, inp, corr, motn, ii, jj, num_frames):
        E, ht, wd, _ = motn.shape
        coords1 = motn[..., :2] + tgeom.coords_grid(ht, wd)
        buf = buffer_ref[0]
        di, dj = ii.numpy(), jj.numpy()
        fi = buf.tstamp[np.clip(di // V, 0, buf.buffer_size - 1)]
        fj = buf.tstamp[np.clip(dj // V, 0, buf.buffer_size - 1)]
        qi, qj = di % V, dj % V
        gt, valid = tgeom.reproject_mv(P, R, D, intr_grid, tcam.CameraType.PINHOLE,
                                       *map(_t, (fi, qi, fi * V + qi, fj, qj)))
        weight = valid[..., None].float().expand(E, ht, wd, 2)
        return net, gt - coords1, weight, torch.full((num_frames, ht, wd), 0.01)

    update_fn.host_only = True  # reads host state, as the JAX oracle does
    return update_fn


def _zeros_t(images):
    return torch.zeros((images.shape[0], HT, WD, 128), dtype=torch.bfloat16)


def _port_rig_run(T, config):
    from vipe_tpu_torch.streams.base import MultiviewVideoList

    poses_w2c, rig, disps, intr, views = _rig_scene(T)
    ref = [None]
    oracle = _torch_rig_oracle(ref, poses_w2c, rig, disps, intr)
    out = _run_with_spy(tsystem, ref, lambda: tsystem.SLAMSystem(
        config=config, device="cpu", update_fn=oracle, encode_features=_zeros_t,
        encode_context=lambda im: (_zeros_t(im), _zeros_t(im)),
    ).run(MultiviewVideoList("rig", views, np.asarray(rig))))
    return out, np.asarray(jlie.se3_inv(poses_w2c)), np.asarray(rig)


def _jax_rig_job():
    """The JAX system on the 6-frame rig scene: the one JAX run of this
    module's system-level tests."""
    import vipe_tpu.slam.system as jsystem
    from tests.test_multiview import make_oracle
    from vipe_tpu.streams.base import MultiviewVideoList

    poses_w2c, rig, disps, intr, views = _rig_scene(RIG_T)
    ref = [None]
    oracle = make_oracle(ref, poses_w2c, rig, disps, intr)

    def ef(params, images):
        return jnp.zeros((images.shape[0], HT, WD, 128), jnp.float32)

    return _run_with_spy(jsystem, ref, lambda: jsystem.SLAMSystem(
        config=RIG_CFG, update_fn=oracle, params=None, encode_features=ef,
        encode_context=lambda p, im: (ef(p, im), ef(p, im)),
    ).run(MultiviewVideoList("rig", views, np.asarray(rig))))


_JAX_JOBS = BackgroundJax({"rig": (_jax_rig_job, ())})
# the references of the rig BA solves and of the graph rounds
_JAX_REFS = BackgroundJax({"ba": (_jax_ba_mv_job, ()), "rounds": (_jax_rounds_mv_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_JOBS.start()
    _JAX_REFS.start()
    yield
    _JAX_REFS.stop()
    _JAX_JOBS.stop()


@pytest.fixture(scope="module")
def rig_runs():
    """Both systems on the 6-frame rig scene (the JAX one in the
    background since the module's first test)."""
    out_t, gt, _ = _port_rig_run(RIG_T, RIG_CFG)
    return _JAX_JOBS.result("rig"), out_t, gt


class TestRigOracleParity:
    def test_keyframes_equal(self, rig_runs):
        out_j, out_t, _ = rig_runs
        assert len(out_t.keyframes) == RIG_T
        np.testing.assert_array_equal(out_t.keyframes, out_j.slam_map.frame_inds)
        np.testing.assert_array_equal(out_t.slam_map.frame_inds, out_j.slam_map.frame_inds)

    def test_trajectory_rig_intrinsics_close(self, rig_runs):
        out_j, out_t, gt = rig_runs
        assert out_t.trajectory.shape == (RIG_T, 7) and out_t.intrinsics.shape == (2, 4)
        np.testing.assert_allclose(out_t.trajectory, out_j.trajectory, rtol=0, atol=1e-4)
        np.testing.assert_allclose(out_t.rig, out_j.rig, rtol=0, atol=1e-4)
        np.testing.assert_allclose(out_t.intrinsics, out_j.intrinsics, rtol=0, atol=1e-4)
        assert np.abs(out_t.trajectory[:, :3] - gt[:, :3]).max() < 5e-2

    def test_map_close(self, rig_runs):
        out_j, out_t, _ = rig_runs
        np.testing.assert_array_equal(out_t.slam_map.mask, out_j.slam_map.mask)
        np.testing.assert_allclose(out_t.slam_map.xyz, out_j.slam_map.xyz, rtol=0, atol=1e-4)
        np.testing.assert_allclose(out_t.slam_map.rgb, out_j.slam_map.rgb, rtol=0, atol=1e-6)

    def test_residual_small(self, rig_runs):
        out_j, out_t, _ = rig_runs
        assert 0.0 <= out_t.ba_residual < 1e-6 and out_j.ba_residual < 1e-6
