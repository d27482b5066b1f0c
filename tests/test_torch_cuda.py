"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one; the last ones
hold the deterministic segment sum (plain PyTorch, no kernel of the port)
to its bits on the card, UniDepth-S (library calls, no kernel of the
port) on the card to the CPU and its bf16 SLAM prior to its f32 one, and
Metric3D-small's ``estimate`` on the card to the CPU.  The file imports neither JAX nor ``vipe_tpu``, so it
also runs on a machine that has only PyTorch and the CUDA toolkit::

    python -m pytest tests/test_torch_cuda.py -q

Tolerance: each kernel and its plain version compute the same f32 products
of the same bf16/f32/int8 values in another order, 1e-5 absolute on values
of order 1.  ``chip_smoke.py`` repeats these checks at the main path's
shapes.
"""

import numpy as np
import pytest
import torch

from vipe_tpu_torch.ops import corr as tcorr
from vipe_tpu_torch.ops import corr_kernels as ck


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 are CUDA kernels (chip_smoke.py runs "
                    "these checks)")
    return torch.device("cuda")


def _inputs(seed, E=3, H=7, W=9, C=32, spread=6.0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    u = rng.uniform(-spread, W + spread, (E, H, W))
    v = rng.uniform(-spread, H + spread, (E, H, W))
    return f1, f2, np.stack([u, v], -1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_corr_lookup_matches_plain(cuda_device, dtype, levels):
    """1-3 levels leave a warp's lanes of the missing levels idle; the odd
    7×9 grid clamps levels 2-3 to 1-px planes and holds far-out, integer
    and fully out-of-plane pixels."""
    f1, f2, coords = _inputs(6)
    pyr = tcorr.corr_pyramid(torch.from_numpy(f1).to(cuda_device),
                             torch.from_numpy(f2).to(cuda_device))[:levels]
    scales = None
    if dtype == torch.int8:
        pyr, scales = map(list, zip(*(tcorr.quantize_volume(p) for p in pyr)))
    else:
        pyr = [p.to(dtype) for p in pyr]
    c = _far_coords(coords).to(cuda_device)
    before = ck.corr_lookup.launches
    out = ck.corr_lookup(pyr, c, scales=scales)
    assert ck.corr_lookup.launches == before + 1
    ref = ck.corr_lookup_plain(pyr, c, scales=scales)
    torch.cuda.synchronize()
    assert out.shape == (3, 7, 9, 49 * levels)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert bool((out[2, 3] == 0).all()) and bool((out[0, 0, :2] == 0).all())


@pytest.mark.cuda
def test_corr_lookup_rejects_mixed_devices(cuda_device):
    f1, f2, coords = _inputs(7)
    pyr = tcorr.corr_pyramid(torch.from_numpy(f1).to(cuda_device),
                             torch.from_numpy(f2).to(cuda_device))
    with pytest.raises(ValueError):
        ck.corr_lookup(pyr, torch.from_numpy(coords))


def _far_coords(coords):
    """Odd-grid coords with far-out, integer and fully out-of-plane pixels."""
    c = torch.from_numpy(coords.copy())
    c[0, 0, 0] = torch.tensor([-1.0e6, 3.0])
    c[0, 0, 1] = torch.tensor([4.0, 1.0e6])
    c[1, 2] = torch.round(c[1, 2])
    c[2, 3] = -40.0
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 128), (torch.float32, 128),
                                     (torch.bfloat16, 96), (torch.bfloat16, 32),
                                     (torch.bfloat16, 36), (torch.bfloat16, 2),
                                     (torch.bfloat16, 256)])
def test_corr_fused_matches_plain(cuda_device, dtype, C):
    """bf16 packed features (``corr_feat_pack``) and f32 features taken as
    prescaled; C = 96, 36 and 2 are padded to the mma depth of 16, and rows
    of C = 36 and 2 are not 16-byte multiples (4-byte copies)."""
    f1, f2, coords = _inputs(8, C=C)
    packed = tcorr.corr_feat_pack(torch.from_numpy(f1).to(cuda_device),
                                  torch.from_numpy(f2).to(cuda_device))
    packed = [p.to(dtype).contiguous() for p in packed]
    c = _far_coords(coords).to(cuda_device)
    before = ck.corr_fused.launches
    out = ck.corr_fused(packed[0], packed[1:], c)
    assert ck.corr_fused.launches == before + 1
    ref = ck.corr_fused_plain(packed[0], packed[1:], c)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert bool((out[2, 3] == 0).all()) and bool((out[0, 0, :2] == 0).all())
    assert int(torch.count_nonzero(out)) > 0


@pytest.mark.cuda
def test_corr_fused_raw_features_match_plain(cuda_device):
    """``prescaled=False``: the /4 scaling and bf16 cast happen in the wrapper."""
    f1, f2, coords = _inputs(9, C=128)
    t1, t2 = (torch.from_numpy(x).to(cuda_device) for x in (f1, f2))
    pools = [t2]
    for _ in range(3):
        pools.append(tcorr.avg_pool2_nhwc(pools[-1]).contiguous())
    c = torch.from_numpy(coords).to(cuda_device)
    out = ck.corr_fused(t1, pools, c, prescaled=False)
    ref = ck.corr_fused_plain(t1, pools, c, prescaled=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_corr_fused_rejects_mixed_devices(cuda_device):
    f1, f2, coords = _inputs(7)
    packed = tcorr.corr_feat_pack(torch.from_numpy(f1).to(cuda_device),
                                  torch.from_numpy(f2).to(cuda_device))
    with pytest.raises(ValueError):
        ck.corr_fused(packed[0], packed[1:], torch.from_numpy(coords))


def _grid_coords(E, H, W):
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return np.broadcast_to(np.stack([u, v], -1), (E, H, W, 2)).copy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_corr_lookup_ragged_grid(cuda_device, dtype):
    """The frontend's 41×73 grid (levels 41×73 … 5×9) with smooth coords."""
    rng = np.random.default_rng(12)
    E, H, W = 2, 41, 73
    f1, f2 = (rng.standard_normal((E, H, W, 32)).astype(np.float32) for _ in range(2))
    coords = _grid_coords(E, H, W) + rng.normal(0, 2.0, (E, H, W, 2)).astype(np.float32)
    pyr = tcorr.corr_pyramid(torch.from_numpy(f1).to(cuda_device),
                             torch.from_numpy(f2).to(cuda_device))
    scales = None
    if dtype == torch.int8:
        pyr, scales = map(list, zip(*(tcorr.quantize_volume(p) for p in pyr)))
    c = torch.from_numpy(coords).to(cuda_device)
    out = ck.corr_lookup(pyr, c, scales=scales)
    ref = ck.corr_lookup_plain(pyr, c, scales=scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def _fused_coords(kind, E, H, W, rng):
    if kind == "smooth":   # grid + constant shift + small noise: compact boxes
        return (_grid_coords(E, H, W) + np.float32([2.5, -1.25])
                + rng.normal(0, 0.3, (E, H, W, 2)).astype(np.float32))
    if kind == "uniform":  # boxes cover the whole plane, several chunks each
        u = rng.uniform(-2.0, W + 2.0, (E, H, W))
        v = rng.uniform(-2.0, H + 2.0, (E, H, W))
        return np.stack([u, v], -1).astype(np.float32)
    # one 8×8 tile mixing far-out, integer and in-plane pixels
    c = _grid_coords(E, H, W) + rng.normal(0, 1.0, (E, H, W, 2)).astype(np.float32)
    c[0, 0, 0:3] = [-1.0e6, 2.0]
    c[0, 1, 0:3] = [5.0, 1.0e6]
    c[0, 2, 1] = [1.0e6, -1.0e6]
    c[0, 3, 2:6] = np.round(c[0, 3, 2:6])
    c[1, 4, 4] = [3.0, 4.0]
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(7, 9), (41, 73)])
@pytest.mark.parametrize("kind", ["smooth", "uniform", "mixed"])
def test_corr_fused_coords(cuda_device, kind, grid):
    """Tiles whose boxes are compact (smooth flow), cover the whole plane in
    several chunks (uniform coords), or mix far-out, integer and in-plane
    pixels; ragged 41×73 tiles and the odd 7×9 grid with 1-px levels."""
    rng = np.random.default_rng(13)
    H, W = grid
    E, C = 2, 128
    f1, f2 = (rng.standard_normal((E, H, W, C)).astype(np.float32) for _ in range(2))
    packed = tcorr.corr_feat_pack(torch.from_numpy(f1).to(cuda_device),
                                  torch.from_numpy(f2).to(cuda_device))
    c = torch.from_numpy(_fused_coords(kind, E, H, W, rng)).to(cuda_device)
    out = ck.corr_fused(packed[0], packed[1:], c)
    ref = ck.corr_fused_plain(packed[0], packed[1:], c)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    if kind == "mixed":
        far = out[0, 0, 0:3], out[0, 1, 0:3], out[0, 2, 1]
        assert all(bool((f == 0).all()) for f in far)
        assert int(torch.count_nonzero(out[0, 3, 2:6])) > 0


@pytest.mark.cuda
def test_corr_fused_unaligned_levels(cuda_device):
    """f2 levels that start 4 bytes past a 16-byte boundary take the 4-byte
    copies even at C = 128."""
    f1, f2, coords = _inputs(14, C=128)
    packed = tcorr.corr_feat_pack(torch.from_numpy(f1).to(cuda_device),
                                  torch.from_numpy(f2).to(cuda_device))
    shifted = []
    for p in packed[1:]:
        buf = torch.empty(p.numel() + 2, dtype=p.dtype, device=cuda_device)
        view = buf[2:].view(p.shape)
        view.copy_(p)
        shifted.append(view)
    assert all(s.data_ptr() % 16 == 4 for s in shifted)
    c = torch.from_numpy(coords).to(cuda_device)
    out = ck.corr_fused(packed[0], shifted, c)
    ref = ck.corr_fused_plain(packed[0], packed[1:], c)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_launch_counters(cuda_device):
    """Each wrapper counts one launch per call on the card, and none for its
    plain version or a CPU call."""
    f1, f2, coords = _inputs(15)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    c = torch.from_numpy(coords)
    vols = tcorr.corr_pyramid(t1.to(cuda_device), t2.to(cuda_device))
    packed = tcorr.corr_feat_pack(t1.to(cuda_device), t2.to(cuda_device))
    n1, n8, n2 = ck.corr_lookup.launches, ck.corr_lookup.int8_launches, ck.corr_fused.launches
    ck.corr_lookup(vols, c.to(cuda_device))
    ck.corr_lookup_plain(vols, c.to(cuda_device))
    ck.corr_lookup(tcorr.corr_pyramid(t1, t2), c)
    q, s = map(list, zip(*(tcorr.quantize_volume(v) for v in vols)))
    ck.corr_lookup(q, c.to(cuda_device), scales=s)
    ck.corr_fused(packed[0], packed[1:], c.to(cuda_device))
    ck.corr_fused_plain(packed[0], packed[1:], c.to(cuda_device))
    ck.corr_fused(t1, [t2], c, prescaled=False)
    torch.cuda.synchronize()
    assert (ck.corr_lookup.launches - n1, ck.corr_lookup.int8_launches - n8,
            ck.corr_fused.launches - n2) == (2, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("corr_mode,corr_dtype", [("volume", "bf16"), ("volume", "int8"),
                                                  ("alt", "bf16")])
def test_late_removal_lookups_match_plain(cuda_device, corr_mode, corr_dtype):
    """A late removal on the card (``rm_keyframe(ix, top)`` above
    ``n_frames``, after an eviction into the inactive store) compacts the
    graph's correlation rows: they equal a fresh build for the surviving
    edges, and K1 (K2 in alt mode) on them equals its plain version."""
    from vipe_tpu_torch.slam.buffer import GraphBuffer
    from vipe_tpu_torch.slam.factor_graph import FactorGraph

    H, W, n = 48, 64, 6
    rng = np.random.default_rng(9)
    buf = GraphBuffer(height=H, width=W, buffer_size=16, device=cuda_device)
    intr = np.asarray([W, W, W / 2, H / 2], np.float32)
    for k in range(n):
        feats = [torch.from_numpy(rng.standard_normal((H // 8, W // 8, 128)).astype(np.float32))
                 .to(cuda_device, torch.bfloat16) for _ in range(3)]
        buf.append_keyframe(k, torch.zeros((H, W, 3), dtype=torch.uint8), *feats, intrinsics=intr)
        buf.poses[k, 0] = 0.1 * k
    g = FactorGraph(buf, None, max_factors=16, incremental=True, corr_mode=corr_mode,
                    corr_dtype=corr_dtype)
    g.add_neighborhood_factors(0, n, r=1)
    evict = np.zeros(g.n_edges, bool)
    evict[[1, 4]] = True
    g.rm_factors(evict, store=True)
    g.rm_keyframe(2, top=n)
    assert buf.n_frames == n - 1 and g.n_edges > 0
    ii = torch.from_numpy(g.ii).to(cuda_device)
    jj = torch.from_numpy(g.jj).to(cuda_device)
    f1, f2 = buf.fmaps[ii].float(), buf.fmaps[jj].float()
    fresh = tcorr.corr_feat_pack(f1, f2) if corr_mode == "alt" else tcorr.corr_pyramid(f1, f2)
    for stored, ref in zip(g.corr_pyr, fresh):
        if g.corr_q:
            continue  # int8 rows: checked through the lookup below
        torch.testing.assert_close(stored.float(), ref.float(), rtol=0, atol=0)
    coords, _ = buf.reproject(g.ii, g.jj)
    coords = coords.contiguous()
    if corr_mode == "alt":
        before = ck.corr_fused.launches
        out = tcorr.corr_lookup_pyramid(g.corr_pyr, coords)
        assert ck.corr_fused.launches == before + 1
        ref = ck.corr_fused_plain(g.corr_pyr[0], g.corr_pyr[1:], coords, prescaled=True)
    else:
        before = ck.corr_lookup.launches
        out = tcorr.corr_lookup_pyramid(g.corr_pyr, coords, scales=g.corr_scale)
        assert ck.corr_lookup.launches == before + 1
        ref = ck.corr_lookup_plain(g.corr_pyr, coords, scales=g.corr_scale)
        if g.corr_q:
            deq = tcorr.corr_lookup_pyramid(fresh, coords)
            assert float((out - deq).abs().max()) < 1.5e-2 * float(deq.abs().max())
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert int(torch.count_nonzero(out)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("corr_mode,corr_dtype", [("volume", "bf16"), ("volume", "int8"),
                                                  ("alt", "bf16")])
def test_rig_cross_view_lookups_match_plain(cuda_device, corr_mode, corr_dtype):
    """A 2-view rig graph with temporal and cross-view edges (``i → i``
    targets the other view's slot) on the card: its expanded rows' state
    equals a fresh build from the gathered slots, and K1 (K2 in alt mode)
    on the expanded edges' coords equals its plain version."""
    from vipe_tpu_torch.ops import lie
    from vipe_tpu_torch.slam.buffer import GraphBuffer
    from vipe_tpu_torch.slam.factor_graph import FactorGraph

    H, W, n, V = 48, 64, 5, 2
    rng = np.random.default_rng(10)
    rig = torch.stack([lie.se3_identity(), lie.se3_exp(torch.tensor([0.12, 0, 0, 0, 0.1, 0.0]))])
    buf = GraphBuffer(height=H, width=W, buffer_size=8, device=cuda_device, n_views=V,
                      rig=rig.numpy())
    intr = np.asarray([[W, W, W / 2, H / 2], [W * 1.1, W * 1.1, W / 2, H / 2]], np.float32)
    for k in range(n):
        feats = [torch.from_numpy(rng.standard_normal((V, H // 8, W // 8, 128))
                                  .astype(np.float32)).to(cuda_device, torch.bfloat16)
                 for _ in range(3)]
        buf.append_keyframe(k, torch.zeros((V, H, W, 3), dtype=torch.uint8), *feats,
                            intrinsics=intr)
        buf.poses[k, 0] = 0.1 * k
    g = FactorGraph(buf, None, max_factors=24, incremental=True, corr_mode=corr_mode,
                    corr_dtype=corr_dtype)
    g.add_neighborhood_factors(0, n, r=1)
    g.add_factors(np.arange(n), np.arange(n))
    cross = g.exp[g.exp[:, 0] == g.exp[:, 3]]
    assert len(cross) == n * V and (cross[:, 1] != cross[:, 4]).all()
    di = torch.from_numpy(g.exp[:, 2]).to(cuda_device)
    dj = torch.from_numpy(g.exp[:, 3] * V + g.exp[:, 4]).to(cuda_device)
    f1, f2 = buf.fmaps[di].float(), buf.fmaps[dj].float()
    fresh = tcorr.corr_feat_pack(f1, f2) if corr_mode == "alt" else tcorr.corr_pyramid(f1, f2)
    if not g.corr_q:
        for stored, ref in zip(g.corr_pyr, fresh):
            torch.testing.assert_close(stored.float(), ref.float(), rtol=0, atol=0)
    coords, _ = buf.reproject_exp(g.exp)
    coords = coords.contiguous()
    if corr_mode == "alt":
        before = ck.corr_fused.launches
        out = tcorr.corr_lookup_pyramid(g.corr_pyr, coords)
        assert ck.corr_fused.launches == before + 1
        ref = ck.corr_fused_plain(g.corr_pyr[0], g.corr_pyr[1:], coords, prescaled=True)
    else:
        before = ck.corr_lookup.launches
        out = tcorr.corr_lookup_pyramid(g.corr_pyr, coords, scales=g.corr_scale)
        assert ck.corr_lookup.launches == before + 1
        ref = ck.corr_lookup_plain(g.corr_pyr, coords, scales=g.corr_scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert int(torch.count_nonzero(out)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows,tail,n", [(48, (128, 41, 73), 12), (2000, (6, 36), 121)])
def test_segment_sum_repeats_on_the_card(cuda_device, rows, tail, n):
    """The BA's and GraphAgg's segment sum gives the same bits on every run
    (``index_add_`` on the card adds with atomics), and the CPU's bits: both
    add each segment's rows in their order."""
    from vipe_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows,) + tail).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, rows))
    runs = [segment_sum(x.to(cuda_device), idx.to(cuda_device), n).cpu() for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    assert torch.equal(runs[0], segment_sum(x, idx, n))


def _unidepth_s(device):
    """UniDepth-S at its published width (a 512-wide decoder), seeded."""
    from vipe_tpu_torch.priors.depth.unidepth import UniDepthModel

    return UniDepthModel("s", device=device, pixels_min=20_000, pixels_max=40_000)


@pytest.mark.cuda
@pytest.mark.parametrize("camera", ["given_rays", "predicted"])
def test_unidepth_net_card_matches_cpu(cuda_device, camera):
    """``UniDepthNet`` on the card against the CPU, both in IEEE f32 (no
    TF32), within 1e-3 relative to the largest value: 12 blocks and the
    decoder's sums in another order."""
    from vipe_tpu_torch.priors.depth.unidepth import pinhole_rays
    from vipe_tpu_torch.utils.device import true_f32

    net = _unidepth_s("cpu").net
    x = torch.randn((1, 3, 140, 182), generator=torch.Generator().manual_seed(1))
    rays = None
    if camera == "given_rays":
        rays = pinhole_rays(torch.tensor([[150.0, 150.0, 93.3, 68.1]]), (140, 182))
    with torch.no_grad(), true_f32():
        ref = net(x, rays)
        got = net.to(cuda_device)(x.to(cuda_device), None if rays is None else rays.to(cuda_device))
    for key in ("depth", "confidence", "intrinsics"):
        err = (got[key].cpu() - ref[key]).abs().max() / ref[key].abs().max()
        assert float(err) < 1e-3, (key, float(err))


@pytest.mark.cuda
def test_unidepth_bf16_prior_matches_f32(cuda_device):
    """SLAM's prior (``estimate_sens_device``) in bf16 against the same path
    in f32 on the card, on a seeded 240×320 uint8 frame: within 5e-2 of the
    largest prior, finite and positive.  The bf16 path leaves the f32
    weights on the host."""
    model = _unidepth_s(cuda_device)
    g = torch.Generator().manual_seed(2)
    img = torch.randint(0, 256, (240, 320, 3), dtype=torch.uint8, generator=g).to(cuda_device)
    row = torch.tensor([300.0, 300.0, 160.0, 120.0], device=cuda_device)
    got = model.estimate_sens_device(img, row)
    assert all(p.device.type == "cpu" for p in model._net.parameters())
    assert all(p.device.type == "cuda" for p in model.net_bf16.parameters())
    ref = model.estimate_sens_device(img, row, dtype=torch.float32)
    assert got.shape == (30, 40) and bool(torch.isfinite(got).all()) and bool((got > 0).all())
    assert float((got - ref).abs().max() / ref.abs().max()) < 5e-2


@pytest.mark.cuda
def test_metric3d_estimate_card_matches_cpu(cuda_device):
    """Metric3D-small (seeded, a 140×182 canvas, 2 refinement steps)
    ``estimate`` on the card against the CPU, both in IEEE f32: the frame's
    depth within 1e-3 of the largest value, from a frame given as a card
    tensor (SLAM's buffer hands its images so) and as a host array."""
    from vipe_tpu_torch.priors.depth.base import DepthEstimationInput
    from vipe_tpu_torch.priors.depth.metric3d import Metric3DModel

    kw = dict(input_size=(140, 182), iters=2)
    cpu, card = Metric3DModel("small", device="cpu", **kw), Metric3DModel("small",
                                                                         device=cuda_device, **kw)
    rgb = torch.rand((96, 160, 3), generator=torch.Generator().manual_seed(3))
    ref = cpu.estimate(DepthEstimationInput(rgb, 120.0)).depth
    for given in (rgb.to(cuda_device), rgb.numpy()):
        got = card.estimate(DepthEstimationInput(given, 120.0)).depth
        assert got.device.type == "cuda" and got.shape == (96, 160)
        assert float((got.cpu() - ref).abs().max() / ref.abs().max()) < 1e-3
