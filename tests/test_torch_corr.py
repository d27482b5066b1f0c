"""The port's correlation pyramid and K1 lookup against ``vipe_tpu.ops.corr``.

Tolerances:
  * pyramid: both sides correlate bf16 operands with f32 accumulation and
    round the volume to bf16, so entries agree to one bf16 ulp
    (2^-8 relative);
  * lookup vs the XLA path: atol 2e-2, because XLA rounds the row
    contraction to bf16 (``vipe_tpu/ops/corr.py:237``) and the port
    accumulates in f32;
  * lookup vs the Pallas kernel in interpret mode (f32 accumulation, as the
    port): atol 2e-2 as ``tests/test_pallas_corr.py`` states it, measured
    ~1e-6;
  * int8 volumes with per-edge scales: 2e-2 of the output's magnitude
    against JAX's int8 lookup (which contracts with bf16 selection weights).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipe_tpu.ops import corr as jcorr
from vipe_tpu.ops.pallas_corr import corr_lookup_pyramid_pallas
from vipe_tpu_torch.ops import corr as tcorr
from vipe_tpu_torch.ops import corr_kernels as ck


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



def _inputs(seed, E=2, H=6, W=8, C=32, spread=2.0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    u = rng.uniform(-spread, W + spread, (E, H, W))
    v = rng.uniform(-spread, H + spread, (E, H, W))
    return f1, f2, np.stack([u, v], -1).astype(np.float32)


def _to_torch(pyr):
    """JAX bf16 volumes → identical torch bf16 tensors."""
    return [torch.from_numpy(np.array(p.astype(jnp.float32))).to(torch.bfloat16) for p in pyr]


@pytest.fixture(scope="module")
def case():
    f1, f2, coords = _inputs(0, H=6, W=8)
    jpyr = jcorr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    return f1, f2, coords, jpyr, _to_torch(jpyr)


class TestPyramid:
    def test_matches_jax(self, case):
        f1, f2, _, jpyr, _ = case
        tpyr = tcorr.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
        assert len(tpyr) == 4
        for j, t in zip(jpyr, tpyr):
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
            ref = np.asarray(j.astype(jnp.float32))
            np.testing.assert_allclose(t.float().numpy(), ref, rtol=2 ** -8, atol=1e-6)

    @pytest.mark.parametrize("hw", [(6, 8), (7, 9), (2, 3), (41, 73)])
    def test_level_dims_clamp(self, hw):
        for lvl in range(4):
            assert tcorr.level_dims(*hw, lvl) == jcorr.level_dims(*hw, lvl)

    @pytest.mark.parametrize("hw", [(6, 8), (7, 9), (1, 3)])
    def test_avg_pool2(self, hw):
        x = np.random.default_rng(1).standard_normal((2, 3) + hw).astype(np.float32)
        np.testing.assert_allclose(tcorr.avg_pool2(torch.from_numpy(x)).numpy(),
                                   np.asarray(jcorr.avg_pool2(jnp.asarray(x))), atol=1e-6)
        xn = np.moveaxis(x, 1, -1).copy()
        np.testing.assert_allclose(tcorr.avg_pool2_nhwc(torch.from_numpy(xn)).numpy(),
                                   np.asarray(jcorr.avg_pool2_nhwc(jnp.asarray(xn))), atol=1e-6)

    def test_quantize_volume(self, case):
        _, _, _, jpyr, tpyr = case
        qj, sj = jcorr.quantize_volume(jpyr[0])
        qt, st = tcorr.quantize_volume(tpyr[0])
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)


class TestLookup:
    def test_matches_xla_path(self, case):
        _, _, coords, jpyr, tpyr = case
        ref = np.asarray(jcorr.corr_lookup_pyramid(jpyr, jnp.asarray(coords)))
        out = tcorr.corr_lookup_pyramid(tpyr, torch.from_numpy(coords)).numpy()
        assert out.shape == ref.shape == coords.shape[:3] + (196,)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)

    @pytest.mark.parametrize("hw", [(6, 8), (7, 9)])
    def test_matches_pallas_interpret(self, hw):
        _, _, coords = _inputs(2, H=hw[0], W=hw[1])
        f1, f2, _ = _inputs(3, H=hw[0], W=hw[1])
        jpyr = jcorr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
        ref = np.asarray(corr_lookup_pyramid_pallas(jpyr, jnp.asarray(coords), interpret=True))
        out = ck.corr_lookup(_to_torch(jpyr), torch.from_numpy(coords)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)

    def test_out_of_bounds_is_exact_zero(self, case):
        _, _, coords, _, tpyr = case
        far = torch.full(coords.shape, -100.0)
        assert torch.count_nonzero(ck.corr_lookup(tpyr, far)) == 0
        # one pixel far out, its neighbours in: only that row is zero
        c = torch.from_numpy(coords.copy())
        c[0, 1, 2] = torch.tensor([1.0e7, -3.0e6])
        out = ck.corr_lookup(tpyr, c)
        assert torch.count_nonzero(out[0, 1, 2]) == 0
        assert torch.count_nonzero(out[0, 1, 3]) > 0

    def test_clamped_tiny_pyramid(self):
        """A 2×3 grid clamps levels 1..3 to 1 px and still gives 196 channels."""
        f1, f2, coords = _inputs(4, H=2, W=3, spread=1.0)
        jpyr = jcorr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
        assert [p.shape[-2:] for p in jpyr] == [(2, 3), (1, 1), (1, 1), (1, 1)]
        ref = np.asarray(jcorr.corr_lookup_pyramid(jpyr, jnp.asarray(coords)))
        out = ck.corr_lookup(_to_torch(jpyr), torch.from_numpy(coords)).numpy()
        assert out.shape[-1] == 196
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)

    def test_integer_coords_pick_volume_entries(self, case):
        """At integer coords the centre tap of level 0 is the volume entry."""
        _, _, _, _, tpyr = case
        E, H, W = tpyr[0].shape[:3]
        rng = np.random.default_rng(5)
        xs = rng.integers(0, W, (E, H, W))
        ys = rng.integers(0, H, (E, H, W))
        c = torch.from_numpy(np.stack([xs, ys], -1).astype(np.float32))
        out = ck.corr_lookup(tpyr, c)
        centre = out[..., 3 * 7 + 3]
        vol = tpyr[0].float()
        e, p, q = np.meshgrid(np.arange(E), np.arange(H), np.arange(W), indexing="ij")
        np.testing.assert_array_equal(centre.numpy(), vol[e, p, q, ys, xs].numpy())

    def test_int8_with_scales(self, case):
        _, _, coords, jpyr, _ = case
        qs = [jcorr.quantize_volume(p) for p in jpyr]
        ref = np.asarray(jcorr.corr_lookup_pyramid([jcorr.QVol(q, s) for q, s in qs],
                                                   jnp.asarray(coords)))
        vols = [torch.from_numpy(np.asarray(q)) for q, _ in qs]
        scales = [torch.from_numpy(np.asarray(s)) for _, s in qs]
        out = tcorr.corr_lookup_pyramid(vols, torch.from_numpy(coords), scales=scales).numpy()
        assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 2e-2
        # and exactly the lookup of the dequantised volumes, in f32
        deq = [v.float() * s[:, None, None, None, None] for v, s in zip(vols, scales)]
        np.testing.assert_allclose(
            out, ck.corr_lookup_plain(deq, torch.from_numpy(coords)).numpy(), rtol=1e-5, atol=1e-6)


class TestWrapperChecks:
    def test_wrong_volume_dtype(self, case):
        _, _, coords, _, tpyr = case
        with pytest.raises(TypeError):
            ck.corr_lookup([p.half() for p in tpyr], torch.from_numpy(coords))

    def test_mixed_level_dtypes(self, case):
        _, _, coords, _, tpyr = case
        with pytest.raises(TypeError):
            ck.corr_lookup([tpyr[0].float()] + tpyr[1:], torch.from_numpy(coords))

    def test_wrong_coords(self, case):
        _, _, coords, _, tpyr = case
        with pytest.raises(TypeError):
            ck.corr_lookup(tpyr, torch.from_numpy(coords).double())
        with pytest.raises(ValueError):
            ck.corr_lookup(tpyr, torch.from_numpy(coords)[:, :-1].contiguous())
        with pytest.raises(ValueError):
            ck.corr_lookup(tpyr, torch.from_numpy(coords).transpose(1, 2))

    def test_wrong_shapes(self, case):
        _, _, coords, _, tpyr = case
        c = torch.from_numpy(coords)
        with pytest.raises(ValueError):
            ck.corr_lookup(tpyr + tpyr[:1], c)  # 5 levels
        with pytest.raises(ValueError):
            ck.corr_lookup([tpyr[0][:1]] + tpyr[1:], c)
        with pytest.raises(ValueError):
            ck.corr_lookup([tpyr[0].transpose(3, 4)] + tpyr[1:], c)
        with pytest.raises(ValueError):
            ck.corr_lookup(tpyr, c, radius=4)
        with pytest.raises(ValueError):
            ck.corr_lookup(tpyr, c, scales=[torch.ones(c.shape[0])] * 3)
