"""The port's alt-mode correlation (``corr_feat_pack`` and K2's plain
version) against ``vipe_tpu.ops``.

Tolerances, each with its reason and the error measured on the CPU:
  * ``corr_feat_pack``: the same /4 scaling, bf16 casts and bf16 pooling on
    both sides, bit for bit;
  * against the XLA alt path (``corr_lookup_pyramid`` of packed features):
    both form f32 dots of the same bf16 values and take the same bilinear
    weights, in another summation order: atol 1e-5 (measured ≤1.2e-7 on
    values of order 1);
  * against ``corr_fused_pallas`` in interpret mode: atol 2e-2, as
    ``tests/test_pallas_corr.py`` states it (measured ≤1.2e-7);
  * against the materialised path (``corr_pyramid`` + K1's plain version):
    atol 2e-2, because the stored volumes are rounded to bf16 and the
    on-the-fly dots are not (measured ≤2.4e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipe_tpu.ops import corr as jcorr
from vipe_tpu.ops.pallas_corr import corr_fused_pallas
from vipe_tpu_torch.ops import corr as tcorr
from vipe_tpu_torch.ops import corr_kernels as ck

# the XLA reference as one compiled program instead of an eager dispatch per op
_jax_lookup = jax.jit(jcorr.corr_lookup_pyramid, static_argnums=2)


GRIDS = [(6, 8), (7, 9), (2, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Intra-op threads only contend with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, E=3, H=6, W=8, C=32, spread=2.0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    u = rng.uniform(-spread, W + spread, (E, H, W))
    v = rng.uniform(-spread, H + spread, (E, H, W))
    return f1, f2, np.stack([u, v], -1).astype(np.float32)


def _packed(f1, f2):
    jp = jcorr.corr_feat_pack(jnp.asarray(f1), jnp.asarray(f2))
    tp = tcorr.corr_feat_pack(torch.from_numpy(f1), torch.from_numpy(f2))
    return jp, tp


def _raw_pools(f2):
    """Raw (unscaled) f2 pooled per level, as ``corr_fused_pallas`` takes it."""
    pools = [jnp.asarray(f2)]
    for _ in range(3):
        pools.append(jcorr.avg_pool2_nhwc(pools[-1]))
    return pools, [torch.from_numpy(np.array(p)) for p in pools]


@pytest.mark.parametrize("hw", GRIDS)
def test_feat_pack_bit_exact(hw):
    f1, f2, _ = _inputs(0, H=hw[0], W=hw[1])
    jp, tp = _packed(f1, f2)
    assert len(tp) == 5
    for j, t in zip(jp, tp):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape and t.is_contiguous()
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("hw", GRIDS)
def test_lookup_matches_xla_alt_path(hw):
    f1, f2, coords = _inputs(1, H=hw[0], W=hw[1], spread=1.0 if hw == (2, 3) else 2.0)
    jp, tp = _packed(f1, f2)
    ref = np.asarray(_jax_lookup(jp, jnp.asarray(coords)))
    out = tcorr.corr_lookup_pyramid(tp, torch.from_numpy(coords)).numpy()
    assert out.shape == ref.shape == coords.shape[:3] + (196,)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("prescaled", [True, False])
@pytest.mark.parametrize("hw", [(6, 8), (7, 9)])
def test_plain_matches_pallas_interpret(hw, prescaled):
    f1, f2, coords = _inputs(2, H=hw[0], W=hw[1])
    c = jnp.asarray(coords)
    if prescaled:
        jp, tp = _packed(f1, f2)
        ref = corr_fused_pallas(jp[0], list(jp[1:]), c, interpret=True, prescaled=True)
        out = ck.corr_fused_plain(tp[0], tp[1:], torch.from_numpy(coords), prescaled=True)
    else:
        jpools, tpools = _raw_pools(f2)
        ref = corr_fused_pallas(jnp.asarray(f1), jpools, c, interpret=True)
        out = ck.corr_fused(torch.from_numpy(f1), tpools, torch.from_numpy(coords),
                            prescaled=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-2)


@pytest.mark.parametrize("hw", [(6, 8), (7, 9)])
def test_matches_materialised_path(hw):
    f1, f2, coords = _inputs(3, H=hw[0], W=hw[1])
    t1, t2, c = torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(coords)
    out = tcorr.corr_lookup_pyramid(tcorr.corr_feat_pack(t1, t2), c)
    ref = ck.corr_lookup_plain(tcorr.corr_pyramid(t1, t2), c)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=2e-2)


def test_out_of_plane_is_exact_zero():
    f1, f2, coords = _inputs(4)
    _, tp = _packed(f1, f2)
    far = torch.full(coords.shape, 500.0)
    assert torch.count_nonzero(tcorr.corr_lookup_pyramid(tp, far)) == 0
    # one pixel far out, its neighbours in: only that row is zero
    c = torch.from_numpy(coords.copy())
    c[0, 1, 2] = torch.tensor([1.0e7, -3.0e6])
    out = tcorr.corr_lookup_pyramid(tp, c)
    assert torch.count_nonzero(out[0, 1, 2]) == 0
    assert torch.count_nonzero(out[0, 1, 3]) > 0


def test_clamped_tiny_grid():
    """A 2×3 grid clamps levels 1..3 to 1 px and still gives 196 channels,
    as the materialised path does."""
    f1, f2, coords = _inputs(5, H=2, W=3, spread=1.0)
    jp, tp = _packed(f1, f2)
    assert [tuple(p.shape[1:3]) for p in tp[1:]] == [(2, 3), (1, 1), (1, 1), (1, 1)]
    out = tcorr.corr_lookup_pyramid(tp, torch.from_numpy(coords)).numpy()
    ref = np.asarray(_jax_lookup(
        jcorr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(coords)))
    assert out.shape[-1] == 196
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)


def test_integer_coords_pick_the_dot():
    """At integer coords the centre tap of level 0 is the f32 dot of f1 with
    f2 at that position."""
    f1, f2, _ = _inputs(6)
    _, tp = _packed(f1, f2)
    E, H, W, _ = f1.shape
    rng = np.random.default_rng(7)
    xs, ys = rng.integers(0, W, (E, H, W)), rng.integers(0, H, (E, H, W))
    c = torch.from_numpy(np.stack([xs, ys], -1).astype(np.float32))
    centre = tcorr.corr_lookup_pyramid(tp, c)[..., 3 * 7 + 3]
    e = np.arange(E)[:, None, None]
    dot = (tp[0].float() * tp[1].float()[e, ys, xs]).sum(-1)
    np.testing.assert_allclose(centre.numpy(), dot.numpy(), rtol=0, atol=1e-6)


def test_plain_edge_chunks_agree(monkeypatch):
    """The plain version's edge chunking changes nothing."""
    f1, f2, coords = _inputs(8)
    _, tp = _packed(f1, f2)
    c = torch.from_numpy(coords)
    whole = ck.corr_fused_plain(tp[0], tp[1:], c)
    monkeypatch.setattr(ck, "PLAIN_CHUNK_BYTES", 1)  # one edge per chunk
    torch.testing.assert_close(ck.corr_fused_plain(tp[0], tp[1:], c), whole, rtol=0, atol=0)


class TestWrapperChecks:
    @pytest.fixture
    def case(self):
        f1, f2, coords = _inputs(9)
        _, tp = _packed(f1, f2)
        return tp, torch.from_numpy(coords)

    def test_wrong_dtype(self, case):
        tp, c = case
        with pytest.raises(TypeError):
            ck.corr_fused(tp[0].half(), tp[1:], c)
        with pytest.raises(TypeError):
            ck.corr_fused(tp[0], tp[1:], c.double())

    def test_wrong_shapes(self, case):
        tp, c = case
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0], tp[1:] + tp[1:2], c)  # 5 levels
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0][:1], tp[1:], c)
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0], [tp[1][..., :16].contiguous()] + tp[2:], c)
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0][..., :15].contiguous(), [p[..., :15].contiguous() for p in tp[1:]], c)
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0], tp[1:], c[..., :1].contiguous())

    def test_wrong_radius(self, case):
        tp, c = case
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0], tp[1:], c, radius=4)

    def test_non_contiguous(self, case):
        tp, c = case
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0].transpose(1, 2), tp[1:], c.transpose(1, 2))
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0], [tp[1].transpose(1, 2)] + tp[2:], c)

    def test_mixed_devices(self, case):
        tp, c = case
        with pytest.raises(ValueError):
            ck.corr_fused(tp[0].to("meta"), tp[1:], c)

    def test_scales_refused_for_packed_features(self, case):
        tp, c = case
        with pytest.raises(ValueError):
            tcorr.corr_lookup_pyramid(tp, c, scales=[torch.ones(c.shape[0])] * 4)
