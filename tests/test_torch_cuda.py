"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor ``vipe_tpu``, so it also runs on a machine that has only
PyTorch and the CUDA toolkit::

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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_corr_lookup_matches_plain(cuda_device, dtype):
    f1, f2, coords = _inputs(6)
    pyr = tcorr.corr_pyramid(torch.from_numpy(f1).to(cuda_device),
                             torch.from_numpy(f2).to(cuda_device))
    scales = None
    if dtype == torch.int8:
        pyr, scales = map(list, zip(*(tcorr.quantize_volume(p) for p in pyr)))
    else:
        pyr = [p.to(dtype) for p in pyr]
    c = torch.from_numpy(coords).to(cuda_device)
    before = ck.corr_lookup.launches
    out = ck.corr_lookup(pyr, c, scales=scales)
    assert ck.corr_lookup.launches == before + 1
    ref = ck.corr_lookup_plain(pyr, c, scales=scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


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
                                     (torch.bfloat16, 96), (torch.bfloat16, 32)])
def test_corr_fused_matches_plain(cuda_device, dtype, C):
    """bf16 packed features (``corr_feat_pack``) and f32 features taken as
    prescaled; C = 96 and 32 leave lanes without channels."""
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
