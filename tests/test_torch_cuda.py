"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor ``vipe_tpu``, so it also runs on a machine that has only
PyTorch and the CUDA toolkit::

    python -m pytest tests/test_torch_cuda.py -q

Tolerance: the kernel and the plain version compute the same f32 products
of the same volume values in another order, 1e-5 absolute on values of
order 1.  ``chip_smoke.py`` repeats these checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from vipe_tpu_torch.ops import corr as tcorr
from vipe_tpu_torch.ops import corr_kernels as ck


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel (chip_smoke.py runs this check)")
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
