"""The port's CUDA matcher kernel against its plain PyTorch version.

Needs a CUDA device and nvcc; skips elsewhere.  On a machine with a GPU
(and no JAX, which the repo's conftest imports), run:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from xrsfm_tpu_torch.ops import matching as TM
from xrsfm_tpu_torch.utils.synth import descriptor_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, seed, B, N, M):
    return [torch.from_numpy(a).to(dev)
            for a in descriptor_case(seed, B, N, M)]


@pytest.mark.parametrize("B,N,M", [
    (2, 256, 256),     # the CPU tests' size
    (3, 200, 184),     # ragged: neither side a multiple of the tile
    (1, 1, 1),
    (2, 65, 4097),
    (16, 2048, 2048),  # the 48-image arc run's chunk
])
def test_topstats_kernel_bit_equal_to_plain(cuda_device, B, N, M):
    """All four outputs bit-equal (tolerance 0): both compute exact integer
    dots and the same f32 sentinel adds and tie rules."""
    args = _case(cuda_device, 7 + N, B, N, M)
    got = TM.topstats_cuda(*args)
    torch.cuda.synchronize()
    exp = TM.topstats_reference(*args)
    for g, e, name in zip(got, exp, ("best", "second", "best_j", "col_arg")):
        g, e = g.cpu().numpy(), e.cpu().numpy()
        assert g.dtype == e.dtype, name
        assert np.array_equal(g.view(np.uint32), e.view(np.uint32)), name


def test_topstats_dispatch_counts_kernel_launches(cuda_device):
    args = _case(cuda_device, 3, 2, 128, 128)
    before = dict(TM.LAUNCHES)
    TM.topstats(*args)
    assert TM.LAUNCHES["topstats_cuda"] == before["topstats_cuda"] + 1
    assert TM.LAUNCHES["topstats_plain"] == before["topstats_plain"]


def test_topstats_kernel_rejects_bad_inputs(cuda_device):
    d1, d2, m1, m2 = _case(cuda_device, 1, 2, 128, 128)
    with pytest.raises(ValueError):
        TM.topstats_cuda(d1[..., :64].contiguous(), d2[..., :64].contiguous(),
                         m1, m2)
    with pytest.raises(ValueError):
        TM.topstats_cuda(d1.transpose(0, 1), d2, m1, m2)
    with pytest.raises(TypeError):
        TM.topstats_cuda(d1.float(), d2, m1, m2)
    with pytest.raises(ValueError):
        TM.topstats_cuda(d1.cpu(), d2, m1, m2)
