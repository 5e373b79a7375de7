"""PyTorch port, CUDA kernels K1 (render_stage1) and K2
(render_stage2_scan) against their plain versions on the card.  Skipped
where ``torch.cuda.is_available()`` is false.

On a machine with a GPU and nvcc:  python -m pytest -m cuda tests/
"""

import numpy as np
import pytest
import torch

from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _volume(b, v, seed, device):
    rng = np.random.default_rng(seed)
    vox = rng.random((b, v, v, v)).astype(np.float32) * 0.2
    c = (np.arange(v) + 0.5) / v - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    vox += (x ** 2 + y ** 2 + z ** 2 < 0.09).astype(np.float32) * 0.9
    return torch.from_numpy(np.clip(vox, 1e-5, 1 - 1e-5)).to(device)


@pytest.mark.parametrize("dtype,v,r,z,m", [
    ("float32", 32, 32, 64, 64), ("bfloat16", 32, 32, 64, 64),
    ("bfloat16", 64, 64, 96, 96)])
def test_kernels_match_plain(device, dtype, v, r, z, m):
    cd = getattr(torch, dtype)
    vox = _volume(2, v, 0, device)
    rk.reset_launches()
    c = rk.stage1(vox, v, r, z, m, cd)
    out = rk.stage2(c, v, r, z, m, cd)
    torch.cuda.synchronize()
    assert rk.launches == {"render_stage1": 1, "render_stage2_scan": 1}
    c_ref = rk.stage1_plain(vox, v, r, z, m, cd)
    out_ref = rk.stage2_plain(c, v, r, z, m, cd)
    dc = (c.float() - c_ref.float()).abs()
    de = (out - out_ref).abs()
    if dtype == "float32":
        # summation order only
        assert dc.max() < 1e-5 and de.max() < 1e-5, (dc.max(), de.max())
    else:
        # the plain version rounds t1 / t2 to bf16, the kernels do not
        assert dc.max() < 1.6e-2 and dc.mean() < 1e-3, (dc.max(), dc.mean())
        assert de.max() < 3e-2 and de.mean() < 2e-3, (de.max(), de.mean())


def test_cuda_tensor_never_falls_back(device):
    vox = _volume(1, 32, 1, device)
    with pytest.raises(TypeError):
        rk.stage1(vox, 32, 32, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        rk.stage2(torch.zeros(1, 32, 64, 32, device=device), 32, 32, 1024,
                  64, torch.float32)
