"""PyTorch port, K6's backward on the card: the critic stem's input
gradient (the activation's slope by the sign of K6's output, then K3's
transposed convolution, then float32) at the fine-tuning cell's (64, 1,
128³) against float64 autograd of ``F.conv3d`` and ``F.leaky_relu`` on the
bf16-rounded v and weight; the backward's mask kernel against
``mask_plain`` bit for bit at each S it is built for; and the launches of K6 and of its backward in
a ShapeHD fine-tuning step (one each) and in a WGAN-GP step (none).
Skipped where ``torch.cuda.is_available()`` is false.

On a machine with a GPU and nvcc:
  python -m pytest --noconftest -m cuda \
      tests/test_torch_port_critic_stem_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as stem
from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_critic_stem_backward_matches_autograd(device):
    """v's gradient through K6's backward at (64, 1, 128³), on float32
    probabilities and a frozen weight, against float64 autograd of the
    plain layer on the bf16-rounded v and weight.

    K6's output y has the sign of its float32 sum, which is the float64
    pre-activation's wherever that lies beyond the sums' order (64 terms:
    64 * 2^-24 of their summed magnitudes).  Masked by y, g (bf16) takes
    the slope 0.2 rounded once to bf16 (2^-9 relative); K3 sums the 512
    products of each input voxel in float32 and rounds once (2^-9): so
    each element lies within 2^-8 of the summed magnitudes of its
    products of the float64 result with y's mask, and the whole gradient
    within 2^-7 relative L2 of float64 autograd's, whose mask is the
    exact pre-activation's."""
    g = torch.Generator(device).manual_seed(64)
    v = torch.rand((64, 1, 128, 128, 128), generator=g, device=device)
    w = torch.randn((64, 1, 4, 4, 4), generator=g, device=device) * 0.1
    v.requires_grad_(True)
    stem.reset_launches()
    sk.reset_launches()
    y = stem.critic_stem(v, w)
    gy = torch.randn(y.shape, generator=g, device=device).to(torch.bfloat16)
    (got,) = torch.autograd.grad(y, v, gy)
    torch.cuda.synchronize()
    assert stem.launches == {"critic_stem": 1, "critic_stem_backward": 1,
                             "critic_stem_mask": 1}
    assert sk.cube_launches == {(64, 64, 64): 1}
    assert got.dtype == torch.float32 and got.shape == v.shape
    vb, wb = (t.detach().to(torch.bfloat16).double() for t in (v, w))
    with torch.no_grad():
        pre = F.conv3d(vb, wb, None, 2, 1)
        slack = 64 * 2.0 ** -24 * F.conv3d(vb.abs(), wb.abs(), None, 2, 1)
        sure = pre.abs() > slack
        assert bool(((y > 0) == (pre > 0))[sure].all())
        del slack, sure
        g64 = gy.double()
        masked = torch.where(y > 0, g64, 0.2 * g64)
        exact = F.conv_transpose3d(masked, wb, None, 2, 1)
        mag = F.conv_transpose3d(masked.abs(), wb.abs(), None, 2, 1)
        e = (got.double() - exact).abs() - 2.0 ** -8 * mag
        assert float(e.max()) <= 0, float(e.max())
        del masked, exact, mag, e
    vv = vb.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(F.leaky_relu(F.conv3d(vv, wb, None, 2, 1),
                                               0.2), vv, g64)
    err = float((got.double() - want).norm() / want.norm())
    assert err <= 2.0 ** -7, err


@pytest.mark.parametrize("s", [16, 32, 64])
def test_mask_kernel_equals_plain_mask(device, s):
    """The mask kernel on bf16 g and y channels-last (as K7's backward and
    K6 leave them), y with exact zeros, equals ``mask_plain`` bit for bit:
    g where y > 0, 0.2 g rounded once to bf16 elsewhere, written
    channels-first; one launch counted."""
    g = torch.Generator(device).manual_seed(s)
    gy, y = (torch.randn((3, s, s, s, 64), generator=g, device=device)
             .to(torch.bfloat16).permute(0, 4, 1, 2, 3) for _ in range(2))
    y.masked_fill_(y.abs() < 0.05, 0.0)
    stem.reset_launches()
    got = stem._mask_launch(gy, y)
    torch.cuda.synchronize()
    assert stem.launches == {"critic_stem": 0, "critic_stem_backward": 0,
                             "critic_stem_mask": 1}
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, stem.mask_plain(gy, y))


def _step(net, device):
    """One bf16 train step of ``net`` at 64² photos and 32³ voxels, batch
    2, and K3's, K6's and K6's backward launches in it."""
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.base import default_opt
    kw = dict(canon_sup=True, w_gan_loss=1e-3) if net == "shapehd" else \
        dict(canon_voxel=True)
    model = get_model(net)(default_opt(
        device="cuda", dtype="bfloat16", im_size=64, vox_res=32, lr=1e-4,
        no_aug=True, batch_size=2, **kw))
    model.init_state(0)
    g = torch.Generator(device).manual_seed(1)
    batch = {"voxel_canon": (torch.rand((2, 32, 32, 32), generator=g,
                                        device=device) > 0.7).float()}
    if net == "shapehd":
        silhou = (torch.rand((2, 64, 64, 1), generator=g, device=device)
                  > 0.3).float() * 100.0
        batch.update(depth=torch.rand((2, 64, 64, 1), generator=g,
                                      device=device) * 100.0 * silhou / 100,
                     normal=torch.randn((2, 64, 64, 3), generator=g,
                                        device=device) * 30.0,
                     silhou=silhou)
    stem.reset_launches()
    sk.reset_launches()
    terms = model.train_step(batch)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t)) for t in terms.values()), terms
    return dict(stem.launches), dict(sk.cube_launches)


def test_k6_launches_in_a_shapehd_fine_tuning_step(device):
    """A ShapeHD fine-tuning step launches K6 once and its backward once
    (the frozen critic on MarrNet-2's voxels), and K3 twice: the
    decoder's last layer (2, 128, 16³) and the stem's backward (2, 64,
    16³)."""
    launches, k3 = _step("shapehd", device)
    assert launches == {"critic_stem": 1, "critic_stem_backward": 1,
                        "critic_stem_mask": 1}
    assert k3 == {(2, 128, 16): 1, (2, 64, 16): 1}


def test_no_k6_in_a_wgangp_step(device):
    """A WGAN-GP step launches neither K6 nor its backward: its critic
    trains in D's phase and reads bf16 G(z) in G's."""
    launches, _ = _step("wgangp", device)
    assert launches == {"critic_stem": 0, "critic_stem_backward": 0,
                        "critic_stem_mask": 0}
