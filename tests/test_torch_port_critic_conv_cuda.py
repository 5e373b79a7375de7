"""PyTorch port, K7 on the card: the critic's middle convolutions
(``critic_conv``, k4 s2 p1, LeakyReLU fused, channels-last) at the four
shapes of the res-128 critic against the plain layer under bf16 autocast
and against float64; their input gradient against float64 autograd; K6's
channels-last output; the whole critic, K6 -> K7 -> the last layer's
product, against the plain critic, its scores and its input gradient; and
K7's launches in a critic call, in a ShapeHD fine-tuning step and in a
WGAN-GP step.  Skipped where ``torch.cuda.is_available()`` is false.

On a machine with a GPU and nvcc:
  python -m pytest --noconftest -m cuda \\
      tests/test_torch_port_critic_conv_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from genre_shapehd_tpu_torch.ops.cuda import critic_conv_kernel as conv
from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as stem

pytestmark = pytest.mark.cuda

CL = torch.channels_last_3d
BF = torch.bfloat16
#: Conv3D_1 .. _4 of the res-128 critic: (Cin, input R, Cout, batch)
LAYERS = {"Conv3D_1": (64, 64, 64, 2), "Conv3D_2": (64, 32, 128, 4),
          "Conv3D_3": (128, 16, 256, 8), "Conv3D_4": (256, 8, 512, 8)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(device, layer, seed):
    cin, r, cout, b = LAYERS[layer]
    g = torch.Generator(device).manual_seed(seed)
    x = torch.rand((b, cin, r, r, r), generator=g, device=device).to(BF)
    w = torch.randn((cout, cin, 4, 4, 4), generator=g, device=device) * 0.05
    return g, x.contiguous(memory_format=CL), w


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_critic_conv_matches_plain(device, layer):
    """K7 against ``critic_conv_plain`` under bf16 autocast (cuDNN's
    convolution and ``F.leaky_relu``) at each middle layer's shape, batch
    2-8.

    K7 rounds the weight to bf16 as autocast does, sums in float32,
    applies the activation to the float32 sum and rounds once: each output
    lies within one bf16 rounding (2^-8 relative) of the float64 result on
    the rounded inputs, with room for the float32 sums' order (64 Cin
    terms: 64 Cin * 2^-24 of their summed magnitudes).  The plain path
    rounds twice, so the two lie within two bf16 steps (2^-6 relative) of
    each other.  The output is channels-last, one launch."""
    cin = LAYERS[layer][0]
    _, x, w = _layer(device, layer, cin)
    conv.reset_launches()
    with torch.inference_mode():
        out = conv.critic_conv(x, w)
        torch.cuda.synchronize()
        assert conv.launches == {"critic_conv": 1, "critic_conv_backward": 0}
        assert out.dtype == BF and out.is_contiguous(memory_format=CL)
        with torch.autocast("cuda", dtype=BF):
            plain = conv.critic_conv_plain(x, w)
        assert out.shape == plain.shape
        xd, wd = x.double(), w.to(BF).double()
        exact = F.leaky_relu(F.conv3d(xd, wd, None, 2, 1), 0.2)
        slack = 64 * cin * 2.0 ** -24 * F.conv3d(xd.abs(), wd.abs(), None,
                                                 2, 1)
        got, plain = out.double(), plain.double()
        e = (got - exact).abs() - (2.0 ** -8 * exact.abs() + slack)
        assert float(e.max()) <= 0, float(e.max())
        d = (got - plain).abs() - (2.0 ** -6 * torch.maximum(
            got.abs(), plain.abs()) + 2 * slack)
        assert float(d.max()) <= 0, float(d.max())


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_critic_conv_backward_matches_autograd(device, layer):
    """x's gradient through K7's backward (the activation's slope by the
    sign of K7's output, then cuDNN's transposed convolution on
    channels-last bf16 tensors) against float64 autograd of the plain
    layer on the bf16-rounded x and weight: within 2^-7 relative L2 (0.2 g
    rounded once to bf16, the sums rounded once, the masks of K7's
    rounded output), channels-last, one launch each way."""
    g, x, w = _layer(device, layer, 7)
    x.requires_grad_(True)
    conv.reset_launches()
    y = conv.critic_conv(x, w)
    gy = torch.randn(y.shape, generator=g, device=device).to(BF)
    (got,) = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert conv.launches == {"critic_conv": 1, "critic_conv_backward": 1}
    assert got.dtype == BF and got.is_contiguous(memory_format=CL)
    xd = x.detach().double().requires_grad_(True)
    (want,) = torch.autograd.grad(F.leaky_relu(F.conv3d(
        xd, w.to(BF).double(), None, 2, 1), 0.2), xd, gy.double())
    err = float((got.double() - want).norm() / want.norm())
    assert err <= 2.0 ** -7, err


def test_k6_writes_channels_last(device):
    """K6's output is (B, 64, S, S, S) in ``channels_last_3d``, each value
    within one bf16 rounding of the float64 result (the arithmetic of its
    channels-first output before, which its store alone changed); its
    channels-first copy equals the stem's plain version within two bf16
    steps."""
    g = torch.Generator(device).manual_seed(11)
    v = torch.rand((4, 1, 128, 128, 128), generator=g, device=device)
    w = torch.randn((64, 1, 4, 4, 4), generator=g, device=device) * 0.1
    with torch.inference_mode():
        out = stem.critic_stem(v, w)
        assert out.is_contiguous(memory_format=CL) and not out.is_contiguous()
        vb, wb = v.to(BF).double(), w.to(BF).double()
        exact = F.leaky_relu(F.conv3d(vb, wb, None, 2, 1), 0.2)
        slack = 64 * 2.0 ** -24 * F.conv3d(vb.abs(), wb.abs(), None, 2, 1)
        got = out.contiguous().double()
        e = (got - exact).abs() - (2.0 ** -8 * exact.abs() + slack)
        assert float(e.max()) <= 0, float(e.max())
        with torch.autocast("cuda", dtype=BF):
            plain = stem.critic_stem_plain(v, w).double()
        d = (got - plain).abs() - (2.0 ** -6 * torch.maximum(
            got.abs(), plain.abs()) + 2 * slack)
        assert float(d.max()) <= 0, float(d.max())


def _critic(device, seed=4):
    from genre_shapehd_tpu_torch.nn import VoxelDiscriminator
    from genre_shapehd_tpu_torch.nn.init import init_weights
    net = VoxelDiscriminator(64, 128).eval()
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(device)


def test_whole_critic_on_k6_and_k7_against_cudnn(device):
    """The critic (nf 64, 128³, batch 4) under bf16 autocast on
    probabilities: K6 -> K7 x 4 -> the last layer's product, channels-last
    throughout (inference mode), against the cuDNN path (grad on, the
    weights needing a gradient): each score's difference over the summed
    magnitudes of the last layer's products within the benchmark's
    ``critic`` limit, 3.3e-4; one K6 and four K7 launches, none with grad
    on."""
    net = _critic(device)
    g = torch.Generator(device).manual_seed(6)
    v = torch.rand((4, 128, 128, 128), generator=g, device=device)
    seen = []
    hook = net.Conv3D_5.register_forward_hook(
        lambda m, a, o: seen.append(a[0]))
    stem.reset_launches()
    conv.reset_launches()
    with torch.autocast("cuda", dtype=BF):
        with torch.inference_mode():
            fast = net(v)
        torch.cuda.synchronize()
        assert conv.launches == {"critic_conv": 4, "critic_conv_backward": 0}
        assert stem.launches == {"critic_stem": 1, "critic_stem_backward": 0,
                                 "critic_stem_mask": 0}
        ref = net(v)
        torch.cuda.synchronize()
    hook.remove()
    assert conv.launches == {"critic_conv": 4, "critic_conv_backward": 0}
    assert seen[0].is_contiguous(memory_format=CL)
    assert seen[1].is_contiguous()
    w = net.Conv3D_5.Conv_0.weight.detach()
    with torch.no_grad():
        scale = F.conv3d(seen[1].detach().float().abs(), w.abs()).reshape(-1)
        err = (fast.float() - ref.detach().float()).abs() / scale
    assert float(err.max()) <= 3.3e-4, err.tolist()


def test_whole_critic_input_gradient_against_cudnn(device):
    """The frozen critic's input gradient, as ShapeHD's fine-tuning takes
    it (bf16 autocast, weights with no gradient: K6 and K7 both ways),
    against the same critic on the plain layers (cuDNN both ways, the
    weights needing a gradient), each against float64 autograd of the
    plain critic on the bf16-rounded weights: K7's path no further from
    float64 than 1.25 times the plain path, and both within the
    benchmark's ``critic_grad`` limit (0.22, relative L2)."""
    net = _critic(device, 5)
    g = torch.Generator(device).manual_seed(8)
    v = torch.rand((2, 128, 128, 128), generator=g, device=device)

    def grad(v, train_weights):
        net.requires_grad_(train_weights)
        vv = v.clone().requires_grad_(True)
        with torch.autocast("cuda", dtype=BF):
            score = net(vv)
        (gv,) = torch.autograd.grad(score.float().sum(), vv)
        return gv

    stem.reset_launches()
    conv.reset_launches()
    fast = grad(v, False)
    torch.cuda.synchronize()
    assert conv.launches == {"critic_conv": 4, "critic_conv_backward": 4}
    assert stem.launches == {"critic_stem": 1, "critic_stem_backward": 1,
                             "critic_stem_mask": 1}
    plain = grad(v, True)
    assert conv.launches == {"critic_conv": 4, "critic_conv_backward": 4}
    net64 = _critic(device, 5).double()
    with torch.no_grad():
        for p in net64.parameters():
            p.copy_(p.to(BF).double())
    vv = v.double().requires_grad_(True)
    (want,) = torch.autograd.grad(net64(vv).sum(), vv)
    errs = [float((x.double() - want).norm() / want.norm())
            for x in (fast, plain)]
    assert errs[0] <= 1.25 * errs[1] and max(errs) <= 0.22, errs


def _step(net, device):
    """One bf16 train step of ``net`` at 64² photos and 32³ voxels, batch
    2, and K7's launches in it."""
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
                                      device=device) * silhou,
                     normal=torch.randn((2, 64, 64, 3), generator=g,
                                        device=device) * 30.0,
                     silhou=silhou)
    conv.reset_launches()
    terms = model.train_step(batch)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t)) for t in terms.values()), terms
    return dict(conv.launches)


def test_k7_launches_in_a_shapehd_fine_tuning_step(device):
    """A ShapeHD fine-tuning step at 32³ launches K7 on the frozen
    critic's two middle layers (64 -> 128, 128 -> 256) once each way."""
    assert _step("shapehd", device) == {"critic_conv": 2,
                                        "critic_conv_backward": 2}


def test_no_k7_in_a_wgangp_step(device):
    """A WGAN-GP step launches no K7: its critic's weights train (and its
    gradient penalty takes a double backward), so it keeps nn.Conv3d."""
    assert _step("wgangp", device) == {"critic_conv": 0,
                                       "critic_conv_backward": 0}
