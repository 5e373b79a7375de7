"""PyTorch port, the critic's middle convolutions (``Conv3d(Cin -> Cout, k4
s2 p1)``, no bias, and LeakyReLU(0.2); K7 ``critic_conv`` on the card) on
the CPU: the kernel's GEMM formulation against the plain version and
against the JAX package's layer at the four shapes of the res-128 critic;
the predicate that chooses K7 (a CUDA tensor, bf16 autocast, no gradient
recorded for the weight, channels in multiples of 64), on fake CUDA
tensors and the real autocast and grad state; the wrapper's refusals; the
backward's formulation and its ``autograd.Function``; the critic's routing
of its body, channels-last to the last layer, under its span; and the
critic's CPU output, bit for bit the layers it always ran.

The kernel itself runs on the card only
(``tests/test_torch_port_critic_conv_cuda.py``).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from genre_shapehd_tpu.nn import voxel_nets as jvn
from genre_shapehd_tpu_torch import nn as tnn
from genre_shapehd_tpu_torch.core.convert import jax_to_torch
from genre_shapehd_tpu_torch.ops.cuda import critic_conv_kernel as ck
from genre_shapehd_tpu_torch.utils import trace

from _torch_port_util import to_np

torch.set_num_threads(4)

#: the res-128 critic's Conv3D_1 .. _4 (Cin, Cout) at a small grid and batch
LAYERS = {"Conv3D_1": (64, 64, 16), "Conv3D_2": (64, 128, 16),
          "Conv3D_3": (128, 256, 8), "Conv3D_4": (256, 512, 8)}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_gemm_matches_plain_and_jax(layer):
    """``critic_conv_gemm`` (each output position's 64 taps x Cin channels,
    tap-major over NDHWC, times the weight, as K7 computes it) against
    ``critic_conv_plain`` and against the JAX package's ``Conv3D(Cout, 4,
    2, 1)`` and ``leaky_relu(0.2)`` on its own parameters, in float32 at
    batch 2: within 1e-5 of the output's scale, the summation order of
    64 Cin products a sum and nothing else."""
    cin, cout, r = LAYERS[layer]
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, r, r, r, cin)).astype(np.float32)
    jmod = jvn.Conv3D(cout, 4, 2, 1, use_bias=False)
    params = to_np(jmod.init(jax.random.PRNGKey(cout), x)["params"])
    ref = np.asarray(jax.nn.leaky_relu(jmod.apply({"params": params}, x),
                                       0.2)).transpose(0, 4, 1, 2, 3)
    mod = tnn.Conv3D(cin, cout, 4, 2, 1, use_bias=False)
    mod.load_state_dict(jax_to_torch(params, {}))
    w = mod.Conv_0.weight.detach()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = ck.critic_conv_gemm(xt, w)
    plain = ck.critic_conv_plain(xt, w)
    assert got.shape == plain.shape == (2, cout, r // 2, r // 2, r // 2)
    scale = float(np.abs(ref).max())
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * scale
    assert float(np.abs(plain.numpy() - ref).max()) <= 1e-5 * scale


@contextlib.contextmanager
def _cuda_autocast(dtype):
    """Autocast for CUDA set as ``torch.autocast`` sets it, restored on
    leaving; ``dtype`` None leaves it off."""
    prev = torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda")
    torch.set_autocast_enabled("cuda", dtype is not None)
    if dtype is not None:
        torch.set_autocast_dtype("cuda", dtype)
    try:
        yield
    finally:
        torch.set_autocast_enabled("cuda", prev[0])
        torch.set_autocast_dtype("cuda", prev[1])


#: (case, device, autocast dtype, grad mode, x needs grad, weight needs
#: grad, x's dtype, Cin, Cout, R) -> K7 chosen
PREDICATE = {
    "inference_mode": (("cuda", torch.bfloat16, "inference", False, True,
                        torch.bfloat16, 64, 64, 64), True),
    "no_grad": (("cuda", torch.bfloat16, "no_grad", False, True,
                 torch.bfloat16, 128, 256, 16), True),
    "grad_on_frozen_critic": (("cuda", torch.bfloat16, "grad", True, False,
                               torch.bfloat16, 64, 128, 32), True),
    "float32_input_under_autocast": (("cuda", torch.bfloat16, "inference",
                                      False, True, torch.float32, 256, 512,
                                      8), False),
    "grad_on_wgangp_critic": (("cuda", torch.bfloat16, "grad", False, True,
                               torch.bfloat16, 64, 64, 64), False),
    "float32_no_autocast": (("cuda", None, "inference", False, True,
                             torch.float32, 64, 64, 64), False),
    "float16_autocast": (("cuda", torch.float16, "inference", False, True,
                          torch.float16, 64, 64, 64), False),
    "cpu": (("cpu", torch.bfloat16, "inference", False, True,
             torch.bfloat16, 64, 64, 64), False),
    "cin_32": (("cuda", torch.bfloat16, "inference", False, True,
                torch.bfloat16, 32, 64, 64), False),
    "cout_96": (("cuda", torch.bfloat16, "inference", False, True,
                 torch.bfloat16, 64, 96, 64), False),
    "grid_4": (("cuda", torch.bfloat16, "inference", False, True,
                torch.bfloat16, 256, 512, 4), False),
}


@pytest.mark.parametrize("case", sorted(PREDICATE))
def test_path_predicate(case):
    """K7 is chosen exactly where x lies on a CUDA device, bf16 autocast is
    on for CUDA and autograd records no gradient for the weight (grad
    off, ``inference_mode``, or a frozen weight, as in ShapeHD's
    fine-tuning), with channels in multiples of 64 and output extents of
    at least 4; the WGAN-GP step (the weight needs a gradient), ``--dtype
    float32`` (no autocast), float16 autocast and the CPU keep
    ``nn.Conv3d``, and so does a float32 x under autocast: K7 reads only
    K6's and its own bf16 outputs.  CUDA tensors are fake here, the
    autocast and grad state real."""
    (device, autocast, mode, x_grad, w_grad, dtype, cin, cout, r), want = \
        PREDICATE[case]
    grad = {"grad": contextlib.nullcontext(), "no_grad": torch.no_grad(),
            "inference": torch.inference_mode()}[mode]
    with FakeTensorMode():
        x = torch.rand(2, cin, r, r, r, device=device, dtype=dtype,
                       requires_grad=x_grad)
        w = torch.nn.Parameter(torch.rand(cout, cin, 4, 4, 4, device=device),
                               requires_grad=w_grad)
        with _cuda_autocast(autocast), grad:
            assert ck.uses_kernel(x, w) is want


@pytest.mark.parametrize("case,shape,wshape,dtype", [
    ("cin_48", (1, 48, 16, 16, 16), (64, 48, 4, 4, 4), torch.bfloat16),
    ("cout_32", (1, 64, 16, 16, 16), (32, 64, 4, 4, 4), torch.bfloat16),
    ("odd_grid", (1, 64, 15, 16, 16), (64, 64, 4, 4, 4), torch.bfloat16),
    ("grid_6", (1, 64, 6, 6, 6), (64, 64, 4, 4, 4), torch.bfloat16),
    ("kernel_3", (1, 64, 16, 16, 16), (64, 64, 3, 3, 3), torch.bfloat16),
    ("channels_apart", (1, 64, 16, 16, 16), (64, 128, 4, 4, 4),
     torch.bfloat16),
    ("no_channel_axis", (64, 16, 16, 16), (64, 64, 4, 4, 4),
     torch.bfloat16),
    ("float16", (1, 64, 16, 16, 16), (64, 64, 4, 4, 4), torch.float16),
    ("float32", (1, 64, 16, 16, 16), (64, 64, 4, 4, 4), torch.float32),
    ("cpu_tensor", (1, 64, 16, 16, 16), (64, 64, 4, 4, 4), torch.bfloat16)])
def test_wrapper_refuses(case, shape, wshape, dtype):
    """K7's wrapper raises ValueError on what the kernel does not take,
    before any launch: channels in multiples of 64, even extents of at
    least 8, a k4 weight whose input channels are x's, bf16 x,
    one CUDA device (a CPU tensor never falls back to the plain version);
    on fake CUDA tensors but the last."""
    device = "cpu" if case == "cpu_tensor" else "cuda"
    ck.reset_launches()
    mode = contextlib.nullcontext() if device == "cpu" else FakeTensorMode()
    with mode, torch.no_grad():
        x = torch.zeros(shape, dtype=dtype, device=device)
        w = torch.zeros(wshape, device=device)
        with pytest.raises(ValueError):
            ck.critic_conv(x, w)
    assert ck.launches == {"critic_conv": 0, "critic_conv_backward": 0}


def test_wrapper_refuses_a_recorded_gradient():
    """K7 has no backward for its weight: with grad on and the weight
    needing one, the wrapper raises rather than return an output whose
    weight gradient autograd would miss."""
    with FakeTensorMode():
        x = torch.zeros(1, 64, 16, 16, 16, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.nn.Parameter(torch.zeros(64, 64, 4, 4, 4, device="cuda"))
        with pytest.raises(ValueError, match="no backward"):
            ck.critic_conv(x, w)


@pytest.mark.parametrize("layer", ["Conv3D_1", "Conv3D_4"])
def test_input_grad_matches_autograd(layer):
    """``input_grad`` (the output's gradient masked by the sign of the
    output, then ``aten.convolution_backward`` for the input alone)
    against autograd of ``critic_conv_plain`` with respect to x, in
    float64 on channels-last tensors: within 1e-12 of the gradient's
    scale."""
    cin, cout, r = LAYERS[layer]
    g = torch.Generator().manual_seed(cin)
    cl = torch.channels_last_3d
    x = torch.randn(2, cin, r, r, r, dtype=torch.float64, generator=g)
    x = x.contiguous(memory_format=cl).requires_grad_(True)
    w = torch.randn(cout, cin, 4, 4, 4, dtype=torch.float64,
                    generator=g) * 0.05
    y = ck.critic_conv_plain(x, w)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    (want,) = torch.autograd.grad(y, x, gy)
    got = ck.input_grad(gy.contiguous(memory_format=cl),
                        y.detach().contiguous(memory_format=cl),
                        x.detach(), w.contiguous(memory_format=cl))
    assert bool((y < 0).any()) and bool((y > 0).any())
    assert got.shape == x.shape
    err = float((got - want).abs().max())
    assert err <= 1e-12 * float(want.abs().max())


def test_autograd_function_gives_x_its_gradient(monkeypatch):
    """K7's ``autograd.Function`` with the kernel stood in by its
    formulation (rounded to bf16 as it writes it): the output
    channels-last, x's gradient bf16 as x is, within two bf16 roundings
    of the plain layer's in float32, the weight none, one launch each way
    counted."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 64, 16, 16, 16, generator=g)
    x = x.to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(128, 64, 4, 4, 4, generator=g) * 0.05
    monkeypatch.setattr(ck, "takes", lambda x, w: True)

    def stand_in(xb, wk):
        ck.launches["critic_conv"] += 1
        cout = wk.shape[0]
        wt = wk.float().reshape(cout, 4, 4, 4, -1).permute(0, 4, 1, 2, 3)
        return ck.critic_conv_gemm(xb.float(), wt).to(torch.bfloat16)

    monkeypatch.setattr(ck, "_launch", stand_in)
    ck.reset_launches()
    y = ck.critic_conv(x, w)
    assert y.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    gy = torch.randn(y.shape, generator=g).to(torch.bfloat16)
    (got,) = torch.autograd.grad(y, x, gy)
    assert ck.launches == {"critic_conv": 1, "critic_conv_backward": 1}
    xx = x.detach().float().requires_grad_(True)
    (want,) = torch.autograd.grad(
        ck.critic_conv_plain(xx, w.to(torch.bfloat16).float()), xx,
        gy.float())
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    err = float((got.float() - want).norm() / want.norm())
    assert err <= 2 * 2.0 ** -8, err


def _old_forward(net, v):
    """The critic as it ran before K7: the plain first layer, each middle
    convolution and its activation, the last convolution, NCDHW."""
    x = F.leaky_relu(F.conv3d(v[:, None], net.Conv3D_0.Conv_0.weight, None,
                              2, 1), 0.2)
    for i in range(1, net.n_mid):
        x = F.leaky_relu(getattr(net, f"Conv3D_{i}")(x), 0.2)
    return getattr(net, f"Conv3D_{net.n_mid}")(x).reshape(v.shape[0])


@pytest.mark.parametrize("res", [32, 64])
def test_critic_cpu_output_unchanged(res):
    """On the CPU (and wherever K7 does not run) ``VoxelDiscriminator``
    computes its scores bit for bit as before: ``F.conv3d`` and
    ``F.leaky_relu`` layer by layer, NCDHW, the last layer ``nn.Conv3d``;
    so does its input gradient."""
    torch.manual_seed(res)
    net = tnn.VoxelDiscriminator(64, res).eval()
    v = torch.rand(2, res, res, res, requires_grad=True)
    got = net(v)
    want = _old_forward(net, v)
    assert torch.equal(got, want)
    (gg,) = torch.autograd.grad(got.sum(), v)
    (gw,) = torch.autograd.grad(want.sum(), v)
    assert torch.equal(gg, gw)


@pytest.mark.parametrize("k6", [True, False])
@pytest.mark.parametrize("res", [32, 64])
def test_critic_routes_its_body_to_k7_under_its_span(res, k6, monkeypatch):
    """``VoxelDiscriminator`` (nf 64) computes its middle layers and its
    last one in ``body``, under ``shapehd.critic.body`` once a call,
    beside ``shapehd.critic.stem``.  Where the stem runs K6 (stood in
    here, channels-last, by its GEMM formulation), the middle layers run
    K7 (stood in by its formulation; K7's own predicate held true), each
    on the channels-last output of the one before, and the last layer is
    one product of the channels-last input: no ``F.conv3d`` at all.
    Where the stem does not run K6 (a critic whose weights train, or that
    scores bf16 voxels, as WGAN-GP's G phase does), no layer runs K7,
    whatever K7's predicate says.  The scores agree with the plain
    critic's within 1e-5 of their scale."""
    from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as sk6
    torch.manual_seed(3)
    net = tnn.VoxelDiscriminator(64, res).eval()
    v = torch.rand(2, res, res, res)
    with torch.no_grad():
        ref = net(v)
    calls, heads = [], []

    def stand_in(x, w):
        calls.append((tuple(x.shape), tuple(w.shape),
                      x.is_contiguous(memory_format=torch.channels_last_3d)))
        return ck.critic_conv_gemm(x, w)

    def stem_stand_in(x, w):
        out = sk6.critic_stem_gemm(x, w)
        return out.contiguous(memory_format=torch.channels_last_3d)

    monkeypatch.setattr(sk6, "uses_kernel", lambda x, w: k6)
    monkeypatch.setattr(sk6, "critic_stem", stem_stand_in)
    monkeypatch.setattr(ck, "uses_kernel", lambda x, w: True)
    monkeypatch.setattr(ck, "critic_conv", stand_in)
    head = getattr(net, f"Conv3D_{net.n_mid}")
    hook = head.register_forward_hook(lambda m, a, o: heads.append(
        a[0].is_contiguous(memory_format=torch.channels_last_3d)))
    conv_shapes = []
    monkeypatch.setattr(F, "conv3d", _counting(F.conv3d, conv_shapes))
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        got = net(v)
    hook.remove()
    names = [e.name for e in prof.events()]
    assert names.count(trace.CRITIC_BODY) == 1
    assert names.count(trace.CRITIC_STEM) == 1
    widths = [64 * m for m in tnn.VoxelDiscriminator.WIDTHS[res]]
    shapes, r = [], res // 2
    for cin, cout in zip(widths[:-1], widths[1:]):
        shapes.append(((2, cin, r, r, r), (cout, cin, 4, 4, 4)))
        r //= 2
    if k6:
        assert calls == [s + (True,) for s in shapes]
        assert heads == [True] and conv_shapes == []
    else:
        assert calls == [] and heads == [False]
        assert conv_shapes == [(64, 1, 4, 4, 4)] + [
            w for _, w in shapes] + [(1, widths[-1], 4, 4, 4)]
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


def _counting(fn, seen):
    def conv3d(x, w, *args, **kw):
        seen.append(tuple(w.shape))
        return fn(x, w, *args, **kw)
    return conv3d
