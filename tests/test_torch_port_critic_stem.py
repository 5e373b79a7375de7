"""PyTorch port, the critic's first layer (``Conv3d(1 -> 64, k4 s2 p1)``,
no bias, and LeakyReLU(0.2); K6 ``critic_stem`` on the card) on the CPU:
the kernel's GEMM formulation against the plain version and against the
JAX package's first critic layer; the predicate that chooses K6 (a CUDA
tensor, bf16 autocast, no gradient recorded for the weight), on fake CUDA
tensors and the real autocast and grad state; the wrapper's refusals; and
the critic's routing of its first layer, under its span.

The kernel itself runs on the card only (``tests/test_torch_port_cuda.py``,
its backward ``tests/test_torch_port_critic_stem_cuda.py``).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from genre_shapehd_tpu.nn import voxel_nets as jvn
from genre_shapehd_tpu_torch import nn as tnn
from genre_shapehd_tpu_torch.core.convert import jax_to_torch
from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as ck
from genre_shapehd_tpu_torch.utils import trace

from _torch_port_util import to_np

torch.set_num_threads(4)


def _voxels(b, r, seed):
    """Occupancy-like probabilities in (0, 1), (b, r, r, r)."""
    return np.random.default_rng(seed).random((b, r, r, r)).astype(
        np.float32)


@pytest.mark.parametrize("r,b", [(32, 1), (32, 3), (64, 1), (64, 2)])
def test_gemm_matches_plain_and_jax(r, b):
    """``critic_stem_gemm`` (each output position's 64 taps times the
    weight, as K6 computes it) against ``critic_stem_plain`` and against
    the JAX package's ``Conv3D(64, 4, 2, 1)`` and ``leaky_relu(0.2)`` on
    its own parameters, in float32: within 1e-5 of the output's scale,
    the summation order of 64 products a sum and nothing else."""
    v = _voxels(b, r, r + b)
    jmod = jvn.Conv3D(64, 4, 2, 1, use_bias=False)
    x = v[..., None]
    params = to_np(jmod.init(jax.random.PRNGKey(r + b), x)["params"])
    ref = np.asarray(jax.nn.leaky_relu(jmod.apply({"params": params}, x),
                                       0.2)).transpose(0, 4, 1, 2, 3)
    layer = tnn.Conv3D(1, 64, 4, 2, 1, use_bias=False)
    layer.load_state_dict(jax_to_torch(params, {}))
    w = layer.Conv_0.weight.detach()
    vt = torch.from_numpy(v)[:, None]
    got = ck.critic_stem_gemm(vt, w)
    plain = ck.critic_stem_plain(vt, w)
    assert got.shape == plain.shape == (b, 64, r // 2, r // 2, r // 2)
    scale = float(np.abs(ref).max())
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * scale
    assert float(np.abs(plain.numpy() - ref).max()) <= 1e-5 * scale


@contextlib.contextmanager
def _cuda_autocast(dtype):
    """Autocast for CUDA set as ``torch.autocast`` sets it (the context
    manager itself turns it off where no card is present), restored on
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


#: (case, device, autocast dtype, grad mode, v needs grad, weight needs
#: grad, v's dtype, R) -> K6 chosen
PREDICATE = {
    "inference_mode": (("cuda", torch.bfloat16, "inference", False, True,
                        torch.float32, 128), True),
    "no_grad": (("cuda", torch.bfloat16, "no_grad", False, True,
                 torch.float32, 128), True),
    "grad_on_frozen_critic": (("cuda", torch.bfloat16, "grad", False, False,
                               torch.float32, 64), True),
    "no_grad_input_needs_grad": (("cuda", torch.bfloat16, "no_grad", True,
                                  True, torch.float32, 32), True),
    "grad_on_wgangp_critic": (("cuda", torch.bfloat16, "grad", False, True,
                               torch.float32, 128), False),
    "grad_on_shapehd_finetune": (("cuda", torch.bfloat16, "grad", True,
                                  False, torch.float32, 128), True),
    "float32_no_autocast": (("cuda", None, "inference", False, True,
                             torch.float32, 128), False),
    "float16_autocast": (("cuda", torch.float16, "inference", False, True,
                          torch.float32, 128), False),
    "cpu": (("cpu", torch.bfloat16, "inference", False, True,
             torch.float32, 128), False),
    "resolution_16": (("cuda", torch.bfloat16, "inference", False, True,
                       torch.float32, 16), False),
    "float64_input": (("cuda", torch.bfloat16, "inference", False, True,
                       torch.float64, 128), False),
    "bfloat16_input": (("cuda", torch.bfloat16, "inference", False, True,
                        torch.bfloat16, 128), False),
}


@pytest.mark.parametrize("case", sorted(PREDICATE))
def test_path_predicate(case):
    """K6 is chosen exactly where v lies on a CUDA device, bf16 autocast
    is on for CUDA and autograd records no gradient for the weight (grad
    off, ``inference_mode``, or a weight that needs none, as in
    ShapeHD's fine-tuning, whose input does), at the shapes it takes and
    on float32 v; the WGAN-GP step (the critic's weight needs a
    gradient), ``--dtype float32`` (no autocast) and the CPU keep
    ``nn.Conv3d``.  CUDA tensors are fake here, the autocast and grad
    state real."""
    (device, autocast, mode, v_grad, w_grad, dtype, r), want = \
        PREDICATE[case]
    grad = {"grad": contextlib.nullcontext(), "no_grad": torch.no_grad(),
            "inference": torch.inference_mode()}[mode]
    with FakeTensorMode():
        v = torch.rand(2, 1, r, r, r, device=device, dtype=dtype,
                       requires_grad=v_grad)
        w = torch.nn.Parameter(torch.rand(64, 1, 4, 4, 4, device=device),
                               requires_grad=w_grad)
        with _cuda_autocast(autocast), grad:
            assert ck.uses_kernel(v, w) is want


@pytest.mark.parametrize("case,shape,wshape,dtype", [
    ("two_channels", (1, 2, 32, 32, 32), (64, 1, 4, 4, 4), torch.float32),
    ("resolution_48", (1, 1, 48, 48, 48), (64, 1, 4, 4, 4), torch.float32),
    ("resolution_256", (1, 1, 256, 256, 256), (64, 1, 4, 4, 4),
     torch.float32),
    ("not_a_cube", (1, 1, 32, 32, 64), (64, 1, 4, 4, 4), torch.float32),
    ("no_channel_axis", (1, 32, 32, 32), (64, 1, 4, 4, 4), torch.float32),
    ("32_outputs", (1, 1, 32, 32, 32), (32, 1, 4, 4, 4), torch.float32),
    ("float16", (1, 1, 32, 32, 32), (64, 1, 4, 4, 4), torch.float16),
    ("float64", (1, 1, 32, 32, 32), (64, 1, 4, 4, 4), torch.float64),
    ("bfloat16", (1, 1, 32, 32, 32), (64, 1, 4, 4, 4), torch.bfloat16),
    ("cpu_tensor", (1, 1, 32, 32, 32), (64, 1, 4, 4, 4), torch.float32)])
def test_wrapper_refuses(case, shape, wshape, dtype):
    """K6's wrapper raises ValueError on what the kernel does not take,
    before any launch: one input channel, R in {32, 64, 128}, a cube, 64
    output channels, float32 v, one CUDA device (a CPU tensor never
    falls back to the plain version); on fake CUDA tensors but the last."""
    device = "cpu" if case == "cpu_tensor" else "cuda"
    ck.reset_launches()
    mode = contextlib.nullcontext() if device == "cpu" else FakeTensorMode()
    with mode, torch.no_grad():
        v = torch.zeros(shape, dtype=dtype, device=device)
        w = torch.zeros(wshape, device=device)
        with pytest.raises(ValueError):
            ck.critic_stem(v, w)
    assert ck.launches == {"critic_stem": 0, "critic_stem_backward": 0,
                           "critic_stem_mask": 0}


def test_wrapper_refuses_a_recorded_gradient():
    """K6 has no backward for its weight: with grad on and the weight
    needing one, the wrapper raises rather than return an output whose
    weight gradient autograd would miss."""
    with FakeTensorMode():
        v = torch.zeros(1, 1, 32, 32, 32, device="cuda")
        w = torch.nn.Parameter(torch.zeros(64, 1, 4, 4, 4, device="cuda"))
        with pytest.raises(ValueError, match="no backward"):
            ck.critic_stem(v, w)


@pytest.mark.parametrize("kernel", [False, True])
def test_critic_routes_its_first_layer_under_its_span(kernel, monkeypatch):
    """``VoxelDiscriminator`` (nf 64, 32³) computes its first layer and
    activation in ``stem``, under ``shapehd.critic.stem`` once a call:
    through K6 where the predicate holds (the kernel stood in here by its
    GEMM formulation), else through ``F.conv3d`` on ``Conv3D_0``'s weight
    and ``F.leaky_relu``;
    the scores agree within 1e-5 of their scale, and the layers after the
    first are the same."""
    torch.manual_seed(3)
    net = tnn.VoxelDiscriminator(64, 32).eval()
    v = torch.from_numpy(_voxels(2, 32, 7))
    with torch.no_grad():
        ref = net(v)
    calls = []

    def stand_in(x, w):
        calls.append(x.shape)
        return ck.critic_stem_gemm(x, w)

    monkeypatch.setattr(ck, "uses_kernel", lambda x, w: kernel)
    monkeypatch.setattr(ck, "critic_stem", stand_in)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        got = net(v)
    spans = [e for e in prof.events() if e.name == trace.CRITIC_STEM]
    assert len(spans) == 1
    assert calls == ([(2, 1, 32, 32, 32)] if kernel else [])
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
