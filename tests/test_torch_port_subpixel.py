"""PyTorch port, the final deconv (dec6 of the 3D U-Net): the port's
``deconv_final`` -- on the CPU its plain version, the arithmetic the CUDA
kernel K3 repeats -- against the JAX package's Pallas path
(``_final_fwd`` in interpret mode), its XLA twin ``_final_ref_xla`` and
the Flax layer, on the same seeded inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from genre_shapehd_tpu.nn.voxel_nets import Deconv3D as FlaxDeconv3D
from genre_shapehd_tpu.ops.pallas.subpixel_kernel import (
    _final_fwd, _final_ref_xla)
from genre_shapehd_tpu_torch.core.convert import jax_to_torch
from genre_shapehd_tpu_torch.nn.voxel_nets import Deconv3D
from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk

from _torch_port_util import flax_kernel_to_wcat

torch.set_num_threads(2)


def _inputs(b, s, cin, seed):
    """x (B,S,S,S,Cin), Flax kernel (4,4,4,Cin,1), bias (1,), float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, s, cin)).astype(np.float32)
    kernel = (rng.standard_normal((4, 4, 4, cin, 1)) * 0.2).astype(np.float32)
    bias = rng.standard_normal((1,)).astype(np.float32)
    return x, kernel, bias


def _port(x, kernel, bias, dtype=torch.float32):
    """The port's layer on the Flax parameters (taps flipped by
    ``jax_to_torch``), channel-last in and out like the JAX functions."""
    layer = Deconv3D(x.shape[-1], 1, 4, 2, 1)
    layer.load_state_dict(jax_to_torch(
        {"ConvTranspose_0": {"kernel": kernel, "bias": bias}}, {}))
    assert layer.final
    with torch.no_grad():
        out = layer(torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(dtype))
    assert out.shape[1] == 1 and out.dtype == dtype
    return out[:, 0].float().numpy()


@pytest.mark.parametrize("b,s,cin", [(2, 4, 3), (1, 6, 5), (1, 7, 4),
                                     (2, 1, 3), (1, 6, 1), (1, 66, 2)])
def test_deconv_final_matches_pallas_and_xla_f32(b, s, cin):
    """float32 at the shapes K3's CUDA-core kernel takes as edges: odd S,
    S = 1, Cin = 1 and S > 64 (more than one tile along k)."""
    x, kernel, bias = _inputs(b, s, cin, seed=s)
    wcat = flax_kernel_to_wcat(kernel)
    got = _port(x, kernel, bias)
    ref_pallas = np.asarray(_final_fwd(jnp.asarray(x), jnp.asarray(wcat),
                                       jnp.asarray(bias), interpret=True))
    ref_xla = np.asarray(_final_ref_xla(jnp.asarray(x), jnp.asarray(wcat),
                                        jnp.asarray(bias)))
    assert got.shape == ref_xla.shape == (b, 2 * s, 2 * s, 2 * s)
    # float32, summation order only: 1e-5 of the output's scale
    scale = float(np.abs(ref_xla).max())
    assert np.abs(got - ref_pallas).max() <= 1e-5 * scale
    assert np.abs(got - ref_xla).max() <= 1e-5 * scale


def test_deconv_final_matches_flax_layer_f32():
    """The same parameters through the Flax ``Deconv3D`` (the subpixel
    path the JAX U-Net runs)."""
    x, kernel, bias = _inputs(2, 5, 7, seed=11)
    ref = np.asarray(FlaxDeconv3D(1, 4, 2, 1).apply(
        {"params": {"ConvTranspose_0": {"kernel": kernel, "bias": bias}}},
        jnp.asarray(x)))[..., 0]
    got = _port(x, kernel, bias)
    assert np.abs(got - ref).max() <= 1e-5 * float(np.abs(ref).max())


@pytest.mark.parametrize("cin", [3, 7, 40])
@pytest.mark.parametrize("s", [5, 9, 16])
def test_pack_weight_gemm_matches_conv_transpose_and_xla(cin, s):
    """The tensor-core kernel's formulation: ``pack_weight``'s (27,
    Cin_pad, 8) weight contracted with the 27 shifted views of the padded
    input, phases interleaved, equals ``F.conv_transpose3d`` and the JAX
    ``_final_ref_xla`` in float32."""
    x, kernel, bias = _inputs(1, s, cin, seed=100 * cin + s)
    state = jax_to_torch({"ConvTranspose_0": {"kernel": kernel,
                                              "bias": bias}}, {})
    w, bt = state["ConvTranspose_0.weight"], state["ConvTranspose_0.bias"]
    packed = sk.pack_weight(w)
    assert packed.shape == (27, -(-cin // 16) * 16, 8)
    # every phase reads 8 of the 27 offsets, one tap each; padding is zero
    assert int((packed[:, :cin] != 0).sum()) == 64 * cin
    assert not packed[:, cin:].any()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    got = sk.deconv_final_gemm(xt, w, bt)[:, 0].numpy()
    ref_torch = F.conv_transpose3d(xt, w, bt, stride=2, padding=1)[:, 0]
    ref_xla = np.asarray(_final_ref_xla(
        jnp.asarray(x), jnp.asarray(flax_kernel_to_wcat(kernel)),
        jnp.asarray(bias)))
    scale = float(np.abs(ref_xla).max())
    # float32, summation order only: 1e-5 of the output's scale
    assert np.abs(got - ref_torch.numpy()).max() <= 1e-5 * scale
    assert np.abs(got - ref_xla).max() <= 1e-5 * scale


def test_deconv_final_bf16_within_one_output_rounding():
    x, kernel, bias = _inputs(2, 4, 6, seed=5)
    bf = jnp.bfloat16
    wcat = flax_kernel_to_wcat(kernel)
    ref = np.asarray(_final_fwd(
        jnp.asarray(x, bf), jnp.asarray(wcat, bf), jnp.asarray(bias),
        interpret=True).astype(jnp.float32))
    got = _port(x, kernel, bias, torch.bfloat16)
    exact = _port(np.array(jnp.asarray(x, bf).astype(jnp.float32)),
                  np.array(jnp.asarray(kernel, bf).astype(jnp.float32)),
                  bias)
    scale = float(np.abs(exact).max())
    # bf16 keeps 8 bits: one rounding of the output is 2^-8 of its scale.
    # The port (inputs rounded, float32 accumulation, one rounding) stays
    # within that of the exact result; the Pallas path rounds the phase
    # tensor once more before the bias, so the two differ by two roundings
    assert np.abs(got - exact).max() <= 2.0 ** -8 * scale
    assert np.abs(got - ref).max() <= 2.0 ** -7 * scale
    assert np.abs(got - ref).mean() <= 2.0 ** -9 * scale


def test_deconv_final_gradient_matches_jax_vjp():
    """The port's gradient against the VJP that ``deconv_final_fused``
    attaches: autograd of the plain version (the CPU path), and
    ``deconv_final_backward`` (the CUDA path's backward)."""
    x, kernel, bias = _inputs(1, 3, 4, seed=7)
    wcat = flax_kernel_to_wcat(kernel)
    g = np.random.default_rng(8).standard_normal((1, 6, 6, 6)).astype(
        np.float32)
    # ``_df_bwd`` is jax.vjp of the XLA twin (its forward compiles for the
    # TPU only), so the twin's VJP is the reference
    _, vjp = jax.vjp(_final_ref_xla, jnp.asarray(x), jnp.asarray(wcat),
                     jnp.asarray(bias))
    gx_ref, gw_ref, gb_ref = (np.asarray(t) for t in vjp(jnp.asarray(g)))

    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    xt.requires_grad_()
    state = jax_to_torch({"ConvTranspose_0": {"kernel": kernel,
                                              "bias": bias}}, {})
    w = state["ConvTranspose_0.weight"].clone().requires_grad_()
    bt = state["ConvTranspose_0.bias"].clone().requires_grad_()
    out = sk.deconv_final(xt, w, bt)
    out.backward(torch.from_numpy(g)[:, None])
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(), gx_ref,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), gb_ref, rtol=1e-4, atol=1e-4)
    # weight gradient in the wcat layout: torch (Cin,1,kd,kh,kw) -> flax
    # kernel (taps flipped) -> wcat
    gk = np.flip(w.grad.numpy(), (2, 3, 4)).transpose(2, 3, 4, 0, 1)
    np.testing.assert_allclose(flax_kernel_to_wcat(gk), gw_ref, rtol=1e-4,
                               atol=1e-4)
    gx, gw, gb = sk.deconv_final_backward(
        torch.from_numpy(g)[:, None], xt.detach(), w.detach())
    np.testing.assert_allclose(gx.permute(0, 2, 3, 4, 1).numpy(), gx_ref,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), gb_ref, rtol=1e-4, atol=1e-4)
    gk = np.flip(gw.numpy(), (2, 3, 4)).transpose(2, 3, 4, 0, 1)
    np.testing.assert_allclose(flax_kernel_to_wcat(gk), gw_ref, rtol=1e-4,
                               atol=1e-4)
    assert sk.deconv_final_backward(torch.from_numpy(g)[:, None], xt.detach(),
                                    w.detach(), (True, False, False))[1:] \
        == (None, None)


def test_deconv_final_rejects_what_the_kernel_does_not_take():
    """A cube, a box and a Z slab pass; x not 5-D, a Z range past x's or
    from a position other than 0 or 1, a weight of more than one output
    channel and a bias of more than one value raise."""
    x = torch.zeros(1, 3, 4, 4, 4)
    w, b = torch.zeros(3, 1, 4, 4, 4), torch.zeros(1)
    assert sk.deconv_final(x, w, b).shape == (1, 1, 8, 8, 8)
    assert sk.deconv_final(torch.zeros(1, 3, 4, 6, 5), w, b).shape == \
        (1, 1, 8, 12, 10)
    assert sk.deconv_final(torch.zeros(1, 3, 4, 4, 8), w, b, 1, 5).shape \
        == (1, 1, 8, 8, 10)
    for args in ((torch.zeros(3, 4, 4, 4), w, b),
                 (torch.zeros(1, 3, 4, 4, 5), w, b, 1, 5),
                 (torch.zeros(1, 3, 4, 4, 8), w, b, 2, 4),
                 (torch.zeros(1, 3, 4, 4, 8), w, b, 0, 0)):
        with pytest.raises(ValueError):
            sk.deconv_final(*args)
    with pytest.raises(ValueError):
        sk.deconv_final(x, torch.zeros(3, 2, 4, 4, 4), b)
    with pytest.raises(ValueError):
        sk.deconv_final(x, w, torch.zeros(2))
    # only the one-channel k4 s2 p1 layer is routed to the kernel
    assert not Deconv3D(3, 2, 4, 2, 1).final
    assert not Deconv3D(3, 1, 8, 2, 3).final


@pytest.mark.parametrize("shape,z_lo,z_out", [
    ((2, 40, 8, 8, 10), 1, 8),          # dec6's slab: a halo plane a side
    ((1, 7, 5, 6, 16), 1, 10),          # zero planes after the halo
    ((2, 3, 4, 3, 9), 0, 9),            # a box
    ((1, 5, 3, 3, 12), 0, 5)])          # the first planes of a box
def test_deconv_final_on_a_z_slab_matches_the_cropped_layer(shape, z_lo,
                                                           z_out):
    """K3's function on a Z slab, on the CPU: the plain version (what
    ``deconv_final`` runs on a CPU tensor), the kernel's GEMM formulation
    and ``deconv_final_backward`` against ``F.conv_transpose3d`` over the
    whole x, its output planes 2 z_lo .. 2 (z_lo + z_out) - 1 kept, and
    autograd through that crop (float64: 1e-12 of the scale)."""
    g = torch.Generator().manual_seed(sum(shape) + z_lo)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    w = torch.randn((shape[1], 1, 4, 4, 4), generator=g,
                    dtype=torch.float64)
    bias = torch.randn((1,), generator=g, dtype=torch.float64)
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, bias))
    ref = F.conv_transpose3d(xr, wr, br, stride=2, padding=1)[
        ..., 2 * z_lo:2 * (z_lo + z_out)]
    assert ref.shape == (shape[0], 1, 2 * shape[2], 2 * shape[3],
                         2 * z_out)
    want = ref.detach()
    scale = float(want.abs().max())
    for got in (sk.deconv_final(x, w, bias, z_lo, z_out),
                sk.deconv_final_gemm(x, w, bias, z_lo, z_out)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12 * scale
    grad = torch.randn(ref.shape, generator=g, dtype=torch.float64)
    (ref * grad).sum().backward()
    got = sk.deconv_final_backward(grad, x, w, (True, True, True), z_lo)
    for a, r in zip(got, (xr.grad, wr.grad, br.grad)):
        assert float((a - r).abs().max()) <= 1e-12 * float(r.abs().max())
