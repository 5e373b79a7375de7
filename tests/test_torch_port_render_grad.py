"""PyTorch port, the renderer's training path on the CPU: the ray samples
of K5's plain version against the Pallas ``_s2_kernel`` (interpret mode),
``sample_rays`` and its transpose against ``sample_rays_pallas`` and
``jax.vjp``, the gradient of ``render_expected_depth`` against
``jax.grad`` through the Pallas route (bf16) and the XLA route (float32),
and the gradients of the two scatter-means against ``jax.grad``; K5's
lane split on the CPU (quad-major tap records, 4 samples a lane per
round, float4 stores with a scalar tail) against the plain version and
``_s2_kernel``.  Sizes are tests/test_pallas_render.py's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genre_shapehd_tpu import ops as jops
from genre_shapehd_tpu.ops.pallas.render_kernel import (
    render_expected_depth_pallas, sample_rays_pallas)
from genre_shapehd_tpu.ops.render_sph_fast import (
    render_spherical_fast as jax_render, sample_rays_mxu)
from genre_shapehd_tpu_torch import ops as tops
from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk

from _torch_port_util import decode_records

torch.set_num_threads(2)

V, R, Z, M = 32, 32, 64, 64


def _volume(b, seed):
    """A solid ball plus noise: saturated and boundary probabilities."""
    rng = np.random.default_rng(seed)
    vox = rng.random((b, V, V, V)).astype(np.float32) * 0.2
    c = (np.arange(V) + 0.5) / V - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    vox += (x ** 2 + y ** 2 + z ** 2 < 0.09).astype(np.float32) * 0.9
    return np.clip(vox, 1e-5, 1.0 - 1e-5)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def test_samples_plain_matches_pallas_s2_kernel():
    vox = _volume(2, 0)
    ref = np.asarray(sample_rays_pallas(jnp.asarray(vox), V, R, Z, M, True))
    c = rk.stage1(torch.from_numpy(vox), V, R, Z, M, torch.bfloat16)
    got = rk.stage2_samples(c, V, R, Z, M, torch.bfloat16).numpy()
    assert got.shape == ref.shape == (2, R, R, Z) and got.dtype == np.float32
    d = np.abs(got - ref)
    # tests/test_pallas_render.py's bounds: the Pallas kernels round other
    # intermediates to bf16 than the einsum formulation does
    assert d.mean() < 2e-3 and d.max() < 3e-2, (d.mean(), d.max())


def _k5_lane_split(c, dtype, z_res):
    """K5's work on the CPU: for every (b, th) slab and ph row, round j
    and lane l take quad 32 j + l of the padded record row, decode its 4
    records, gather p = w00 c[m0, z0] + w01 c[m0, z0+1] + w10 c[m0+1, z0]
    + w11 c[m0+1, z0+1] for s = 4 (32 j + l) + i, and store the 4 values
    as one float4 where S is a multiple of 4, else one by one below S."""
    pad = rk.record_row(z_res)
    d = decode_records(rk.tap_records(V, R, z_res, M, dtype), dtype, pad)
    z0, m0 = (torch.from_numpy(d[k]).long() for k in ("z_lo", "m_lo"))
    wz, wr = torch.from_numpy(d["z_w"]), torch.from_numpy(d["m_w"])
    slabs = c.float().reshape(-1, M, V)
    out = torch.full((slabs.shape[0], R, z_res), float("nan"))
    for j in range(pad // 128):
        s = 128 * j + 4 * torch.arange(32)[:, None] + torch.arange(4)
        p = (wr[:, s, 0] * wz[:, s, 0]) * slabs[:, m0[:, s], z0[:, s]]
        for i, k in ((0, 1), (1, 0), (1, 1)):
            p = p + ((wr[:, s, i] * wz[:, s, k])
                     * slabs[:, m0[:, s] + i, z0[:, s] + k])
        keep = s < z_res                                 # (32 lanes, 4)
        if z_res % 4 == 0:                               # whole quads
            keep = keep.all(-1, keepdim=True).expand(-1, 4)
        out[:, :, s[keep]] = p[:, :, keep]
    return out.reshape(c.shape[0], R, R, z_res).permute(0, 2, 1, 3)


@pytest.mark.parametrize("z_res", [Z, 98])
def test_k5_lane_split_matches_plain_and_s2_kernel(z_res):
    vox = _volume(2, 11)
    c32 = rk.stage1_plain(torch.from_numpy(vox), V, R, z_res, M)
    got = _k5_lane_split(c32, torch.float32, z_res)
    assert not torch.isnan(got).any()                    # every s stored
    ref = rk.stage2_samples_plain(c32, V, R, z_res, M)
    # the same sums in another order
    assert float((got - ref).abs().max()) < 1e-5
    ref = np.asarray(sample_rays_pallas(jnp.asarray(vox), V, R, z_res, M,
                                        True))
    c = rk.stage1(torch.from_numpy(vox), V, R, z_res, M, torch.bfloat16)
    d = np.abs(_k5_lane_split(c, torch.bfloat16, z_res).numpy() - ref)
    # tests/test_pallas_render.py's bounds
    assert d.mean() < 2e-3 and d.max() < 3e-2, (d.mean(), d.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sampling_takes_a_ragged_last_angle_chunk(dtype):
    """R = 30 angles, no multiple of the plain versions' 8 a chunk (the
    card tests' edge shape, where 4-slab groups cross a batch boundary):
    K1's and K5's plain versions against ``sample_rays_mxu`` in chunks of
    6."""
    r = 30
    vox = _volume(2, 12)
    ref = np.asarray(sample_rays_mxu(jnp.asarray(vox), r, Z, M, chunk=6,
                                     compute_dtype=getattr(jnp, dtype)))
    cd = getattr(torch, dtype)
    c = rk.stage1(torch.from_numpy(vox), V, r, Z, M, cd)
    got = rk.stage2_samples(c, V, r, Z, M, cd).numpy()
    assert got.shape == ref.shape == (2, r, r, Z)
    # the same einsums with the same bf16 rounding points, f32 sums in
    # another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_rays_forward_and_vjp_match_jax(dtype):
    vox = _volume(2, 1)
    g = np.random.default_rng(2).standard_normal((2, R, R, Z)).astype(
        np.float32)
    if dtype == "bfloat16":
        fwd = lambda v: sample_rays_pallas(v, V, R, Z, M, True)  # noqa: E731
    else:
        fwd = lambda v: sample_rays_mxu(v, R, Z, M)              # noqa: E731
    ref, vjp = jax.vjp(fwd, jnp.asarray(vox))
    ref_g = np.asarray(vjp(jnp.asarray(g))[0])
    x = torch.from_numpy(vox).requires_grad_(True)
    out = rk.sample_rays(x, V, R, Z, M, getattr(torch, dtype))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    d = np.abs(out.detach().numpy() - np.asarray(ref))
    if dtype == "float32":
        # the same einsums, summed in another order
        assert d.max() < 1e-5, d.max()
        assert _rel(x.grad.numpy(), ref_g) < 1e-5
    else:
        assert d.mean() < 2e-3 and d.max() < 3e-2, (d.mean(), d.max())
        # XLA's transpose rounds the cotangents to bf16 where the forward
        # casts; the port's transpose is float32 over bf16-rounded weights.
        # test_pallas_vjp_matches_xla_grad's bound
        assert _rel(x.grad.numpy(), ref_g) < 2e-2


def test_transpose_is_the_adjoint_of_the_plain_sampling_map():
    """<A x, y> == <x, A^T y> with A the dense float32 plain version."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, V, V, V)).astype(
        np.float32))
    y = torch.from_numpy(rng.standard_normal((2, R, R, Z)).astype(
        np.float32))
    ax = rk.stage2_samples_plain(rk.stage1_plain(x, V, R, Z, M), V, R, Z, M)
    aty = rk.sample_rays_transpose(y, V, R, Z, M)
    lhs, rhs = float((ax * y).double().sum()), float((x * aty).double().sum())
    assert abs(lhs - rhs) <= 1e-5 * (abs(lhs) + abs(rhs)), (lhs, rhs)


def test_render_gradient_matches_pallas_route_bf16():
    vox = _volume(1, 4)
    w = np.random.default_rng(5).standard_normal((1, R, R)).astype(
        np.float32)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(render_expected_depth_pallas(
        v, V, R, Z, M, True) * w))(jnp.asarray(vox)))
    x = torch.from_numpy(vox).requires_grad_(True)
    out = tops.render_spherical_fast(x, R, Z, M, torch.bfloat16)
    (out * torch.from_numpy(w)).sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    # the Pallas route's backward is jax.vjp of the bf16 einsum path:
    # test_pallas_vjp_matches_xla_grad's bound
    assert _rel(x.grad.numpy(), ref) < 2e-2


def test_render_gradient_matches_xla_route_f32():
    vox = _volume(2, 6)
    w = np.random.default_rng(7).standard_normal((2, R, R)).astype(
        np.float32)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(jax_render(
        v, R, Z, M, compute_dtype=jnp.float32, use_pallas=False) * w))(
        jnp.asarray(vox)))
    x = torch.from_numpy(vox).requires_grad_(True)
    out = tops.render_spherical_fast(x, R, Z, M, torch.float32)
    (out * torch.from_numpy(w)).sum().backward()
    # float32 throughout, sums in another order
    assert _rel(x.grad.numpy(), ref) < 1e-4


def test_render_records_a_graph_only_when_asked():
    vox = torch.from_numpy(_volume(1, 8))
    rk.reset_launches()
    assert tops.render_spherical_fast(vox, R, Z, M).grad_fn is None
    out = tops.render_spherical_fast(vox.clone().requires_grad_(True),
                                     R, Z, M)
    assert out.grad_fn is not None
    with torch.inference_mode():
        out = tops.render_spherical_fast(vox.clone().requires_grad_(True),
                                         R, Z, M)
    assert out.grad_fn is None
    # CPU tensors take the plain versions: no kernel launched
    assert set(rk.launches.values()) == {0}
    with pytest.raises(ValueError):
        rk.stage2_samples(torch.zeros(1, R, M + 1, V), V, R, Z, M)


def test_camera_backprojection_gradient_matches_jax():
    res = 32
    rng = np.random.default_rng(9)
    depth = rng.uniform(1.8, 2.6, (2, 40, 40)).astype(np.float32)
    depth[:, :4] = 0.0                        # background, off the cube
    w = rng.standard_normal((2, res, res, res)).astype(np.float32)
    fn_j = lambda d: jnp.sum(jops.camera_backproject_shifted(  # noqa: E731
        d, jops.FL_GENRE, jops.CAM_DIST, res) * w)
    ref = np.asarray(jax.grad(fn_j)(jnp.asarray(depth)))
    d = torch.from_numpy(depth).requires_grad_(True)
    (tops.camera_backproject_shifted(d, tops.FL_GENRE, tops.CAM_DIST, res)
     * torch.from_numpy(w)).sum().backward()
    got = d.grad.numpy()
    assert (ref != 0).sum() > 1000
    # a point on a voxel face may land one voxel over (ROADMAP §C): all but
    # a few pixels agree to float32 rounding
    close = np.abs(got - ref) <= 1e-4 * np.abs(ref).max()
    assert close.mean() >= 0.999, close.mean()


def test_spherical_backprojection_gradient_matches_jax():
    res, r, margin = 32, 24, 4
    rng = np.random.default_rng(10)
    full = rng.uniform(0.3, 1.3, (2, r + 2 * margin, r + 2 * margin))
    full = full.astype(np.float32)
    w = rng.standard_normal((2, res, res, res)).astype(np.float32)
    fn_j = lambda s: jnp.sum(jops.backproject_spherical_masked(  # noqa: E731
        s, margin, res) * w)
    ref = np.asarray(jax.grad(fn_j)(jnp.asarray(full)))
    s = torch.from_numpy(full).requires_grad_(True)
    out = tops.backproject_spherical_masked(s, margin, res)
    (out * torch.from_numpy(w)).sum().backward()
    got = s.grad.numpy()
    # the margin gets no gradient, the crop does; the hit-count mask is a
    # constant in both (its gradient would be zero through floor anyway)
    assert np.all(got[:, :margin] == 0) and (ref != 0).sum() > 500
    close = np.abs(got - ref) <= 1e-4 * np.abs(ref).max()
    assert close.mean() >= 0.999, close.mean()
