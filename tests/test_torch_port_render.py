"""PyTorch port, spherical renderer: the tap tables, the plain renderer
against the JAX package (XLA einsum path and the fused Pallas kernels in
interpret mode), and a CPU gather-form rendition of the CUDA kernels'
tap arithmetic against the dense plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genre_shapehd_tpu.ops.pallas.render_kernel import \
    render_expected_depth_pallas
from genre_shapehd_tpu.ops.render_sph_fast import \
    render_spherical_fast as jax_render
from genre_shapehd_tpu_torch.ops import render_sph_fast as trs
from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk

torch.set_num_threads(2)

# the sizes of tests/test_pallas_render.py
V, R, Z, M = 32, 32, 64, 64


def _volume(b, seed):
    """A solid ball plus noise: saturated and boundary probabilities."""
    rng = np.random.default_rng(seed)
    vox = rng.random((b, V, V, V)).astype(np.float32) * 0.2
    c = (np.arange(V) + 0.5) / V - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    vox += (x ** 2 + y ** 2 + z ** 2 < 0.09).astype(np.float32) * 0.9
    return np.clip(vox, 1e-5, 1.0 - 1e-5)


def _densify(lo, w2, size):
    """(G, T) rows / (G, T, 2) weights -> (G, size, T) dense matrix."""
    g, t = lo.shape
    w = np.zeros((g, size, t), np.float32)
    gi, ti = np.meshgrid(np.arange(g), np.arange(t), indexing="ij")
    w[gi, lo, ti] += w2[..., 0]
    w[gi, lo + 1, ti] += w2[..., 1]
    return w


@pytest.mark.parametrize("shape", [(128, 128, 256, 192), (V, R, Z, M)])
def test_tap_tables_rebuild_stage_weights(shape):
    dense = trs._stage_weights(*shape)
    taps = trs.tap_tables(*shape)
    sizes = {"x": shape[0], "y": shape[0], "z": shape[0], "m": shape[3]}
    for (name, size), w in zip(sizes.items(), dense):
        # at most two nonzeros per column, adjacent
        nz = w != 0
        assert nz.sum(axis=1).max() <= 2
        lo, hi = np.argmax(nz, 1), size - 1 - np.argmax(nz[:, ::-1], 1)
        has = nz.any(1)
        assert np.all(hi[has] - lo[has] <= 1)
        lo_t = taps[name + "_lo"]
        assert lo_t.min() >= 0 and lo_t.max() <= size - 2
        # densified taps rebuild the dense weights exactly
        np.testing.assert_array_equal(
            _densify(lo_t, taps[name + "_w"], size), w)
    # the port's numpy copy of the weights is the JAX package's, exactly
    from genre_shapehd_tpu.ops.render_sph_fast import _stage_weights
    for a, b in zip(dense, _stage_weights(*shape)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_renderer_matches_jax_xla_path(dtype):
    vox = _volume(2, 0)
    ref = np.asarray(jax_render(jnp.asarray(vox), R, Z, rho_res=M,
                                compute_dtype=getattr(jnp, dtype),
                                use_pallas=False))
    got = trs.render_spherical_fast(torch.from_numpy(vox), R, Z, M,
                                    getattr(torch, dtype)).numpy()
    assert got.shape == ref.shape == (2, R, R)
    # same einsums with the same bf16 rounding points, f32 sums in another
    # order: a few ulp of the expected depth in either dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_plain_renderer_matches_pallas_interpret():
    vox = _volume(2, 3)
    ref = np.asarray(render_expected_depth_pallas(jnp.asarray(vox), V, R, Z,
                                                  M, True))
    got = trs.render_spherical_fast(torch.from_numpy(vox), R, Z, M,
                                    torch.bfloat16).numpy()
    d = np.abs(got - ref)
    # tests/test_pallas_render.py's bounds for the fused kernels vs the
    # einsum path: the kernels round other intermediates to bf16
    assert d.mean() < 2e-3, d.mean()
    assert d.max() < 3e-2, d.max()


def _gather_stage1(vox, taps):
    """K1's arithmetic on the CPU: c[b,th,m,:] = sum_ij wx_i wy_j
    vox[b, x0+i, y0+j, :], f32 accumulation."""
    x0, y0 = taps["x_lo"], taps["y_lo"]
    wx, wy = taps["x_w"], taps["y_w"]
    acc = 0.0
    for i in (0, 1):
        for j in (0, 1):
            w = (wx[..., i] * wy[..., j])[None, :, :, None]
            acc = acc + w * vox[:, x0 + i, y0 + j, :]
    return acc


def _gather_stage2(c, taps, z_res):
    """K2's arithmetic on the CPU: per ray, p[s] from 2 m-taps x 2 z-taps,
    clip, exclusive prefix sum of log1p(-p), expected depth."""
    z0, m0 = taps["z_lo"], taps["m_lo"]          # (Ph, S)
    wz, wr = taps["z_w"], taps["m_w"]
    p = 0.0
    for i in (0, 1):
        for j in (0, 1):
            # c[b, th, m0+i, z0+j] for every (ph, s): (B, Th, Ph, S)
            g = c[:, :, m0 + i, z0 + j]
            p = p + (wr[..., i] * wz[..., j])[None, None] * g
    p = torch.clamp(p, 1e-5, 1.0 - 1e-5)
    lg = torch.log1p(-p)
    cum = torch.cumsum(lg, -1) - lg
    s = torch.arange(z_res, dtype=torch.float32) / (z_res - 1)
    out = (p * torch.exp(cum) * s).sum(-1) + torch.exp(lg.sum(-1))
    return out.permute(0, 2, 1)                   # (B, Ph, Th)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_form_matches_dense_plain(dtype):
    cd = getattr(torch, dtype)
    vox = torch.from_numpy(_volume(2, 5))
    taps = {k: torch.from_numpy(v) for k, v in
            trs.tap_tables(V, R, Z, M).items()}
    for k in ("x_w", "y_w", "z_w", "m_w"):       # weights in the compute
        taps[k] = taps[k].to(cd).float()         # dtype, as on the card
    c_dense = rk.stage1_plain(vox, V, R, Z, M, cd)
    c_gather = _gather_stage1(vox.to(cd).float(), taps)
    # f32: only the summation order differs.  bf16: the dense path rounds
    # t1 = sum_x wx*vox to bf16 before the y contraction (<= 2^-8 of
    # values <= 1) and both round c to bf16 (one more ulp)
    tol = 1e-5 if dtype == "float32" else 1.2e-2
    np.testing.assert_allclose(c_gather.to(cd).float().numpy(),
                               c_dense.float().numpy(), rtol=0, atol=tol)
    c = c_dense.float()
    e_dense = rk.stage2_plain(c_dense, V, R, Z, M, cd)
    e_gather = _gather_stage2(c, taps, Z)
    d = np.abs(e_gather.numpy() - e_dense.numpy())
    if dtype == "float32":
        # product vs exp-of-log-sum form of the stop probability
        assert d.max() < 1e-5, d.max()
    else:
        # the dense path also rounds t2 = sum_z c*wz to bf16: the
        # tests/test_pallas_render.py bounds
        assert d.mean() < 2e-3 and d.max() < 3e-2, (d.mean(), d.max())


def test_kernel_wrappers_take_plain_version_on_cpu():
    vox = torch.from_numpy(_volume(1, 6))
    rk.reset_launches()
    c = rk.stage1(vox, V, R, Z, M, torch.bfloat16)
    assert c.dtype == torch.bfloat16 and c.shape == (1, R, M, V)
    np.testing.assert_array_equal(
        c.float().numpy(),
        rk.stage1_plain(vox, V, R, Z, M, torch.bfloat16).float().numpy())
    out = rk.render_expected_depth(vox, V, R, Z, M, torch.float32)
    assert out.shape == (1, R, R) and torch.isfinite(out).all()
    # no kernel launched on CPU tensors
    assert rk.launches == {"render_stage1": 0, "render_stage2_scan": 0,
                           "render_stage2_samples": 0}
    with pytest.raises(TypeError):
        rk.stage1(vox, V, R, Z, M, torch.float16)
