"""PyTorch port, spherical renderer: the tap tables and K2's tap records,
the plain renderer against the JAX package (XLA einsum path and the fused
Pallas kernels in interpret mode), a CPU gather-form rendition of the
CUDA kernels' tap arithmetic and of K2's work split against the dense
plain version and the Pallas kernels, K2's and K5's shared-memory plan,
and the kernel build's digest."""

import shutil

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

from _torch_port_util import decode_records

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
    clip, exclusive product of (1 - p) (the transmittance T), expected
    depth summed by parts: sum_{s>=1} T_s / (S - 1)."""
    z0, m0 = taps["z_lo"], taps["m_lo"]          # (Ph, S)
    wz, wr = taps["z_w"], taps["m_w"]
    p = 0.0
    for i in (0, 1):
        for j in (0, 1):
            # c[b, th, m0+i, z0+j] for every (ph, s): (B, Th, Ph, S)
            g = c[:, :, m0 + i, z0 + j]
            p = p + (wr[..., i] * wz[..., j])[None, None] * g
    p = torch.clamp(p, 1e-5, 1.0 - 1e-5)
    trans = torch.cumprod(1.0 - p, -1) / (1.0 - p)
    out = trans[..., 1:].sum(-1) / (z_res - 1)
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
        # the same function summed by parts, in another order
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


def _record_taps(dtype, z_res):
    """K2's and K5's tap records decoded over the padded row (zero weights
    past S), with the products w_ij = m_w_i * z_w_j the kernels form."""
    pad = rk.record_row(z_res)
    d = decode_records(rk.tap_records(V, R, z_res, M, dtype), dtype, pad)
    wz, wr = torch.from_numpy(d["z_w"]), torch.from_numpy(d["m_w"])
    return (torch.from_numpy(d["z_lo"]).long(),
            torch.from_numpy(d["m_lo"]).long(),
            {(i, j): wr[..., i] * wz[..., j] for i in (0, 1) for j in (0, 1)})


def _k2_work_split(c, dtype, z_res, group):
    """K2's work split on the CPU: groups of ``group`` consecutive flat
    slabs c[b * Th + th] (the last one ragged, one across the batch
    boundary), every ph row's records applied to each slab of the group,
    lane l owning samples l * SPL .. l * SPL + SPL - 1 of the padded row,
    each lane's running product of (1 - p) and sum of the T before its
    samples, the exclusive product scan of the lane products, the warp's
    sum / (S - 1)."""
    z0, m0, w = _record_taps(dtype, z_res)
    pad = z0.shape[1]
    spl = pad // 32
    slabs = c.float().reshape(-1, M, V)
    s = torch.arange(pad)
    valid = (s < z_res).reshape(32, spl)
    counted = valid & (s >= 1).reshape(32, spl)
    out = torch.empty(slabs.shape[0], R)
    for first in range(0, slabs.shape[0], group):
        g = slabs[first:first + group]                     # (G, M, V)
        p = w[0, 0] * g[:, m0, z0]
        for i, j in ((0, 1), (1, 0), (1, 1)):
            p = p + w[i, j] * g[:, m0 + i, z0 + j]          # (G, Ph, pad)
        p = torch.clamp(p, 1e-5, 1.0 - 1e-5).reshape(-1, R, 32, spl)
        q = torch.where(valid, 1.0 - p, torch.ones(()))
        run = torch.cumprod(q, -1) / q                      # T within a lane
        lane_sum = (run * counted).sum(-1)
        lane_prod = q.prod(-1)
        before = torch.cumprod(lane_prod, -1) / lane_prod   # exclusive scan
        out[first:first + group] = (before * lane_sum).sum(-1) / (z_res - 1)
    return out.reshape(c.shape[0], R, R).permute(0, 2, 1)  # (B, Ph, Th)


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("z_res", [Z, 98])
def test_k2_work_split_matches_plain_f32(group, z_res):
    c = rk.stage1_plain(torch.from_numpy(_volume(2, 7)), V, R, z_res, M)
    got = _k2_work_split(c, torch.float32, z_res, group)
    ref = rk.stage2_plain(c, V, R, z_res, M)
    assert got.shape == ref.shape == (2, R, R)
    # the same function, summed by parts and in another order
    assert float((got - ref).abs().max()) < 1e-5


@pytest.mark.parametrize("z_res,group", [(Z, 3), (98, 1)])
def test_k2_work_split_matches_pallas_interpret(z_res, group):
    vox = _volume(2, 8)
    ref = np.asarray(render_expected_depth_pallas(jnp.asarray(vox), V, R,
                                                  z_res, M, True))
    c = rk.stage1(torch.from_numpy(vox), V, R, z_res, M, torch.bfloat16)
    got = _k2_work_split(c, torch.bfloat16, z_res, group).numpy()
    d = np.abs(got - ref)
    # tests/test_pallas_render.py's bounds: the Pallas kernels round other
    # intermediates to bf16
    assert d.mean() < 2e-3 and d.max() < 3e-2, (d.mean(), d.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 128, 256, 192), (34, 32, 98, 50),
                                   (V, R, Z, M)])
def test_tap_records_decode_to_tap_tables(shape, dtype):
    cd = getattr(torch, dtype)
    rec = rk.tap_records(*shape, cd)
    s, pad = shape[2], rk.record_row(shape[2])
    words = 6 if dtype == "float32" else 3
    assert rec.dtype == torch.int32
    assert tuple(rec.shape) == (shape[1], words, pad // 4, 4)
    taps = trs.tap_tables(*shape)
    got = decode_records(rec, cd, s)
    for k in ("z_lo", "m_lo"):
        np.testing.assert_array_equal(got[k], taps[k])
    for k in ("z_w", "m_w"):                   # rounded to the compute dtype
        np.testing.assert_array_equal(
            got[k], torch.from_numpy(taps[k]).to(cd).float().numpy())
    # past S every record is zero: no tap, no weight
    tail = decode_records(rec, cd, pad)
    assert all(np.all(tail[k][:, s:] == 0) for k in tail)


def test_plan_groups_and_bytes():
    bf, f32 = torch.bfloat16, torch.float32
    # main shape, bf16: 65-word rows, 4 slabs
    assert rk.plan(128, 192, bf) == dict(group=4, row_stride=130,
                                         slab_bytes=49920, smem_bytes=199680)
    # float32: 99 KB slabs, two of them at most
    assert rk.plan(128, 192, f32) == dict(group=2, row_stride=129,
                                          slab_bytes=99072,
                                          smem_bytes=198144)
    # edge shapes: a 3,400-byte slab (no multiple of 16), odd V
    assert rk.plan(34, 50, bf)["slab_bytes"] == 3400
    assert rk.plan(33, 50, bf)["row_stride"] == 34
    # slabs of more than a quarter, a third, a half of a block: G = 3, 2, 1
    assert rk.plan(128, 250, bf)["group"] == 3
    assert rk.plan(128, 300, bf)["group"] == 2
    assert rk.plan(256, 384, bf)["group"] == 1
    for v in range(2, 300, 7):
        for dt, elt in ((bf, 2), (f32, 4)):
            pe = rk.row_stride(v, dt)
            assert pe >= v and (pe * elt) % 4 == 0 and (pe * elt // 4) % 2
    # never more than the kernels' 4 slabs, however small the slab
    assert rk.plan(34, 50, f32)["group"] == rk.MAX_GROUP == 4
    # a slab larger than shared memory
    with pytest.raises(ValueError):
        rk.plan(256, 384, f32)


def test_library_digest_covers_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ changes the library name of every
    source, so a stale library is never loaded."""
    from genre_shapehd_tpu_torch.ops.cuda import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {src: build.library_path(src) for src in build.SOURCES}
    assert before == {src: build.library_path(src) for src in build.SOURCES}
    header = csrc / "hopper_async.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {src: build.library_path(src) for src in build.SOURCES}
    assert all(before[src] != after[src] for src in build.SOURCES)
