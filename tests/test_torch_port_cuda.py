"""PyTorch port, CUDA kernels K1 (render_stage1), K2 (render_stage2_scan),
K3 (deconv_final), K4 (nn_min_dist), K5 (render_stage2_samples) and K6
(critic_stem) against their plain versions on the card, the renderer's
gradient on the card against the CPU's, and one training step on the
card.  Skipped where ``torch.cuda.is_available()`` is false.

On a machine with a GPU and nvcc:
  python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from genre_shapehd_tpu_torch.nn.voxel_nets import Deconv3D
from genre_shapehd_tpu_torch.ops import chamfer
from genre_shapehd_tpu_torch.ops.cuda import chamfer_kernel as ck
from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as stem
from genre_shapehd_tpu_torch.ops.cuda import render_kernel as rk
from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk

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
    assert rk.launches == {"render_stage1": 1, "render_stage2_scan": 1,
                           "render_stage2_samples": 0}
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


@pytest.mark.parametrize("in_dtype,dtype,b,v,m", [
    ("float32", "bfloat16", 1, 34, 48), ("bfloat16", "bfloat16", 1, 34, 100),
    ("float32", "float32", 1, 34, 100), ("bfloat16", "float32", 2, 34, 48),
    ("bfloat16", "bfloat16", 1, 32, 100), ("float32", "float32", 1, 32, 48)])
def test_stage1_edge_shapes_and_volume_dtypes(device, in_dtype, dtype, b, v,
                                              m):
    """K1 reads a float32 or bfloat16 volume as it is (V = 34 is no
    multiple of the vector width: the scalar path; V = 32 the vector
    path; M = 100 ends in a partial run of rows), against its plain
    version; a float32 volume gives what the same volume cast to the
    compute dtype gives, bit for bit."""
    cd = getattr(torch, dtype)
    vox = _volume(b, v, 4, device).to(getattr(torch, in_dtype))
    args = (v, 32, 64, m, cd)
    rk.reset_launches()
    c = rk.stage1(vox, *args)
    torch.cuda.synchronize()
    assert rk.launches["render_stage1"] == 1
    assert c.shape == (b, 32, m, v) and c.dtype == cd
    d = (c.float() - rk.stage1_plain(vox, *args).float()).abs()
    if dtype == "float32":
        assert d.max() < 1e-5, d.max()
    else:
        assert d.max() < 1.6e-2 and d.mean() < 1e-3, (d.max(), d.mean())
    cast = rk.stage1(vox.to(cd), *args)
    torch.cuda.synchronize()
    assert torch.equal(c, cast)


def test_cuda_tensor_never_falls_back(device):
    vox = _volume(1, 32, 1, device)
    with pytest.raises(TypeError):
        rk.stage1(vox, 32, 32, 64, 64, torch.float16)
    with pytest.raises(ValueError):
        rk.stage2(torch.zeros(1, 32, 64, 32, device=device), 32, 32, 1024,
                  64, torch.float32)


@pytest.mark.parametrize("dtype,b,cin,s,bias", [
    ("float32", 2, 12, 16, 0.3), ("float32", 1, 3, 5, 0.3),
    ("bfloat16", 2, 40, 16, 0.3), ("bfloat16", 1, 7, 9, 0.3),
    ("float32", 1, 7, 9, 0.3), ("bfloat16", 1, 3, 5, 0.3),
    ("bfloat16", 2, 40, 33, 0.3), ("float32", 2, 40, 33, 0.3),
    ("bfloat16", 1, 20, 24, 0.3), ("bfloat16", 2, 40, 64, 0.3),
    ("bfloat16", 1, 5, 72, 0.3), ("float32", 8, 40, 64, 0.3),
    ("float32", 1, 1, 1, 0.3), ("float32", 1, 3, 66, 0.3),
    ("float32", 1, 300, 8, 0.3), ("bfloat16", 1, 300, 16, 0.3),
    ("bfloat16", 2, 6, 66, 0.3),
    # MarrNet-2's decoder (a bias) and the WGAN-GP generator (none)
    ("bfloat16", 8, 32, 64, 0.3), ("float32", 8, 32, 64, 0.3),
    ("bfloat16", 4, 64, 64, None), ("float32", 4, 64, 64, None)])
def test_deconv_final_matches_plain(device, dtype, b, cin, s, bias):
    """K3 against its plain version: bf16 on the tensor cores where S is
    a multiple of 8 up to 64 and Cin <= 288 (16, 24, 32, 64; Cin padded to
    16), else (S = 5, 9, 33, 66, 72; Cin = 300) and in float32 (dec6's
    (8, 40, 64^3), MarrNet-2's decoder (8, 32, 64^3), the generator's
    (4, 64, 64^3) and S = 1 too) on the CUDA cores: staged by TMA where a
    row of x is whole 16-byte units, by plain loads where it is not (S =
    1, 5, 9, 33, 66 in float32; 5, 9, 33, 66 in bf16).  A layer without a
    bias hands K3 a zero one.

    float32: within 1e-5 of the scale of the plain version.  bf16, by
    ``chip_smoke.k3_bf16_within``: within 1 u (2^-8 of the largest
    magnitude) of the float32 result on the inputs as the kernel reads
    them, at every shape; within 1e-2 (max) and 1e-3 (mean) of the scale
    of cuDNN's bf16 plain version, a bound waived only where that plain
    version itself lies beyond 1.5 u of the float32 result."""
    from chip_smoke import k3_bf16_within
    cd = getattr(torch, dtype)
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal((b, cin, s, s, s)).astype(
        np.float32)).to(device, cd)
    w = torch.from_numpy((rng.standard_normal((cin, 1, 4, 4, 4)) * 0.2)
                         .astype(np.float32)).to(device)
    bias = torch.tensor([0.0 if bias is None else bias], device=device)
    sk.reset_launches()
    out = sk.deconv_final(x, w, bias)
    torch.cuda.synchronize()
    assert sk.launches == {"deconv_final": 1}
    assert out.shape == (b, 1, 2 * s, 2 * s, 2 * s) and out.dtype == cd
    ref = sk.deconv_final_plain(x, w, bias).float()
    scale = float(ref.abs().max())
    d = (out.float() - ref).abs()
    if dtype == "float32":
        # summation order only
        assert d.max() <= 1e-5 * scale, (d.max(), scale)
        return
    exact = torch.nn.functional.conv_transpose3d(
        x.float(), w.to(cd).float(), bias, stride=2, padding=1)
    e = float((out.float() - exact).abs().max())
    e_plain = float((ref - exact).abs().max())
    ok, waived = k3_bf16_within(float(d.max()), float(d.mean()), e, e_plain,
                                scale, float(exact.abs().max()))
    assert ok, (float(d.max()), float(d.mean()), e, e_plain, scale, waived)


@pytest.mark.parametrize("dtype,b,cin,s,kernel", [
    ("float32", 8, 40, 64, "deconv_final_fma_kernel"),
    ("float32", 1, 7, 9, "deconv_final_fma_kernel"),
    ("bfloat16", 8, 40, 64, "deconv_final_mma_kernel"),
    ("bfloat16", 1, 5, 72, "deconv_final_fma_kernel"),
    ("bfloat16", 1, 7, 9, "deconv_final_fma_kernel"),
    ("bfloat16", 1, 300, 16, "deconv_final_fma_kernel")])
def test_deconv_final_launches_one_kernel(device, dtype, b, cin, s, kernel):
    """One device kernel per K3 call (no cast of x or the weight, no
    copy), and the one its shape selects: float32 and the bf16 shapes the
    tensor-core tiling refuses run the CUDA-core kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cd = getattr(torch, dtype)
    x = torch.zeros((b, cin, s, s, s), dtype=cd, device=device)
    w = torch.zeros((cin, 1, 4, 4, 4), device=device)
    bias = torch.zeros(1, device=device)
    sk.deconv_final(x, w, bias)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sk.deconv_final(x, w, bias)
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and not e.key.startswith(("Memcpy", "Memset"))}
    assert sum(names.values()) == 1 and kernel in next(iter(names)), names


def test_deconv_final_layer_autocast_grad_and_layouts(device):
    """Through the layer: under autocast the kernel computes in bfloat16
    from float32 parameters; a channels-last input is accepted; the
    backward is the plain version's."""
    layer = Deconv3D(6, 1, 4, 2, 1).to(device)
    x = torch.randn(2, 6, 8, 8, 8, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    sk.reset_launches()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        out = layer(x)
    assert out.dtype == torch.bfloat16 and sk.launches["deconv_final"] == 1
    with torch.no_grad():
        ref = layer.ConvTranspose_0(x)
    assert (out.float() - ref).abs().max() <= 2e-2 * float(ref.abs().max())
    cl = x.to(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        assert (layer(cl) - ref).abs().max() <= 1e-5 * float(ref.abs().max())
    xg = x.clone().requires_grad_()
    layer(xg).square().sum().backward()
    g_kernel = xg.grad.clone()
    gw_kernel = layer.ConvTranspose_0.weight.grad.clone()
    layer.zero_grad()
    xr = x.clone().requires_grad_()
    layer.ConvTranspose_0(xr).square().sum().backward()
    scale = float(xr.grad.abs().max())
    assert (g_kernel - xr.grad).abs().max() <= 1e-4 * scale
    gw = layer.ConvTranspose_0.weight.grad
    assert (gw_kernel - gw).abs().max() <= 1e-4 * float(gw.abs().max())
    with pytest.raises(TypeError):
        sk.deconv_final(x.half(), layer.ConvTranspose_0.weight,
                        layer.ConvTranspose_0.bias)
    with pytest.raises(RuntimeError):
        sk.deconv_final(x, layer.ConvTranspose_0.weight.cpu(),
                        layer.ConvTranspose_0.bias)


@pytest.mark.parametrize("b,n,m", [(2, 700, 1200), (1, 513, 511),
                                   (3, 1, 2500), (1, 1024, 1024),
                                   (8, 8192, 8192), (2, 2500, 1), (1, 1, 1),
                                   (4, 37, 45)])
def test_nn_min_dist_matches_plain(device, b, n, m):
    rng = np.random.default_rng(n)
    x1 = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(
        np.float32)).to(device)
    x2 = torch.from_numpy(rng.standard_normal((b, m, 3)).astype(
        np.float32)).to(device)
    ck.reset_launches()
    d1, d2, i1, i2 = chamfer.nndistance_w_idx(x1, x2)
    torch.cuda.synchronize()
    assert ck.launches == {"nn_min_dist": 1}
    r1, r2, _, _ = ck.nn_min_dist_plain(x1, x2)
    # tests/test_pallas_chamfer.py's bounds
    torch.testing.assert_close(d1, r1, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(d2, r2, rtol=1e-4, atol=1e-5)
    # indices through the distances they give (ties may differ)
    assert i1.dtype == torch.int32 and int(i1.max()) < m and int(i2.max()) < n
    nn1 = torch.gather(x2, 1, i1.long()[..., None].expand(-1, -1, 3))
    nn2 = torch.gather(x1, 1, i2.long()[..., None].expand(-1, -1, 3))
    torch.testing.assert_close(((x1 - nn1) ** 2).sum(-1), d1, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(((x2 - nn2) ** 2).sum(-1), d2, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("b,n,m", [(1, 1024, 1024), (2, 700, 1200),
                                   (8, 8192, 8192)])
def test_nn_min_dist_ties_go_to_the_lowest_index(device, b, n, m):
    """Clouds with exact copies: every fifth point of x2 repeats an
    earlier one and half of x1 are copies of x2's points.  Copies give
    equal distances bit for bit, so the kernel's index is the first copy
    of the point it names, both ways; the backward scatters through those
    indices (the formula on the same indices on the CPU)."""
    rng = np.random.default_rng(b * n + m)
    x1 = rng.standard_normal((b, n, 3)).astype(np.float32)
    x2 = rng.standard_normal((b, m, 3)).astype(np.float32)
    for j in range(1, m, 5):
        x2[:, j] = x2[:, rng.integers(0, j)]
    x1[:, ::2] = x2[:, rng.integers(0, m, size=len(range(0, n, 2)))]
    for j in range(3, n, 7):
        x1[:, j] = x1[:, rng.integers(0, j)]
    t1 = torch.from_numpy(x1).to(device).requires_grad_()
    t2 = torch.from_numpy(x2).to(device).requires_grad_()
    ck.reset_launches()
    d1, d2, i1, i2 = chamfer.nndistance_w_idx(t1, t2)
    torch.cuda.synchronize()
    assert ck.launches == {"nn_min_dist": 1}
    r1, r2, _, _ = ck.nn_min_dist_plain(t1.detach(), t2.detach())
    torch.testing.assert_close(d1, r1, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(d2, r2, rtol=1e-4, atol=1e-5)
    assert int((d1 == 0).sum()) >= b * ((n + 1) // 2)
    for x, idx in ((x2, i1), (x1, i2)):
        # first[bi, j]: the lowest index holding the same point as j
        first = np.empty(x.shape[:2], np.int64)
        for bi in range(b):
            _, lowest, inv = np.unique(x[bi], axis=0, return_index=True,
                                       return_inverse=True)
            first[bi] = lowest[inv.reshape(-1)]
        got = idx.long().cpu().numpy()
        assert (np.take_along_axis(first, got, 1) == got).all()
    g1 = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    g2 = torch.from_numpy(rng.standard_normal((b, m)).astype(np.float32))
    torch.autograd.backward((d1, d2), (g1.to(device), g2.to(device)))
    c1, c2 = torch.from_numpy(x1), torch.from_numpy(x2)
    dx1, dx2 = ck._scatter_grad(c1, c2, i1.cpu(), g1)
    ex2, ex1 = ck._scatter_grad(c2, c1, i2.cpu(), g2)
    torch.testing.assert_close(t1.grad.cpu(), dx1 + ex1, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(t2.grad.cpu(), dx2 + ex2, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape,group,blocks", [
    ((1, 1024, 1024), 32, 128), ((8, 8192, 8192), 4, 1024),
    ((2, 700, 1200), 32, 300), ((64, 4096, 4096), 1, 1024)])
def test_k4_plan_fills_the_card(device, shape, group, blocks):
    """The lanes per group of 4 queries, as the kernel's entry point
    chooses them: the least power of two up to 32 that gives 2^17 threads
    over both directions, so the scoring path's 1 x 1024 x 1024 spreads
    over 128 blocks (PR 2's kernel: 16)."""
    assert ck.plan(*shape) == {"group": group, "blocks": blocks}
    b, n, m = shape
    threads = b * (n + m) * group // 4
    assert threads >= 2 ** 17 or group == 32


def test_nn_min_dist_gradient_and_degenerate_clouds(device):
    rng = np.random.default_rng(2)
    x1 = torch.from_numpy(rng.standard_normal((1, 40, 3)).astype(np.float32))
    x2 = torch.from_numpy(rng.standard_normal((1, 60, 3)).astype(np.float32))
    grads = []
    for dev in (device, torch.device("cpu")):
        a = x1.to(dev).requires_grad_()
        b = x2.to(dev).requires_grad_()
        d1, d2 = chamfer.nndistance(a, b)
        (d1.sum() + 0.5 * d2.sum()).backward()
        grads.append((a.grad.cpu(), b.grad.cpu()))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    z = torch.zeros(1, 1024, 3, device=device)
    s = chamfer.nndistance_score(z, z)
    assert torch.isfinite(s).all() and float(s[0]) < 1e-9
    with pytest.raises(RuntimeError):
        chamfer.nndistance(x1.to(device), x2)


@pytest.mark.parametrize("dtype,b,v,r,z,m", [
    ("float32", 2, 32, 32, 64, 64), ("bfloat16", 2, 32, 32, 64, 64),
    ("bfloat16", 4, 64, 64, 96, 96)])
def test_stage2_samples_matches_plain(device, dtype, b, v, r, z, m):
    cd = getattr(torch, dtype)
    c = rk.stage1(_volume(b, v, 2, device), v, r, z, m, cd)
    rk.reset_launches()
    out = rk.stage2_samples(c, v, r, z, m, cd)
    torch.cuda.synchronize()
    assert rk.launches["render_stage2_samples"] == 1
    assert out.shape == (b, r, r, z) and out.dtype == torch.float32
    d = (out - rk.stage2_samples_plain(c, v, r, z, m, cd)).abs()
    if dtype == "float32":
        assert d.max() < 1e-5, d.max()
    else:
        # the plain version rounds t2 to bf16, the kernel does not
        assert d.max() < 3e-2 and d.mean() < 2e-3, (d.max(), d.mean())
    with pytest.raises(TypeError):
        rk.stage2_samples(c.float() if dtype == "bfloat16" else c.bfloat16(),
                          v, r, z, m, cd)


@pytest.mark.parametrize("r", [32, 30])
@pytest.mark.parametrize("dtype,b,v", [
    ("bfloat16", 1, 34), ("bfloat16", 3, 34), ("float32", 1, 34),
    ("float32", 3, 34), ("bfloat16", 3, 33)])
def test_stage2_slab_kernels_edge_shapes(device, r, dtype, b, v):
    """K2 and K5 off the main path's shapes against their plain versions:
    M = 50, z = 98 (S no multiple of 32 or of 4), V = 34 (a bf16 slab of
    3,400 bytes, no multiple of 16), V = 33 in bf16 (rows not 4-byte
    aligned: staged by plain loads), batch 1 and 3, in the plan's groups
    of 4 slabs: R = 32 fills them; R = 30 leaves a ragged last group and,
    at batch 3, puts a group across a batch boundary."""
    cd = getattr(torch, dtype)
    z, m = 98, 50
    assert rk.plan(v, m, cd)["group"] == 4
    c = rk.stage1(_volume(b, v, 7, device), v, r, z, m, cd)
    rk.reset_launches()
    depth = rk.stage2(c, v, r, z, m, cd)
    torch.cuda.synchronize()
    samples = rk.stage2_samples(c, v, r, z, m, cd)
    torch.cuda.synchronize()
    assert rk.launches == {"render_stage1": 0, "render_stage2_scan": 1,
                           "render_stage2_samples": 1}
    assert depth.shape == (b, r, r) and samples.shape == (b, r, r, z)
    for got, ref in ((depth, rk.stage2_plain(c, v, r, z, m, cd)),
                     (samples, rk.stage2_samples_plain(c, v, r, z, m, cd))):
        d = (got - ref).abs()
        if dtype == "float32":
            assert d.max() < 1e-5, d.max()
        else:
            assert d.max() < 3e-2 and d.mean() < 2e-3, (d.max(), d.mean())


def test_stage2_slab_larger_than_shared_memory_raises(device):
    """A float32 slab of (M, V) = (384, 256) takes 395 KB: the wrapper
    raises before anything is launched."""
    c = torch.zeros((1, 8, 384, 256), device=device)
    rk.reset_launches()
    for fn in (rk.stage2, rk.stage2_samples):
        with pytest.raises(ValueError):
            fn(c, 256, 8, 64, 384, torch.float32)
    assert set(rk.launches.values()) == {0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_gradient_on_the_card_matches_cpu(device, dtype):
    """The card's forward K1 + K2 and backward K1 + K5 + transpose against
    the CPU's plain path: the gradient relative to its largest entry."""
    cd = getattr(torch, dtype)
    v, r, z, m = 32, 32, 64, 64
    vox = _volume(2, v, 3, device)
    w = torch.randn((2, r, r), device=device,
                    generator=torch.Generator(device).manual_seed(1))
    grads = []
    for dev in (device, torch.device("cpu")):
        x = vox.to(dev).clone().requires_grad_(True)
        rk.reset_launches()
        out = rk.render_expected_depth(x, v, r, z, m, cd)
        assert out.grad_fn is not None
        (out * w.to(dev)).sum().backward()
        grads.append(x.grad.cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert rk.launches == {"render_stage1": 2,
                                   "render_stage2_scan": 1,
                                   "render_stage2_samples": 1}
    rel = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    # float32: summation order; bf16: the kernels keep t1 / t2 in float32
    # where the plain versions round them (test_pallas_vjp's bound)
    assert rel < (1e-4 if dtype == "float32" else 2e-2), rel


def test_genre_train_step_on_the_card(device):
    """One joint float32 step of the GenRe model at the tests' scale on
    the card: the loss terms match the CPU's step from the same weights,
    and every kernel of the path launched."""
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data.loader import collate
    from genre_shapehd_tpu_torch.models.base import default_opt
    cfg = dict(im_size=64, vox_res=32, sph_res=32, z_res=32,
               padding_margin=16, joint_train=True, no_aug=True, lr=1e-4,
               surface_weight=10.0)
    logs = []
    for dev in ("cuda", "cpu"):
        model = get_model("genre_full_model")(default_opt(device=dev, **cfg))
        model.init_state(0)
        ds = get_dataset("synthetic")(model.opt, "train", model=model)
        batch = {k: v for k, v in collate([ds[i] for i in range(4)]).items()
                 if isinstance(v, np.ndarray)}
        rk.reset_launches()
        sk.reset_launches()
        logs.append({k: float(x) for k, x in model.train_step(batch).items()})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert rk.launches == {"render_stage1": 2,
                                   "render_stage2_scan": 1,
                                   "render_stage2_samples": 1}
            assert sk.launches == {"deconv_final": 1}
    for k, ref in logs[1].items():
        assert np.isfinite(logs[0][k])
        # cuDNN vs CPU convolutions in float32 (TF32 off)
        assert abs(logs[0][k] - ref) <= 1e-3 * abs(ref) + 1e-5, (k, logs)


def test_batchnorm_on_two_gloo_ranks_on_the_card(device, tmp_path):
    """Two ranks sharing card 0 over gloo
    (``tests/_torch_port_dist_cases.py``): a train-mode BatchNorm2d and 3d on the global batch, against one
    process on the whole batch on the card: outputs and input gradients
    within 1e-5 of their scale (a rank's input gradient is N times the
    mean loss's), parameter gradients after the all-reduce, running
    statistics within 1e-6."""
    import _torch_port_dist_cases as C
    cases = ("bn2d", "bn3d")
    procs = C.spawn_ranks(str(tmp_path), "", "cuda:0", cases)
    try:
        ref = C.run_all("", cases, "cuda:0")
    finally:
        ranks = C.gather(procs, str(tmp_path))
    for case in cases:
        r_ref = ref[case]
        for r, res in enumerate(ranks):
            got = res[case]
            idx = torch.as_tensor(C.mesh.shard_slice(4, 2, r))
            for k, scale in (("y", 1), ("x_grad", 2), ("weight_grad", 1),
                             ("bias_grad", 1)):
                want = r_ref[k][idx] * scale if k in ("y", "x_grad") \
                    else r_ref[k]
                err = float((got[k] - want).abs().max())
                assert err <= 1e-5 * float(want.abs().max()), (case, k, err)
            for k in ("running_mean", "running_var"):
                err = float((got[k] - r_ref[k]).abs().max())
                assert err <= 1e-6, (case, k, err)


@pytest.mark.parametrize("b,r", [(2, 32), (4, 64), (8, 128)])
def test_critic_stem_matches_plain(device, b, r):
    """K6 against ``critic_stem_plain`` in bf16 (cuDNN's convolution and
    ``F.leaky_relu`` under autocast), on float32 probabilities in (0, 1)
    as the critic sees them.

    K6 rounds v and the weight to bf16 as autocast does, sums in float32,
    applies the activation to the float32 sum and rounds once: each output
    lies within one bf16 rounding (2^-8 relative) of the float64 result
    on the rounded inputs, with room for the float32 sums' order (64
    terms: 64 * 2^-24 of their summed magnitudes).  The plain path rounds
    twice, the convolution's sum and then the activation's product, so
    the two lie within two bf16 steps (2^-6 relative) of each other."""
    g = torch.Generator(device).manual_seed(r)
    v = torch.rand((b, 1, r, r, r), generator=g, device=device)
    w = torch.randn((64, 1, 4, 4, 4), generator=g, device=device) * 0.1
    stem.reset_launches()
    with torch.inference_mode():
        out = stem.critic_stem(v, w)
        torch.cuda.synchronize()
        assert stem.launches == {"critic_stem": 1, "critic_stem_backward": 0,
                                 "critic_stem_mask": 0}
        assert out.shape == (b, 64, r // 2, r // 2, r // 2)
        assert out.dtype == torch.bfloat16 and out.is_contiguous(
            memory_format=torch.channels_last_3d)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            plain = stem.critic_stem_plain(v, w)
        vb, wb = (t.to(torch.bfloat16).double() for t in (v, w))
        exact = torch.nn.functional.leaky_relu(
            torch.nn.functional.conv3d(vb, wb, None, 2, 1), 0.2)
        slack = 64 * 2.0 ** -24 * torch.nn.functional.conv3d(
            vb.abs(), wb.abs(), None, 2, 1)
        got, plain = out.double(), plain.double()
        e = (got - exact).abs() - (2.0 ** -8 * exact.abs() + slack)
        assert float(e.max()) <= 0, float(e.max())
        d = (got - plain).abs() - (2.0 ** -6 * torch.maximum(
            got.abs(), plain.abs()) + 2 * slack)
        assert float(d.max()) <= 0, float(d.max())


def _critic_last_input(net, v):
    """The critic's scores on v and the input of its last layer."""
    seen = []
    hook = getattr(net, f"Conv3D_{net.n_mid}").register_forward_hook(
        lambda m, args, out: seen.append(args[0]))
    try:
        score = net(v)
    finally:
        hook.remove()
    return score, seen[0]


def test_critic_score_on_k6_against_cudnn(device):
    """The whole critic (nf 64, 128³) under bf16 autocast on probabilities:
    with K6 (inference mode) against the cuDNN path (grad on, the weights
    needing a gradient), each score's difference over the summed
    magnitudes of the last layer's products within the benchmark's
    ``critic`` limit, 3.3e-4 (the scores' own scale: they are sums that
    cancel); K6 launches once, and not at all with grad on."""
    from genre_shapehd_tpu_torch.nn import VoxelDiscriminator
    from genre_shapehd_tpu_torch.nn.init import init_weights
    net = VoxelDiscriminator(64, 128).eval()
    init_weights(net, torch.Generator().manual_seed(4))
    net.to(device)
    v = _volume(4, 128, 6, device)
    stem.reset_launches()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        with torch.inference_mode():
            k6, _ = _critic_last_input(net, v)
        torch.cuda.synchronize()
        assert stem.launches == {"critic_stem": 1, "critic_stem_backward": 0,
                                 "critic_stem_mask": 0}
        ref, last = _critic_last_input(net, v)
        torch.cuda.synchronize()
        assert stem.launches == {"critic_stem": 1, "critic_stem_backward": 0,
                                 "critic_stem_mask": 0}
    w = getattr(net, f"Conv3D_{net.n_mid}").Conv_0.weight.detach()
    with torch.no_grad():
        scale = torch.nn.functional.conv3d(
            last.detach().float().abs(), w.abs()).reshape(-1)
        err = (k6.float() - ref.detach().float()).abs() / scale
    assert float(err.max()) <= 3.3e-4, err.tolist()


def test_critic_stem_launches_in_shapehd_predict_step(device, tmp_path):
    """One ``shapehd.ModelTest.predict_step`` in bf16 (64² photos -> 32³
    voxels, batch 2) launches K6 twice, once on each voxel grid (the
    fine-tuned and the frozen MarrNet-2's); a critic call whose weights
    train, as in the WGAN-GP step, launches none."""
    from genre_shapehd_tpu_torch.cli import options
    from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint
    from genre_shapehd_tpu_torch.core.convert import torch_to_jax
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.base import default_opt
    from genre_shapehd_tpu_torch.models.marrnet import marrnet1_net

    def write(path, modules, names):
        payload = []
        for m in modules:
            params, stats = torch_to_jax(
                {k: t.cpu() for k, t in m.state_dict().items()})
            payload.append({"params": params, "batch_stats": stats})
        save_checkpoint(path, {"nets": payload, "optimizers": [],
                               "epoch": 0, "loss_eval": 0.0,
                               "net_names": list(names), "opt_names": []})

    train = get_model("shapehd")(default_opt(
        device="cpu", im_size=64, vox_res=32, canon_sup=True,
        w_gan_loss=0.5, lr=1e-4, no_aug=True, batch_size=2))
    train.init_state(0)
    files = (str(tmp_path / "shapehd.pt"), str(tmp_path / "marrnet1.pt"))
    write(files[0], train.net_modules().values(), train.net_names)
    write(files[1], [marrnet1_net(64)], ["net"])
    model = get_model("shapehd", test=True)(options.parse_test([
        "--net", "shapehd", "--input_rgb", "none", "--output_dir",
        str(tmp_path), "--vis_workers", "0", "--im_size", "64",
        "--vox_res", "32", "--batch_size", "2", "--dtype", "bfloat16",
        "--device", "cuda", "--net_file", files[0], "--marrnet1_file",
        files[1]]))
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.normal(size=(2, 64, 64, 3)).astype(np.float32)}
    stem.reset_launches()
    pred = model.predict_step(batch)
    torch.cuda.synchronize()
    assert stem.launches == {"critic_stem": 2, "critic_stem_backward": 0,
                             "critic_stem_mask": 0}
    assert all(bool(torch.isfinite(pred[k]).all())
               for k in ("is_real", "is_real_noft"))
    net_d = model.net_d.requires_grad_(True)
    v = torch.rand((2, 32, 32, 32), device=device)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        net_d(v).sum().backward()
    torch.cuda.synchronize()
    assert stem.launches == {"critic_stem": 2, "critic_stem_backward": 0,
                             "critic_stem_mask": 0}
