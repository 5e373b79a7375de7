"""The plain reference against the port's plain paths at a size the CPU
holds, both in float32 on the same weights and inputs; and the
benchmark's calibration, after which both backprojections hit voxels."""

import statistics

import pytest
import torch
from conftest import TINY

import drive
import inputs
import weights
from reference import geometry, models, nets, precision

CPU = torch.device("cpu")
G = TINY["genre"]
SIZES = dict(vox_res=G["vox_res"], sph_res=G["sph_res"], z_res=G["z_res"],
             margin=G["padding_margin"])


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module")
def genre():
    from genre_shapehd_tpu_torch.models.genre_full import GenreNet
    net = GenreNet(G["im_size"], G["vox_res"], G["sph_res"], G["z_res"],
                   G["padding_margin"]).eval()
    w = weights.seeded(net, 3000000002, CPU)
    ph = inputs.photos(2, G["im_size"], weights.generator(7, "inputs", CPU),
                       CPU)
    weights.calibrate_genre(w, ph["rgb"], ph["silhou"], SIZES)
    net.load_state_dict(w)
    return net, w, ph


def test_calibration_puts_points_in_both_backprojections(genre):
    _, w, ph = genre
    with torch.no_grad():
        out = models.genre(w, ph["rgb"], ph["silhou"], precision.exact,
                           **SIZES)
    for key in ("proj_depth", "pred_proj_sph_full"):
        hit = (out[key] > 1e-3).flatten(1).sum(1)
        assert bool((hit > 50).all()), (key, hit)


def test_genre_forward_agrees_with_the_port(genre):
    net, w, ph = genre
    with torch.no_grad():
        got = net(ph["rgb"], ph["silhou"])
        ref = models.genre(w, ph["rgb"], ph["silhou"], precision.exact,
                           **SIZES)
    for key in ("depth", "depth_minmax", "proj_depth", "pred_sph_partial",
                "pred_sph_full", "pred_proj_sph_full", "pred_voxel"):
        assert _rel(got[key], ref[key]) < 1e-4, key


def test_renderer_agrees_with_the_ports_plain_version():
    from genre_shapehd_tpu_torch.ops import render_spherical_fast
    vox = inputs.solids(2, 32, weights.generator(1, "inputs", CPU), CPU)
    vox = vox.clamp(1e-5, 1 - 1e-5)
    got = render_spherical_fast(vox, 32, 64)
    ref = geometry.render(vox, 32, 64)
    assert _rel(got, ref) < 1e-5


def test_genre_joint_step_agrees_with_the_port(genre):
    from genre_shapehd_tpu_torch.models.genre_full import Model
    from genre_shapehd_tpu_torch.models.base import default_opt
    _, w, _ = genre
    opt = default_opt(device="cpu", lr=1e-4, joint_train=True,
                      pred_depth_minmax=True, **G)
    model = Model(opt)
    model.init_state(0)
    model.net.load_state_dict(w)
    batches = [inputs.genre_batch(2, G["im_size"], G["vox_res"],
                                  G["sph_res"], G["padding_margin"],
                                  weights.generator(s, "inputs", CPU), CPU)
               for s in (1, 2)]
    named = list(model.net.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    losses = []
    for k, b in enumerate(batches):
        losses.append({n: float(v) for n, v in model.train_step(b).items()})
        if k == 0:
            grads = drive.first_gradients(model.optimizer, named, 0.5)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    ref = models.genre_steps(w, batches, dict(
        params=[n for n, _ in named], lr=1e-4, betas=(0.5, 0.9),
        joint_w25d=0.01, surface_weight=1.0, sizes=SIZES), precision.exact)
    nums = drive.train_numbers((losses, grads, change), ref)
    change_median = statistics.median(drive.leaf_gaps(
        change, ref[2], drive.moving(ref[1])))
    # float32 on both sides.  A gradient through the backprojections'
    # distance to a voxel centre turns with the side of the centre a
    # point lands on, and the two sides round apart: the first gradient
    # parts by ~1 % on the worst leaf, the second step's by more on small
    # BatchNorm leaves, and the second step's smallest loss terms follow
    assert nums["loss_gap"] < 1e-3, nums
    assert nums["grad_gap"] < 0.05 and change_median < 0.05, \
        (nums, change_median)


def test_shapehd_test_path_agrees_with_the_port():
    from genre_shapehd_tpu_torch.models.marrnet import marrnet1_net
    from genre_shapehd_tpu_torch.models.marrnet2 import Marrnet2Net
    from genre_shapehd_tpu_torch.nn import VoxelDiscriminator
    m1, m2, d = (marrnet1_net(64).eval(),
                 Marrnet2Net(vox_res=32, silhou_thres=30.0).eval(),
                 VoxelDiscriminator(64, 32).eval())
    w = {k: weights.seeded(m, 9, CPU, offset=i) for i, (k, m) in
         enumerate((("marrnet1", m1), ("net", m2), ("net_d", d)))}
    w["net_noft"] = w["net"]
    rgb = inputs.photos(2, 64, weights.generator(9, "inputs", CPU),
                        CPU)["rgb"]
    weights.calibrate_marrnet1(w["marrnet1"], rgb)
    for key, m in (("marrnet1", m1), ("net", m2), ("net_d", d)):
        m.load_state_dict(w[key])
    with torch.no_grad():
        maps = m1(rgb)
        vox = m2(maps["depth"], maps["normal"], maps["silhou"])
        score = d(torch.sigmoid(vox))
        ref = models.shapehd_test(w, rgb, precision.exact, 32, 30.0)
    fg = float((maps["silhou"] > 30).float().mean())
    assert 0.05 < fg < 0.95
    assert _rel(maps["depth"], ref["depth"]) < 1e-4
    assert _rel(vox, ref["voxel"]) < 1e-4
    assert _rel(score, ref["is_real"]) < 1e-4


def test_fp8_rounds_values_and_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = precision.fp8(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.1 * 3
    (g,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
    assert torch.isfinite(g).all()
    assert nets.Net({}, precision.exact).get("missing") is None
