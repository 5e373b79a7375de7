"""PyTorch port, the slice as a whole: GenreNet's forward against the JAX
GenreNet at the reduced scale of tests/test_e2e_fixtures.py (im 64, vox
32, sph 32, z 32), float32, on shared weights."""

import numpy as np
import jax
import torch

from genre_shapehd_tpu.models.genre_full import GenreNet as JaxGenreNet
from genre_shapehd_tpu_torch.core.convert import jax_to_torch, torch_to_jax
from genre_shapehd_tpu_torch.models.genre_full import GenreNet
from genre_shapehd_tpu_torch.nn import init_weights

from _torch_port_util import TINY, calibrate, scene_inputs

torch.set_num_threads(2)


def test_genre_forward_matches_jax():
    rgb, sil = scene_inputs(2, TINY["im_size"], seed=0)
    net = GenreNet(**TINY).eval()
    init_weights(net, torch.Generator().manual_seed(0))
    params, stats = calibrate(*torch_to_jax(net.state_dict()), rgb, sil)

    jax_net = JaxGenreNet(**TINY)
    ref = jax.jit(lambda p, s, r, m: jax_net.apply(
        {"params": p, "batch_stats": s}, r, m, train=False))(
            params, stats, rgb, sil)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    net.load_state_dict(jax_to_torch(params, stats))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in
               net(torch.from_numpy(rgb), torch.from_numpy(sil)).items()}

    for k in ("depth", "normal", "silhou", "depth_minmax", "proj_depth",
              "pred_sph_partial", "pred_sph_full", "pred_proj_sph_full",
              "pred_voxel"):
        assert got[k].shape == ref[k].shape, k
    # the geometry really runs: many voxels hit by both backprojections
    hit = ref["proj_depth"] > ref["proj_depth"].min()
    assert hit.sum() > 500, hit.sum()
    assert (ref["pred_proj_sph_full"] != 0).sum() > 200

    def report(k):
        d = np.abs(got[k] - ref[k])
        return d, float(np.abs(ref[k]).max())

    # net1's outputs: float32 convs in another summation order
    for k in ("depth", "normal", "silhou", "depth_minmax"):
        d, scale = report(k)
        assert d.max() <= 2e-5 * scale, (k, d.max(), scale)
    # proj_depth = 50 * (1 - 32 * tdf): a point whose depth moves by a few
    # ulp can cross a voxel face under floor(), which moves its whole
    # contribution to the neighbouring voxel.  So: nearly all voxels agree
    # to 1e-3, and the few that do not stay rare
    for k, frac in (("proj_depth", 0.999), ("pred_sph_partial", 0.999),
                    ("pred_sph_full", 0.999), ("pred_proj_sph_full", 0.999),
                    ("pred_voxel", 0.999)):
        d, scale = report(k)
        close = d <= 1e-3 * max(scale, 1.0)
        assert close.mean() >= frac, (k, close.mean(), d.max(), scale)
        assert d.mean() <= 1e-3 * max(scale, 1.0), (k, d.mean(), scale)
