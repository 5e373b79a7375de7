"""PyTorch port, the exact spherical renderer against the JAX package on
the CPU, float32: ``ops.grid_sample_3d`` (trilinear, align_corners=True,
zero padding) on a volume whose three axes differ, ``ops.render_spherical``
and its gradient with respect to the volume at 32³ (sph_res 16, z_res
64), ``--exact_render`` in the stage-2 and full GenRe nets at 64² -> 32³
on shared weights, and ``utils.sph_eval.render_spherical_from_depth``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genre_shapehd_tpu import ops as jops
from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.utils import sph_eval as jax_sph_eval
from genre_shapehd_tpu_torch import ops
from genre_shapehd_tpu_torch.core.convert import torch_to_jax
from genre_shapehd_tpu_torch.core.registry import get_model
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.utils import sph_eval

from _torch_port_util import calibrate, procedural_batch, release_memory

torch.set_num_threads(4)
STAGED = dict(im_size=64, vox_res=32, sph_res=32, z_res=64,
              padding_margin=16)


@pytest.fixture(autouse=True, scope="module")
def _no_disk_cache():
    from genre_shapehd_tpu.data import procedural as jax_procedural
    from genre_shapehd_tpu_torch.data import procedural
    with pytest.MonkeyPatch.context() as mp:
        for mod in (procedural, jax_procedural):
            mp.setattr(mod.Dataset, "disk_cache_dir", "")
        yield
    release_memory()


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_grid_sample_3d_matches_jax_on_an_asymmetric_volume():
    """Component 0 of a point indexes the volume's first axis: at the grid
    nodes the samples are the voxels themselves, and random points (some
    outside [-1, 1]) give JAX's values.  A volume of shape (5, 7, 9) makes
    any other order of the components fail both checks."""
    rng = np.random.default_rng(0)
    vol = rng.random((2, 5, 7, 9)).astype(np.float32)
    idx = np.stack(np.meshgrid(np.arange(5), np.arange(7), np.arange(9),
                               indexing="ij"), -1)
    nodes = (2.0 * idx / (np.array([5, 7, 9]) - 1) - 1.0).astype(np.float32)
    nodes = np.broadcast_to(nodes, (2,) + nodes.shape).copy()
    got = ops.grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(nodes))
    np.testing.assert_allclose(got.numpy(), vol, rtol=0, atol=1e-6)

    pts = (rng.random((2, 6, 10, 3)) * 3.4 - 1.7).astype(np.float32)
    ref = np.asarray(jops.grid_sample_3d(jnp.asarray(vol), jnp.asarray(pts)))
    got = ops.grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(pts))
    assert got.shape == ref.shape == (2, 6, 10)
    assert (ref == 0).any()                      # some points outside
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_render_spherical_and_its_gradient_match_jax():
    """Forward within 1e-5 and the gradient of a weighted sum with
    respect to the volume within 1e-5 of its largest magnitude, at 32³,
    sph_res 16, z_res 64, float32, on a clipped random volume with a
    solid ball in it."""
    rng = np.random.default_rng(1)
    v = 32
    c = (np.arange(v) + 0.5) / v - 0.5
    ball = (c[:, None, None] ** 2 + c[None, :, None] ** 2
            + c[None, None] ** 2) < 0.09
    vox = np.clip(rng.random((2, v, v, v)) * 0.3 + ball * 0.8, 1e-5,
                  1 - 1e-5).astype(np.float32)
    w = rng.standard_normal((2, 16, 16)).astype(np.float32)

    def loss(x):
        return jnp.sum(jops.render_spherical(x, 16, 64) * w)
    ref_out = np.asarray(jops.render_spherical(jnp.asarray(vox), 16, 64))
    ref_grad = np.asarray(jax.grad(loss)(jnp.asarray(vox)))

    x = torch.from_numpy(vox).requires_grad_()
    out = ops.render_spherical(x, 16, 64)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == (2, 16, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=0,
                               atol=1e-5)
    scale = float(np.abs(ref_grad).max())
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=0,
                               atol=1e-5 * scale)


def _stage2_weights():
    """Seeded JAX stage-2 weights, calibrated so that the geometry sees
    the cube (``calibrate``), and a procedural batch."""
    jm = jax_model("depth_pred_with_sph_inpaint")(jax_opt(
        **STAGED, exact_render=True, no_aug=True, procedural_length=8))
    tm = get_model("depth_pred_with_sph_inpaint")(default_opt(
        device="cpu", **STAGED, exact_render=True, no_aug=True,
        procedural_length=8))
    state = jm.init_state(jax.random.PRNGKey(0))
    batch = procedural_batch(jm, tm, 2)
    params, stats = calibrate(_to_np(state.params["net"]),
                              _to_np(state.batch_stats["net"]),
                              batch["rgb"], batch["silhou"], cfg=STAGED,
                              stage2=True)
    return params, stats


@pytest.mark.parametrize("net", ["depth_pred_with_sph_inpaint",
                                 "genre_full_model"])
def test_exact_render_nets_match_jax(net, monkeypatch):
    """Under ``--exact_render`` the eval-mode forward gives JAX's rendered
    partial map and ``pred_sph_full`` (2e-3) and ``proj_depth`` (5e-2),
    the tolerances of ``test_torch_port_staged.py``'s oracle tests, and
    for the full net its voxels (99.9 % within 1e-3 of their scale); the
    port's kernels K1 / K2 (their plain versions here) do not run."""
    params, stats = _stage2_weights()
    jm = jax_model(net)(jax_opt(**STAGED, exact_render=True, no_aug=True,
                                procedural_length=8))
    tm = get_model(net)(default_opt(device="cpu", **STAGED,
                                    exact_render=True, no_aug=True,
                                    procedural_length=8))
    assert jm.net.exact_render and tm.exact_render
    if net == "genre_full_model":
        tm.init_state(0)
        full, full_stats = torch_to_jax(tm.net.state_dict())
        full["depth_and_inpaint"], full_stats["depth_and_inpaint"] = \
            params, stats
        params, stats = full, full_stats
    batch = procedural_batch(jm, tm, 2)
    ref, _ = jax.jit(jm._forward, static_argnums=3)(params, stats, batch,
                                                     False)
    ref = _to_np(ref)
    tm.load_weights(params, stats)
    from genre_shapehd_tpu_torch.ops.cuda import render_kernel
    calls = []
    real = render_kernel.render_expected_depth
    monkeypatch.setattr(render_kernel, "render_expected_depth",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, got = tm.eval_step(batch)
    assert not calls
    got = {k: v.numpy() for k, v in got.items()}
    assert (ref["proj_depth"] > -49.0).sum() > 200       # points in the cube
    for k, tol in (("pred_sph_partial", 2e-3), ("pred_sph_full", 2e-3),
                   ("proj_depth", 5e-2)):
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= tol, (k, err)
    if net == "genre_full_model":
        for k in ("pred_proj_sph_full", "pred_voxel"):
            d = np.abs(got[k] - ref[k]) <= 1e-3 * max(np.abs(ref[k]).max(), 1)
            assert d.mean() >= 0.999, (k, d.mean())


def test_render_spherical_from_depth_matches_jax():
    """A procedural scene's depth map and silhouette at 64² through the
    camera backprojection and the exact renderer (vox_res 32, sph_res 16,
    z_res 64): JAX's map within 1e-5; rays that hit the shape stand
    below the background's 1."""
    from genre_shapehd_tpu_torch.data.procedural import generate_sample
    s = generate_sample(11, 64, 32, 16)
    pack = {"depth": s["depth"][None, ..., None],
            "depth_minmax": s["depth_minmax"]}
    kw = dict(sph_res=16, z_res=64, vox_res=32)
    ref = jax_sph_eval.render_spherical_from_depth(pack, s["silhou"], **kw)
    got = sph_eval.render_spherical_from_depth(pack, s["silhou"],
                                               device="cpu", **kw)
    assert got.shape == ref.shape == (16, 16)
    assert (ref < 0.99).sum() > 10
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(sph_eval.make_sgrid(8),
                                  jax_sph_eval.make_sgrid(8))
