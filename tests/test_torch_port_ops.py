"""PyTorch port, geometry ops: each against its JAX counterpart on the same
seeded numpy inputs, in float32."""

import numpy as np
import jax.numpy as jnp
import torch

from genre_shapehd_tpu import ops as jops
from genre_shapehd_tpu.ops import camera_bp as jcam
from genre_shapehd_tpu_torch import ops as tops
from genre_shapehd_tpu_torch.ops import camera_bp as tcam

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_coords_match_jax():
    rng = np.random.default_rng(0)
    img = rng.random((2, 5, 7)).astype(np.float32)
    vox = rng.random((2, 4, 5, 6)).astype(np.float32)
    # pure index permutations: exact
    np.testing.assert_array_equal(
        tops.coords.depth_image_to_cambp_frame(_t(img)).numpy(),
        np.asarray(jops.coords.depth_image_to_cambp_frame(jnp.asarray(img))))
    for name in ("gt_voxel_to_train_frame", "train_frame_to_gt_voxel"):
        np.testing.assert_array_equal(
            getattr(tops.coords, name)(_t(vox)).numpy(),
            np.asarray(getattr(jops.coords, name)(jnp.asarray(vox))))
    back = tops.coords.train_frame_to_gt_voxel(
        tops.coords.gt_voxel_to_train_frame(_t(vox)))
    np.testing.assert_array_equal(back.numpy(), vox)


def test_sph_grid_and_pad_match_jax():
    for res in (8, 32, 128):
        # same numpy arithmetic on both sides: exact
        np.testing.assert_array_equal(tops.gen_sph_grid(res),
                                      jops.gen_sph_grid(res))
    rng = np.random.default_rng(1)
    sph = rng.random((2, 12, 12, 1)).astype(np.float32)
    for m in (1, 4, 12):
        np.testing.assert_array_equal(
            tops.sph_pad(_t(sph), m).numpy(),
            np.asarray(jops.sph_pad(jnp.asarray(sph), m)))


def test_stop_probability_matches_jax():
    rng = np.random.default_rng(2)
    p = np.clip(rng.random((3, 4, 50)), 1e-5, 1 - 1e-5).astype(np.float32)
    for axis in (-1, 1):
        got = tops.stop_probability(_t(p), dim=axis).numpy()
        ref = np.asarray(jops.stop_probability(jnp.asarray(p), axis=axis))
        # a cumprod of up to 50 float32 factors: ~1 ulp per factor
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def _depths(n, h, w, seed):
    """Ray depths around the camera distance, so most pixels land inside
    the cube; a few discarded (<0) and background (0) pixels."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.8, 2.6, (n, h, w)).astype(np.float32)
    d[:, :3] = 0.0
    d[:, -2:, :5] = -1.0
    return d


def test_camera_backprojection_matches_jax():
    res = 32
    depth = _depths(2, 48, 48, 3)
    n = depth.shape[0]
    glob_j = jcam._camera_glob_coords(
        jnp.asarray(depth), jnp.full((n,), jops.FL_GENRE, jnp.float32),
        jnp.full((n,), jops.CAM_DIST, jnp.float32))
    glob_t = tcam._camera_glob_coords(_t(depth), tcam.FL_GENRE, tcam.CAM_DIST)
    # XLA evaluates -d * w / fl in another order for some pixels: 1-2 ulp
    # of coordinates up to 2.6 in magnitude
    np.testing.assert_allclose(glob_t.numpy(), np.asarray(glob_j),
                               rtol=0, atol=1e-6)
    valid = (depth >= 0).reshape(n, -1)
    tdf_j, cnt_j = jcam._scatter_mean_tdf(jnp.asarray(glob_j),
                                          jnp.asarray(valid), res, 1.0 / res)
    tdf_t, cnt_t = tcam._scatter_mean_tdf(_t(np.asarray(glob_j)), _t(valid),
                                          res, 1.0 / res)
    cnt_j = np.asarray(cnt_j)
    assert (cnt_j > 0).sum() > 1000          # many voxels hit
    # hit counts are integers: exact
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_j)
    # mean of distances, summed in another order: ~1e-6
    np.testing.assert_allclose(tdf_t.numpy(), np.asarray(tdf_j),
                               rtol=0, atol=1e-6)
    shifted_j = np.asarray(jops.camera_backproject_shifted(
        jnp.asarray(depth), jops.FL_GENRE, jops.CAM_DIST, res))
    shifted_t = tops.camera_backproject_shifted(_t(depth), res=res).numpy()
    # 1 - res * tdf scales the ~1e-6 distance error by res
    np.testing.assert_allclose(shifted_t, shifted_j, rtol=0, atol=res * 2e-6)


def test_spherical_backprojection_matches_jax():
    res, r, margin = 32, 24, 4
    rng = np.random.default_rng(4)
    sph = rng.uniform(0.0, 0.7, (2, r, r)).astype(np.float32)
    sph[:, :2] = -0.5                        # discarded pixels
    tdf_j, cnt_j = jops.spherical_backproject(jnp.asarray(sph), res=res)
    tdf_t, cnt_t = tops.spherical_backproject(_t(sph), res=res)
    cnt_j = np.asarray(cnt_j)
    assert (cnt_j > 0).sum() > 500
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_j)
    np.testing.assert_allclose(tdf_t.numpy(), np.asarray(tdf_j),
                               rtol=0, atol=1e-6)
    full = rng.uniform(0.3, 1.3, (2, r + 2 * margin, r + 2 * margin))
    full = full.astype(np.float32)
    ref = np.asarray(jops.backproject_spherical_masked(
        jnp.asarray(full), margin, res))
    got = tops.backproject_spherical_masked(_t(full), margin, res).numpy()
    assert (ref != 0).sum() > 500
    # (-df + 1/res) * res scales the ~1e-6 distance error by res
    np.testing.assert_allclose(got, ref, rtol=0, atol=res * 2e-6)
