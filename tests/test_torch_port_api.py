"""PyTorch port, the package's public names against the JAX package's on
the CPU: every name of every JAX ``__init__``'s ``__all__`` resolves in
the port's ``__init__`` of the same path, apart from the differences
listed below with their reasons; the names added last are held against
their JAX counterparts (``RevResNet18`` on carried weights, float32;
``depth_to_mesh_df``, ``to_obj_str``, the registries' aliases and
``FL_MARRNET``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genre_shapehd_tpu
from genre_shapehd_tpu import core as jcore
from genre_shapehd_tpu import nn as jnn
from genre_shapehd_tpu import ops as jops
from genre_shapehd_tpu.data import preprocess as jpp
from genre_shapehd_tpu.viz import visualizer as jvis
from genre_shapehd_tpu_torch import core as tcore
from genre_shapehd_tpu_torch import nn as tnn
from genre_shapehd_tpu_torch import ops as tops
from genre_shapehd_tpu_torch.core.convert import jax_to_torch
from genre_shapehd_tpu_torch.data import preprocess as tpp
from genre_shapehd_tpu_torch.viz import visualizer as tvis

torch.set_num_threads(2)

#: the JAX package's subpackages with an ``__all__``
SUBPACKAGES = ("core", "data", "models", "nn", "ops", "ops.pallas",
               "parallel", "train", "utils", "viz")
#: names with no counterpart of the same name in the port, and why
DIFFERENCES = {
    # GSPMD's device mesh and shardings; the port's data parallelism is
    # torch.distributed process groups (parallel/mesh.py: join, world,
    # all_reduce_batch ...), with no mesh object to shard arrays over
    **{("parallel", n): "a jax.sharding mesh helper" for n in (
        "make_mesh", "make_mesh_2d", "batch_sharding", "replicated",
        "shard_batch", "replicate_state", "maybe_shard_spatial",
        "set_active_mesh")},
    # the Pallas TPU kernels; the port's kernels are CUDA, in ops.cuda
    ("ops.pallas", "nndistance_pallas"): "ops.cuda.chamfer_kernel",
    ("ops.pallas", "nndistance_score_pallas"): "ops.cuda.chamfer_kernel",
    # a JAX pytree of params, statistics and optimizer states; the port
    # keeps the state in the model's nn.Modules and torch.optim
    ("train", "ModelState"): "state lives in nn.Module and torch.optim",
}


def _all_names():
    for sub in SUBPACKAGES:
        mod = importlib.import_module(f"genre_shapehd_tpu.{sub}")
        for name in mod.__all__:
            yield sub, name


def test_every_jax_public_name_has_a_counterpart():
    """Each name resolves in the port's module of the same path and is in
    its ``__all__``; each listed difference is a JAX name indeed, and has
    no counterpart."""
    names = list(_all_names())
    assert len(names) > 60
    missing = []
    for sub, name in names:
        if (sub, name) in DIFFERENCES:
            continue
        port = importlib.import_module(f"genre_shapehd_tpu_torch.{sub}")
        if not hasattr(port, name) or name not in port.__all__:
            missing.append(f"{sub}.{name}")
    assert missing == []
    assert set(DIFFERENCES) <= set(names)
    for sub, name in DIFFERENCES:
        try:
            port = importlib.import_module(f"genre_shapehd_tpu_torch.{sub}")
        except ImportError:
            continue
        assert not hasattr(port, name), f"{sub}.{name}"


def test_aliases_and_constants_equal_jax():
    assert tcore.model_aliases() == jcore.model_aliases()
    assert tcore.dataset_aliases() == jcore.dataset_aliases()
    assert tops.FL_MARRNET == jops.FL_MARRNET
    assert (tops.FL_GENRE, tops.CAM_DIST) == (jops.FL_GENRE, jops.CAM_DIST)
    assert genre_shapehd_tpu.__name__ == "genre_shapehd_tpu"


@pytest.mark.parametrize("train", [False, True])
def test_revresnet18_matches_jax(train):
    """The whole reverse ResNet-18 at narrow widths (16, 8, 8, 8 from a
    16-wide 8 x 8 latent to 256 x 256 x 5), float32, the Flax weights
    (BatchNorm's seeded) and seeded running statistics carried across by
    ``jax_to_torch``: eval mode, and train mode with the batch's
    statistics.  Within 1e-4 of the
    output's largest magnitude (float32 sums in another order through 20
    layers)."""
    planes = (16, 8, 8, 8)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    flax_net = jnn.RevResNet18(out_planes=5, planes=planes)
    variables = flax_net.init(jax.random.PRNGKey(3), jnp.asarray(x),
                              train=False)
    # seeded BatchNorm scales and biases (their init is 0 or 1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape)
                         if path[-1].key == "scale" else
                         rng.normal(0, 0.1, a.shape)
                         if path[-1].key == "bias" else np.asarray(a))
        .astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape)
                         if path[-1].key == "var" else
                         rng.normal(0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    if train:
        ref, _ = flax_net.apply({"params": params, "batch_stats": stats},
                                x, train=True, mutable=["batch_stats"])
    else:
        ref = flax_net.apply({"params": params, "batch_stats": stats}, x,
                             train=False)
    ref = np.asarray(ref)
    net = tnn.RevResNet18(out_planes=5, planes=planes, in_planes=16)
    net.load_state_dict(jax_to_torch(params, stats))
    net.train(train)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 256, 256, 5)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)


def test_depth_to_mesh_df_matches_jax():
    """A relative depth map in [0, 1] with background 0 and its absolute
    bounds, backprojected into a 32³ distance field by both packages on
    the CPU, float32: at least 99.9 % of the voxels equal bit for bit, the
    rest (a voxel's mean of point distances, summed in another order, and
    the recorded 1-2 ulp of ``_camera_glob_coords``) within 1e-6, the
    bound ``test_torch_port_ops.py`` holds the backprojection to."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:64, :64] / 63.0
    depth = np.clip(0.6 - (xx - 0.5) ** 2 - (yy - 0.5) ** 2
                    + rng.normal(0, 0.01, (64, 64)), 0, 1)
    depth[(xx - 0.5) ** 2 + (yy - 0.5) ** 2 > 0.15] = 0.0
    minmax = (1.6, 2.6)
    ref = np.asarray(jpp.depth_to_mesh_df(depth, minmax, vox_res=32))
    got = tpp.depth_to_mesh_df(depth, minmax, vox_res=32)
    assert got.dtype == np.float32 and got.shape == ref.shape == (32,) * 3
    assert (ref < 1.0 / 32).sum() > 100          # the surface is in the grid
    equal = got == ref
    assert equal.mean() >= 0.999, (~equal).sum()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_to_obj_str_matches_jax():
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(17, 3)).astype(np.float32)
    faces = rng.integers(0, 17, (23, 3))
    got = tvis.to_obj_str(verts, faces)
    assert got == jvis.to_obj_str(verts, faces)
    assert got.count("\nf ") == 23 and got.startswith("v ")
