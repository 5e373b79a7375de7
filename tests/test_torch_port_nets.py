"""PyTorch port, nets: each against its Flax twin in eval mode, with the
Flax params from ``init`` carried over by ``core.convert.jax_to_torch``;
``torch_to_jax`` must give the Flax trees back exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genre_shapehd_tpu import nn as jnn
from genre_shapehd_tpu_torch import nn as tnn
from genre_shapehd_tpu_torch.core.convert import jax_to_torch, torch_to_jax

torch.set_num_threads(2)


def _flax_init(module, x):
    variables = jax.jit(lambda r: module.init(r, x, train=False))(
        jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables.get("batch_stats", {})))


def _port(module, params, stats):
    module.load_state_dict(jax_to_torch(params, stats))
    back_p, back_s = torch_to_jax(module.state_dict())
    # round trip: identical trees, bit for bit
    assert jax.tree.structure(back_p) == jax.tree.structure(params)
    assert jax.tree.structure(back_s) == jax.tree.structure(stats)
    for a, b in zip(jax.tree.leaves(params) + jax.tree.leaves(stats),
                    jax.tree.leaves(back_p) + jax.tree.leaves(back_s)):
        np.testing.assert_array_equal(a, b)
    return module.eval()


def _close(got, ref, what):
    # float32 convs summed in another order through up to ~40 layers:
    # relative to the output's scale
    scale = float(np.abs(ref).max()) + 1e-6
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert err <= 2e-5 * scale, (what, err, scale)


def _image(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


NET1 = dict(out_planes=(3, 1, 1), layer_names=("normal", "depth", "silhou"),
            pred_depth_minmax=True)


@pytest.fixture(scope="module")
def net1_vars():
    """Flax init of net1, shared: its encoder subtree is the ResNet's."""
    return _flax_init(jnn.UResNet(**NET1), jnp.zeros((1, 64, 64, 3)))


def test_resnet18_features_matches_flax(net1_vars):
    x = _image((2, 64, 64, 3), 0)
    params = net1_vars[0]["ResNet18Features_0"]
    stats = net1_vars[1]["ResNet18Features_0"]
    ref = jnn.ResNet18Features().apply(
        {"params": params, "batch_stats": stats}, x, train=False)
    net = _port(tnn.ResNet18Features(3), params, stats)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), f"level {i}")


@pytest.mark.parametrize("inpainting", [False, True])
def test_uresnet_matches_flax(inpainting, net1_vars):
    """net1 (three decoders + min/max head) and net2 (inpainting)."""
    if inpainting:
        kw = dict(out_planes=(1,), layer_names=("spherical",),
                  inpainting=True)
        x = _image((2, 64, 64, 1), 1)
        port = tnn.UResNet(1, **kw)
        params, stats = _flax_init(jnn.UResNet(**kw), jnp.asarray(x))
    else:
        kw = NET1
        x = _image((2, 64, 64, 3), 2)
        port = tnn.UResNet(3, im_size=64, **kw)
        params, stats = net1_vars
    flax_net = jnn.UResNet(**kw)
    ref = flax_net.apply({"params": params, "batch_stats": stats}, x,
                         train=False)
    net = _port(port, params, stats)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k].numpy(), np.asarray(ref[k]), k)


def test_unet3d_matches_flax():
    x = _image((2, 32, 32, 32, 2), 3)
    flax_net = jnn.UNet3D(nf=20, res=32)
    params, stats = _flax_init(flax_net, jnp.asarray(x))
    ref = np.asarray(flax_net.apply({"params": params, "batch_stats": stats},
                                    x, train=False))
    net = _port(tnn.UNet3D(nf=20, res=32), params, stats)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 32)
    _close(got, ref, "pred_voxel")
