"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_port_*).

Seeded numpy inputs feed both the JAX package and the port.  Random
weights put net1's depth and net2's spherical map far outside the unit
cube, which would leave both backprojections empty; :func:`calibrate`
rescales three output layers so that the geometry between the nets sees
many points inside the cube.  :func:`exact_flax_variance` and
:func:`grad_agreement` serve the train-step tests.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

#: the reduced scale of tests/test_e2e_fixtures.py::tiny_opt
TINY = dict(im_size=64, vox_res=32, sph_res=32, z_res=32, padding_margin=16)


def scene_inputs(n: int, size: int, seed: int):
    """(rgb (n,size,size,3) ~ N(0,1), silhou (n,size,size,1) in {0,100})
    with a disc-shaped silhouette per sample."""
    rng = np.random.default_rng(seed)
    rgb = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[:size, :size]
    sil = np.zeros((n, size, size, 1), np.float32)
    for i in range(n):
        cy, cx = rng.uniform(0.4, 0.6, 2) * size
        r = rng.uniform(0.25, 0.35) * size
        sil[i, ..., 0] = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r) * 100.0
    return rgb, sil


def exact_flax_variance():
    """Flax's batch statistics with the two-pass variance (the JAX
    reference of the train-step tests)."""
    import flax.linen.normalization as flax_norm
    orig = flax_norm._compute_stats

    def exact(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return orig(*args, **kwargs)
    return mock.patch.object(flax_norm, "_compute_stats", exact)


def grad_agreement(net, ref_grads, prefix):
    """Over the parameters under ``prefix`` whose reference gradient is not
    negligible: the worst cosine and the worst distance of the norm ratio
    from 1; and the largest port gradient norm, relative to the largest
    reference one, where it is negligible (expected 0: biases ahead of a
    BatchNorm)."""
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    ref = jax_to_torch(ref_grads, {})
    params = [(n, p) for n, p in net.named_parameters()
              if n.startswith(prefix)]
    norms = {n: float(np.linalg.norm(ref[n].numpy())) for n, _ in params}
    big = max(norms.values())
    cos_min, ratio_err, stray = 1.0, 0.0, 0.0
    for n, p in params:
        g = p.grad.numpy().ravel()
        r = ref[n].numpy().ravel()
        if norms[n] <= 1e-6 * big:
            stray = max(stray, float(np.linalg.norm(g)) / big)
            continue
        cos_min = min(cos_min, float(g @ r) / (np.linalg.norm(g)
                                               * norms[n]))
        ratio_err = max(ratio_err, abs(np.linalg.norm(g) / norms[n] - 1))
    return cos_min, ratio_err, stray


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def calibrate(params, batch_stats, rgb, sil, cfg=TINY, train=False,
              stage2=False):
    """Copies of the JAX-layout trees with (1) the min/max head fixed to
    (1.2, 2.2), (2) net1's depth decoder scaled to output std 30 and (3)
    net2's spherical decoder scaled to output std 1, measured with the
    port's GenreNet on ``rgb``/``sil`` (``stage2``: the trees of the
    stage-2 net alone, measured with its DepthInpaintNet): in eval mode,
    or with ``train`` as a joint train step runs it (every BatchNorm on
    batch statistics)."""
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    from genre_shapehd_tpu_torch.models.depth_inpaint import DepthInpaintNet
    from genre_shapehd_tpu_torch.models.genre_full import GenreNet

    params = _copy(params)
    prefix = "" if stage2 else "depth_and_inpaint/"
    net1 = prefix + "net1/"
    head = _get(params, net1 + "MinmaxHead_0/Dense_2")
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.array([1.2, 2.2], np.float32)
    net = (DepthInpaintNet if stage2 else GenreNet)(
        **cfg, joint_train=train).train(train)
    for path, key, target in (
            (net1 + "decoder_depth/Deconv_1/ConvTranspose_0", "depth", 30.0),
            (prefix + "net2/decoder_spherical/Deconv_1/ConvTranspose_0",
             "pred_sph_full", 1.0)):
        net.load_state_dict(jax_to_torch(params, batch_stats))
        with torch.no_grad():
            out = net(torch.from_numpy(rgb), torch.from_numpy(sil))
        layer = _get(params, path)
        layer["kernel"] = layer["kernel"] * np.float32(
            target / float(out[key].std()))
    return params, batch_stats


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def flax_kernel_to_wcat(kernel: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose kernel (4, 4, 4, Cin, 1) -> the phase-stacked
    ``wcat`` (2, 2, 2, Cin, 8) that ``deconv_final_fused`` takes, built as
    ``SubpixelTConv3D`` builds it: phase (a, b, c) holds the taps
    ``kernel[a::2, b::2, c::2]``, phases concatenated on the last axis."""
    phases = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    return np.concatenate([kernel[a::2, b::2, c::2] for a, b, c in phases],
                          axis=-1)


def decode_records(rec: torch.Tensor, dtype: torch.dtype,
                   z_res: int) -> dict:
    """The renderer's tap records (``render_kernel.tap_records``) back to
    ``tap_tables``' form over the first ``z_res`` samples: z_lo, m_lo
    int32 (Ph, S), z_w, m_w float32 (Ph, S, 2)."""
    ph, n_w = rec.shape[:2]
    r = rec.numpy().transpose(0, 2, 1, 3).reshape(ph, -1, n_w)[:, :z_res]
    if dtype == torch.float32:
        f = r[..., 2:].view(np.float32)
        return {"z_lo": r[..., 0], "m_lo": r[..., 1],
                "z_w": f[..., 0:2], "m_w": f[..., 2:4]}
    u = r.view(np.uint32)

    def halves(x):                       # bf16 pair -> float32 (..., 2)
        return np.stack([x << 16, x & 0xFFFF0000], -1).astype(
            np.uint32).view(np.float32)

    return {"z_lo": (u[..., 0] & 0xFFFF).astype(np.int32),
            "m_lo": (u[..., 0] >> 16).astype(np.int32),
            "z_w": halves(u[..., 1]), "m_w": halves(u[..., 2])}
