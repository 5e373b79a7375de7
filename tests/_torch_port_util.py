"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_port_*).

Seeded numpy inputs feed both the JAX package and the port.  Random
weights put net1's depth and net2's spherical map far outside the unit
cube, which would leave both backprojections empty; :func:`calibrate`
rescales three output layers so that the geometry between the nets sees
many points inside the cube.  :func:`exact_flax_variance`,
:func:`grad_agreement`, :func:`jax_step` and :func:`check_step` serve
the train-step tests.
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


def release_memory():
    """Let go of what a test module leaves behind in its worker: JAX's
    compiled programs, unreachable objects, and the C heap's free pages
    (glibc keeps them otherwise: ~3.5 GB after the MarrNet tests)."""
    import ctypes
    import gc
    import jax
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):      # not glibc
        pass


def to_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def f64(tree):
    import jax
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def jax_step(jm, state, batch, dtype="float64"):
    """JAX's loss terms, gradients, predictions and new BatchNorm
    statistics of one train step at ``state`` (``jm._loss(params,
    batch_stats, batch, train)``), with Flax's two-pass batch variance, in
    ``dtype`` (``jm``'s net cloned to it).  float64 for GenRe's nets: at
    64² JAX's own float32 rounding moves a small gradient tensor of
    MarrNet-1 by 1.5 % of its norm, the port's float32 by 0.07 %, while
    both packages agree to 2e-8 in float64
    (``tools/probe_grad_precision.py``).  XLA's CPU convolutions in
    float64 take 25 s for MarrNet-2's step, which float32 holds as
    closely as the tests need."""
    import jax
    import jax.numpy as jnp
    cast = f64 if dtype == "float64" else to_np
    jm.net = jm.net.clone(dtype=getattr(jnp, dtype))
    with jax.enable_x64(dtype == "float64"), exact_flax_variance():
        grads, (loss, stats, pred) = jax.jit(
            jax.grad(jm._loss, has_aux=True), static_argnums=3)(
                cast(state.params["net"]), cast(state.batch_stats["net"]),
                cast(batch), True)
        return to_np(dict(grads=grads, loss=loss, stats=stats, pred=pred))


def check_step(net, ref, before, got, lr, bounds):
    """Loss terms (rtol 1e-4), gradients per tensor under each prefix of
    ``bounds`` (cosine, norm-ratio bounds; None: exactly 0 in both),
    BatchNorm statistics (2e-3 of their scale) and the first Adam step
    (within 1e-6 lr + 2^-22 |p|) of ``net`` against the JAX step
    ``ref``."""
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    assert sorted(got) == sorted(ref["loss"])
    for k, v in ref["loss"].items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    ref_sd = jax_to_torch(ref["grads"], {})
    for prefix, bound in bounds.items():
        if bound is None:
            for n, p in net.named_parameters():
                if n.startswith(prefix):
                    assert not p.grad.any() and not ref_sd[n].any(), n
            continue
        cos, ratio, stray = grad_agreement(net, ref["grads"], prefix)
        assert cos >= bound[0] and ratio <= bound[1], (prefix, cos, ratio)
        assert stray <= 1e-4, (prefix, stray)
    sd = net.state_dict()
    for k, v in jax_to_torch({}, ref["stats"]).items():
        if "running_" in k:
            scale = float(v.abs().max()) + 1e-6
            err = float((sd[k] - v).abs().max()) / scale
            assert err <= 2e-3, (k, err)
    for k, p in net.named_parameters():
        step = -lr * p.grad / (p.grad.abs() + 1e-8)
        slack = 1e-6 * lr + 2.0 ** -22 * before[k].abs()
        assert bool(((sd[k] - before[k] - step).abs() <= slack).all()), k


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


def procedural_batch(jm, tm, n):
    """The first ``n`` training samples of each package's procedural
    dataset (the same scenes), collated, as arrays; they must be equal."""
    from genre_shapehd_tpu.data import procedural as jax_procedural
    from genre_shapehd_tpu.data.loader import collate as jax_collate
    from genre_shapehd_tpu_torch.core.registry import get_dataset
    from genre_shapehd_tpu_torch.data.loader import collate
    out = []
    for pkg, model, make in ((jax_procedural.Dataset, jm, jax_collate),
                             (get_dataset("procedural"), tm, collate)):
        ds = pkg(model.opt, "train", model=model)
        b = make([ds[i] for i in range(n)])
        out.append({k: v for k, v in b.items() if isinstance(v, np.ndarray)})
    ref, got = out
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    return got


def save_jax_state(path, jm, state, epoch=0, loss_eval=0.0,
                   with_optimizers=True):
    """``state`` as the JAX ``Trainer`` checkpoints it (without the
    optimizers' states unless ``with_optimizers``)."""
    from genre_shapehd_tpu.core.checkpoint import save_checkpoint
    from genre_shapehd_tpu.train.state import state_to_reference_payload
    save_checkpoint(path, state_to_reference_payload(
        state, jm.net_names, jm.optimizer_names if with_optimizers else [],
        epoch, loss_eval))


def photo(h, w, seed):
    """A shaded ellipsoid on white, and its mask (uint8)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    cy, cx = rng.uniform(0.4, 0.6) * h, rng.uniform(0.4, 0.6) * w
    ry, rx = rng.uniform(0.2, 0.35) * h, rng.uniform(0.2, 0.35) * w
    u, v = (xx - cx) / rx, (yy - cy) / ry
    inside = u * u + v * v < 1.0
    nz = np.sqrt(np.clip(1.0 - u * u - v * v, 0.0, 1.0))
    light = np.array([-0.4, -0.5, 0.77])
    shade = np.clip(-u * light[0] - v * light[1] + nz * light[2], 0, 1)
    color = rng.uniform(0.2, 0.9, 3)
    rgb = np.where(inside[..., None], (0.15 + 0.85 * shade)[..., None]
                   * color, 1.0)
    return ((rgb * 255).round().astype(np.uint8),
            (inside * 255).astype(np.uint8))


def write_photos(d, n):
    """``n`` photos ``NN_rgb.png`` and masks ``NN_silhouette.png``."""
    import os
    from genre_shapehd_tpu_torch.data import png
    os.makedirs(d)
    for i in range(n):
        rgb, mask = photo(90 + 7 * i, 120 - 5 * i, 100 + i)
        png.write_png(os.path.join(d, f"{i:02d}_rgb.png"), rgb)
        png.write_png(os.path.join(d, f"{i:02d}_silhouette.png"), mask)


def jax_test_outputs(net, opt, out_dir):
    """The JAX package's ``ModelTest.test_on_batch`` over the test set of
    ``opt`` (its ``input_rgb`` / ``input_mask``; ``vis_workers`` 0), into
    ``out_dir``."""
    from genre_shapehd_tpu.core.registry import get_dataset, get_model
    from genre_shapehd_tpu.data.loader import DataLoader
    opt.output_dir = out_dir
    mt = get_model(net, test=True)(opt)
    ds = get_dataset("test")(opt, model=mt)
    for i, batch in enumerate(DataLoader(ds, opt.batch_size, shuffle=False,
                                         num_workers=2, drop_last=False)):
        mt.test_on_batch(i, batch)

