"""ShapeHD's fine-tuning (``finetune_shapehd.sh``): one caller drives
``shapehd.Model.train_step`` on device batches prepared at set-up, as the
Trainer's prefetch thread hands them over, and reads each step's loss
terms (``loss``, ``sup``, ``gan``) on the host, as ``cli.train`` logs
them.  MarrNet-2 runs in train mode on the masked depth and normal
(K3 its last layer); the frozen critic scores the sigmoid of its logits
(K6 its first layer) and passes the loss's gradient back to them (K6's
backward, on K3); Adam updates MarrNet-2.

The model is built as ``cli.train`` builds it: from the cell's command
line (``cli/options.py::parse_train``), the configuration's sizes,
``--w_gan_loss`` and ``--lr``, and the checkpoints the benchmark writes at
set-up under ``TMPDIR`` (``--marrnet2``, and ``--gan`` with the critic
in its second slot, the generator's left empty), with the benchmark's
weights.  The batches
(the depth, normal and silhouette of ``inputs.genre_batch``'s photos,
its solid voxels as ``voxel_canon``) are made on the device from the
seed; the window walks through a pool of ``pool``.

Set-up drives the model through its first three steps with the window's
own call on three different batches, then takes the gradient of the
critic's term of the loss with respect to the logits of step 1 through
the program's critic.  Checked against the float32 reference
(``reference/shapehd_finetune.py``) from the same weights and batches:
each step's loss terms (``loss_gap``; the ``gan`` term, whose scores
cancel, against the summed magnitudes of the critic's last products),
each MarrNet-2 parameter's first gradient and change over the three
steps (``grad_gap``, ``change_gap``), by the worst term or leaf; and the
critic term's gradient on the program's own logits, relative L2
(``critic_grad``: the term is a share of ``w_gan_loss`` of the step's
gradient, so a fault in the critic's backward would hide in the
leaves').  Both leaf numbers leave out the leaves whose reference
gradient is under a thousandth of the median leaf's (``drive.moving``):
the decoder's biases, each before a train-mode BatchNorm, whose exact
gradient is 0, so that their reading is round-off alone.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from types import SimpleNamespace

import drive
import harness
import inputs
import weights
from reference import precision
from reference import shapehd_finetune as ref_step

KIND = "train"
#: the end-to-end rate the window reports
RATE = "train_samples_per_s"
CHECKED_STEPS = 3
#: the ``inputs.genre_batch`` entries a step reads, under their names in
#: the step's batch
FEED = {"depth": "depth", "normal": "normal", "silhou": "silhou",
        "voxel": "voxel_canon"}


def setup(ctx):
    torch, cfg, wl, seed, dev = (ctx[k] for k in
                                 ("torch", "cfg", "wl", "seed", "device"))
    from genre_shapehd_tpu_torch.cli import options
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.marrnet2 import Marrnet2Net
    from genre_shapehd_tpu_torch.nn import VoxelDiscriminator
    from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel
    res, b, pool = cfg["vox_res"], wl["batch"], wl["pool"]
    if pool < CHECKED_STEPS:
        raise ValueError(f"a pool of {pool} batches: the {CHECKED_STEPS} "
                         "steps checked take one each")
    layouts = {"net": Marrnet2Net(cfg["encode_dims"], cfg["decoder_nf"],
                                  res),
               "net_d": VoxelDiscriminator(cfg["critic_nf"], res)}
    w = {k: weights.seeded(m, seed, dev, offset=i)
         for i, (k, m) in enumerate(layouts.items())}
    del layouts
    write = harness.driver("shapehd_infer")._write
    tmp = tempfile.mkdtemp(prefix="bench_port_", dir=os.environ.get(
        "TMPDIR"))
    try:
        files = (os.path.join(tmp, "marrnet2.pt"),
                 os.path.join(tmp, "wgangp.pt"))
        write(files[0], [w["net"]], ["net"])
        # ShapeHD reads a WGAN-GP checkpoint's critic alone
        write(files[1], [{}, w["net_d"]], ["net_g", "net_d"])
        argv = drive.argv(cfg, wl, dev) + [
            "--marrnet2", files[0], "--gan", files[1], "--w_gan_loss",
            str(cfg["w_gan_loss"]), "--lr", str(cfg["lr"])]
        opt, _ = options.parse_train(argv)
        model = get_model(opt.net)(opt)
        model.init_state(0)
    finally:
        shutil.rmtree(tmp)
    data = inputs.genre_batch(b * pool, cfg["im_size"], res, 1, 1,
                              weights.generator(seed, "inputs", dev), dev)
    feed = [{FEED[k]: data[k][i * b:(i + 1) * b] for k in FEED}
            for i in range(pool)]
    st = SimpleNamespace(torch=torch, cfg=cfg, wl=wl, dev=dev, opt=opt,
                         model=model, feed=feed, losses=[],
                         w0={k: v.to("cpu", copy=True)
                             for k, v in w["net"].items()},
                         w_d={k: v.to("cpu", copy=True)
                              for k, v in w["net_d"].items()})
    del w, data
    named = list(model.net.named_parameters())
    seen = []
    hook = model.net.register_forward_hook(
        lambda m, args, out: seen.append(out.detach().float().clone()))
    subpixel_kernel.reset_launches()
    for k in range(CHECKED_STEPS):
        st.losses.append(_train(st, k))
        if k == 0:
            hook.remove()
            # K3's calls in a step, as the program makes them (a program
            # whose critic stem has no backward on K3 makes one)
            st.k3_calls = dict(subpixel_kernel.cube_launches)
            st.grads = drive.first_gradients(model.optimizer, named,
                                             opt.adam_beta1)
    st.change = {n: float((p.detach().cpu() - st.w0[n]).norm())
                 for n, p in named}
    st.logits = seen[0]
    st.critic_grad = _program_critic_grad(st)
    return st


def _train(st, k):
    terms = st.model.train_step(st.feed[k % len(st.feed)])
    return {name: float(v) for name, v in terms.items()}


def _program_critic_grad(st):
    """The gradient of ``-w_gan_loss * mean D(sigmoid(logits))`` with
    respect to step 1's logits through the program's critic, on the
    host."""
    torch, model = st.torch, st.model
    x = st.logits.clone().requires_grad_(True)
    gan = -model.critic(x).float().mean() * model.w_gan_loss
    (g,) = torch.autograd.grad(gan, x)
    return g.cpu()


def step(st, i):
    _train(st, i + CHECKED_STEPS)


def min_iters(st):
    return 1


def release(st):
    st.model = None


def _ref_opt(st):
    return dict(params=[k for k in st.w0 if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))],
        lr=st.opt.lr, betas=(st.opt.adam_beta1, st.opt.adam_beta2),
        w_gan_loss=st.opt.w_gan_loss, vox_res=st.cfg["vox_res"])


def _weights(st):
    return ({k: v.to(st.dev) for k, v in st.w0.items()},
            {k: v.to(st.dev) for k, v in st.w_d.items()})


def _reference(st, cast, batches=None):
    w, w_d = _weights(st)
    batches = batches or st.feed[:CHECKED_STEPS]
    with precision.float32_math():
        return ref_step.shapehd_steps(w, w_d, batches, _ref_opt(st), cast)


def _critic_grad(st, cast):
    _, w_d = _weights(st)
    with precision.float32_math():
        return ref_step.critic_grad(w_d, st.logits.to(st.dev), cast,
                                    st.cfg["vox_res"], st.opt.w_gan_loss)


def loss_gap(got, ref, scales):
    """Worst gap of a loss term over the steps, against the reference's
    term, and the ``gan`` term against its size before its scores
    cancel where that is larger."""
    worst = 0.0
    for g, r, s in zip(got, ref, scales):
        for k in r:
            den = max(abs(r[k]), s if k == "gan" else 0.0, 1e-30)
            worst = max(worst, abs(g[k] - r[k]) / den)
    return worst


def _numbers(got, ref, grad, grad_ref):
    (gl, gg, gc), (rl, rg, rc, scales) = got, ref
    grad_ref = grad_ref.float()
    moving = drive.moving(rg)
    return {"loss_gap": loss_gap(gl, rl, scales),
            "grad_gap": max(drive.leaf_gaps(gg, rg, moving)),
            "change_gap": max(drive.leaf_gaps(gc, rc, moving)),
            "critic_grad": float((grad.to(grad_ref.device).float()
                                  - grad_ref).norm()
                                 / grad_ref.norm().clamp(min=1e-30))}


def check(st):
    return _numbers((st.losses, st.grads, st.change),
                    _reference(st, precision.exact), st.critic_grad,
                    _critic_grad(st, precision.exact))


def control(st):
    """The control's numbers: the reference's steps, and its critic's
    gradient, in fp8 in the program's place."""
    fp8 = _reference(st, precision.fp8)
    return _numbers(fp8[:3], _reference(st, precision.exact),
                    _critic_grad(st, precision.fp8),
                    _critic_grad(st, precision.exact))


def trace_info(st):
    """Per step: the model's operations (one reference step's forward and
    backward, counted at a batch of 2 and scaled; the counter counts the
    transposed convolution that K3 computes and the convolution and its
    input gradient that K6 and its backward compute, so neither kernel is
    added again), K3's calls (the decoder's last layer and the stem's
    backward) and the stem's shape."""
    cfg, b, res = st.cfg, st.wl["batch"], st.cfg["vox_res"]
    two = [{k: v[:2] for k, v in st.feed[0].items()}]
    flops = drive.count_flops(lambda: _reference(st, precision.exact, two))
    return {"flops_per_iter": flops * b / 2,
            "deconv_final_calls": [(*shape, cfg["dtype"]) for shape, n in
                                   sorted(st.k3_calls.items())
                                   for _ in range(n)],
            "critic_stem_calls": [(b, res, cfg["dtype"])],
            "dtype": cfg["dtype"]}
