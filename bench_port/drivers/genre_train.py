"""GenRe's joint fine-tuning (``finetune_genre_joint.sh``): one caller
drives ``genre_full.Model.train_step`` under ``--joint_train`` on device
batches prepared at set-up, as the Trainer's prefetch thread hands them
over, and reads each step's loss terms on the host, as ``cli.train``
logs them.  Forward and backward run through every stage: net1, the
camera backprojection, the renderer (K1 and K2; K1 and K5 again in its
backward), net2, the spherical backprojection and the 3D U-Net (K3);
then Adam over every parameter.

The model is built from the cell's ``cli.train`` command line
(``cli/options.py::parse_train``) and takes the benchmark's calibrated
weights.  The batches (photos of solids with their depth, normal,
silhouette, depth min/max, a spherical map and solid voxels) are made on
the device from the seed; the window walks through a pool of ``pool``.

Set-up drives the model through its first three steps with the window's
own call on three different batches.  Checked against the float32
reference's three steps from the same weights and batches: each step's
loss terms, each parameter's first gradient (from Adam's first moment
after step 1) and each parameter's change over the three steps, by the
worst term or leaf.
"""

from __future__ import annotations

from types import SimpleNamespace

import drive
import inputs
import weights
from reference import models, precision

KIND = "train"
#: the end-to-end rate the window reports
RATE = "train_samples_per_s"
CHECKED_STEPS = 3



def setup(ctx):
    torch, cfg, wl, seed, dev = (ctx[k] for k in
                                 ("torch", "cfg", "wl", "seed", "device"))
    from genre_shapehd_tpu_torch.cli import options
    from genre_shapehd_tpu_torch.core.registry import get_model
    opt, _ = options.parse_train(drive.argv(cfg, wl, dev))
    model = get_model(opt.net)(opt)
    model.init_state(0)
    b, pool = wl["batch"], wl["pool"]
    if pool < CHECKED_STEPS:
        raise ValueError(f"a pool of {pool} batches: the {CHECKED_STEPS} "
                         "steps checked take one each")
    data = inputs.genre_batch(b * pool, cfg["im_size"], cfg["vox_res"],
                              cfg["sph_res"], cfg["padding_margin"],
                              weights.generator(seed, "inputs", dev), dev)
    w = weights.seeded(model.net, seed, dev)
    weights.calibrate_genre(w, data["rgb"][:2], data["silhou"][:2],
                            drive.genre_sizes(cfg))
    model.net.load_state_dict(w)
    feed = [{k: v[i * b:(i + 1) * b] for k, v in data.items()}
            for i in range(pool)]
    st = SimpleNamespace(torch=torch, cfg=cfg, wl=wl, dev=dev, opt=opt,
                         model=model, feed=feed, losses=[],
                         w0={k: v.to("cpu", copy=True) for k, v in w.items()})
    del w, data
    named = list(model.net.named_parameters())
    for k in range(CHECKED_STEPS):
        st.losses.append(_train(st, k))
        if k == 0:
            st.grads = drive.first_gradients(model.optimizer, named,
                                             opt.adam_beta1)
    st.change = {n: float((p.detach().cpu() - st.w0[n]).norm())
                 for n, p in named}
    return st


def _train(st, k):
    terms = st.model.train_step(st.feed[k % len(st.feed)])
    return {name: float(v) for name, v in terms.items()}


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
        joint_w25d=st.opt.joint_w25d, surface_weight=st.opt.surface_weight,
        sizes=drive.genre_sizes(st.cfg))


def _reference(st, cast, batches=None):
    w = {k: v.to(st.dev) for k, v in st.w0.items()}
    batches = batches or st.feed[:CHECKED_STEPS]
    with precision.float32_math():
        return models.genre_steps(w, batches, _ref_opt(st), cast)


def check(st):
    ref = _reference(st, precision.exact)
    return drive.train_numbers((st.losses, st.grads, st.change), ref)


def control(st):
    """The control's numbers: the reference's steps in fp8 in the
    program's place."""
    return drive.train_numbers(_reference(st, precision.fp8),
                               _reference(st, precision.exact))


def trace_info(st):
    """Per step: the model's operations (one reference step's forward and
    backward, counted at a batch of 2 and scaled, plus the renderer's
    forward and its transpose by the renderer's formula; the port's
    recomputation of the forward in the backward is not counted) and
    K3's call (dec6's forward)."""
    from cost import render as render_cost
    cfg, b = st.cfg, st.wl["batch"]
    two = [{k: v[:2] for k, v in st.feed[0].items()}]
    flops = drive.count_flops(lambda: _reference(st, precision.exact, two))
    v, r, z = cfg["vox_res"], cfg["sph_res"], cfg["z_res"]
    return {"flops_per_iter": flops * b / 2
            + 2 * render_cost.cost(b, v, r, z)[1],
            "deconv_final_calls": [(b, 2 * cfg["refine_nf"], v // 2,
                                    cfg["dtype"])],
            "dtype": cfg["dtype"]}
