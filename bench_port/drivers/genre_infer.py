"""Offline reconstruction of a photo collection with GenRe: one caller
hands ``genre_full.Model.predict_step`` a batch of preprocessed photos
(RGB and silhouette at the input size), waits for its voxel logits in
host memory (a page-locked buffer made at set-up), and sends the next.

The model is built from the cell's ``cli.test`` command line
(``cli/options.py::parse_test``), as ``cli.test`` builds it, and takes
the benchmark's weights directly where ``cli.test`` would read them from
``--net_file``.  The inputs are a pool of ``pool`` batches, made on the
device from the seed and held on the host as the loader hands them
over; the window walks through them in turn.

Checked, for ``sample_batches`` batches drawn from the seed, stage by
stage: each stage of the float32 reference takes the program's own
output of the stage before (net1 takes the inputs), and its output is
held against the program's (relative L2 error): net1's depth and
min/max, the camera backprojection, the rendered partial map, net2's
full map, its backprojection, and the voxel logits as they reached host
memory.  Stage by stage, because the backprojections are discrete: a
depth a rounding apart lands a point in the next voxel, so whole-chain
errors of the later stages say nothing about their own arithmetic.
The control runs each reference stage in fp8 instead (the nets'
products and the renderer in fp8, a geometric stage on its input
rounded to fp8).
"""

from __future__ import annotations

from types import SimpleNamespace

import drive
import inputs
import weights
from cost import render as render_cost
from reference import models, precision

KIND = "infer"
#: the end-to-end rate the window reports
RATE = "recon_per_s"
#: outputs checked besides the voxels, as ``predict_step`` returns them
KEEP = ("depth", "depth_minmax", "proj_depth", "pred_sph_partial",
        "pred_sph_full", "pred_proj_sph_full")



def setup(ctx):
    torch, cfg, wl, seed, dev = (ctx[k] for k in
                                 ("torch", "cfg", "wl", "seed", "device"))
    from genre_shapehd_tpu_torch.cli import options
    from genre_shapehd_tpu_torch.core.registry import get_model
    opt = options.parse_test(drive.argv(cfg, wl, dev))
    model = get_model(opt.net)(opt)
    w = weights.seeded(model.net, seed, dev)
    b, pool = wl["batch"], wl["pool"]
    ph = inputs.photos(b * pool, cfg["im_size"],
                       weights.generator(seed, "inputs", dev), dev)
    weights.calibrate_genre(w, ph["rgb"][:2], ph["silhou"][:2],
                            drive.genre_sizes(cfg))
    model.net.load_state_dict(w)
    batches = [{k: ph[k][i * b:(i + 1) * b].cpu().numpy()
                for k in ("rgb", "silhou")} for i in range(pool)]
    v = cfg["vox_res"]
    sink = drive.HostSink((b, v, v, v), getattr(torch, cfg["dtype"]),
                          wl["sample_batches"], dev)
    st = SimpleNamespace(torch=torch, cfg=cfg, wl=wl, dev=dev, model=model,
                         w={k: x.to("cpu", copy=True) for k, x in w.items()},
                         batches=batches, sample=drive.sample(seed, wl),
                         sink=sink, kept={})
    del w, ph
    for i in range(wl["warmup"]):
        _batch(st, i, False)
    return st


def _batch(st, i, keep):
    """One batch: its predictions, and its voxel logits in host memory."""
    pred = st.model.predict_step(st.batches[i % len(st.batches)])
    return pred, st.sink.take(pred["pred_voxel"], i, keep)


def step(st, i):
    keep = i in st.sample
    pred, voxels = _batch(st, i, keep)
    if keep:
        st.kept[i] = ({k: pred[k] for k in KEEP}, voxels)


def min_iters(st):
    return max(st.sample) + 1


def release(st):
    st.model = None


def _stages(st, i, outs, voxels, err, control=False):
    """Every stage of the reference on the program's own inputs to it,
    in blocks of ``ref_rows`` rows, held against the program's output of
    the stage, or with ``control`` against the stage in fp8, into
    ``err``."""
    torch, cfg = st.torch, st.cfg
    batch = st.batches[i % len(st.batches)]
    rows, v, m = st.wl["ref_rows"], cfg["vox_res"], cfg["padding_margin"]
    w = {k: x.to(st.dev) for k, x in st.w.items()}
    with torch.no_grad(), precision.float32_math():
        for r in range(0, st.wl["batch"], rows):
            rgb, sil = (torch.as_tensor(batch[k][r:r + rows]).to(st.dev)
                        for k in ("rgb", "silhou"))
            got = {k: x[r:r + rows].float() for k, x in outs.items()}
            got["pred_voxel"] = voxels[r:r + rows].to(st.dev).float()
            proj = got["proj_depth"] / 50.0
            stages = {
                "net1.depth": ("depth", lambda c: models.net1(
                    w, rgb, c)["depth"]),
                "net1.minmax": ("depth_minmax", lambda c: models.net1(
                    w, rgb, c)["depth_minmax"]),
                "camera_bp": ("proj_depth", lambda c: 50.0 * models.camera(
                    c(got["depth"]), got["depth_minmax"], sil, v)),
                "render": ("pred_sph_partial", lambda c: models.partial(
                    c(proj), cfg["sph_res"], cfg["z_res"], m, c)),
                "net2": ("pred_sph_full", lambda c: models.net2(
                    w, got["pred_sph_partial"], c)),
                "spherical_bp": ("pred_proj_sph_full",
                                 lambda c: models.geo.spherical_backproject(
                                     c(got["pred_sph_full"][..., 0]), m, v)),
                "refine": ("pred_voxel", lambda c: models.refine(
                    w, got["pred_proj_sph_full"], proj, c, vox_res=v)),
            }
            for name, (key, fn) in stages.items():
                subject = fn(precision.fp8) if control else got[key]
                err.add(name, subject, fn(precision.exact))


def check(st):
    err = drive.RelErr()
    for i, (outs, voxels) in sorted(st.kept.items()):
        _stages(st, i, outs, voxels, err)
    return err.numbers()


def control(st):
    """The control's numbers: each stage of the reference in fp8 held
    against the same stage in float32, both on the program's inputs to
    it."""
    err = drive.RelErr()
    for i, (outs, voxels) in sorted(st.kept.items()):
        _stages(st, i, outs, voxels, err, control=True)
    return err.numbers()


def trace_info(st):
    """Per iteration: the operations of the model (the reference's,
    counted at a batch of 2 and scaled, plus the renderer's), the
    renderer's and K3's calls by shape."""
    torch, cfg, b = st.torch, st.cfg, st.wl["batch"]
    w = {k: v.to(st.dev) for k, v in st.w.items()}
    batch = st.batches[0]
    rgb, sil = (torch.as_tensor(batch[k][:2]).to(st.dev)
                for k in ("rgb", "silhou"))
    with torch.no_grad():
        nets = drive.count_flops(lambda: models.genre(
            w, rgb, sil, precision.exact, **drive.genre_sizes(cfg)))
    v, r, z = cfg["vox_res"], cfg["sph_res"], cfg["z_res"]
    return {"flops_per_iter": nets * b / 2
            + render_cost.cost(b, v, r, z)[1],
            "render_calls": [(b, v, r, z)],
            "deconv_final_calls": [(b, 2 * cfg["refine_nf"], v // 2,
                                    cfg["dtype"])],
            "dtype": cfg["dtype"]}
