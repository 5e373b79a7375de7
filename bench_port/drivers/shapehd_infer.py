"""ShapeHD's test path (``test_shapehd.sh``): one caller hands
``shapehd.ModelTest.predict_step`` a batch of preprocessed photos and
waits for the fine-tuned MarrNet-2's voxel logits in host memory (a
page-locked buffer made at set-up).  Each batch runs MarrNet-1, the
fine-tuned and the frozen MarrNet-2 on its 2.5D sketches, and the critic
on both voxel grids.

The model is built as ``cli.test`` builds it: from the cell's command
line (``cli/options.py::parse_test``) and from the checkpoints the
benchmark writes at set-up under ``TMPDIR`` (``--net_file`` with the
fine-tuned MarrNet-2, the frozen one and the critic, ``--marrnet1_file``),
holding the benchmark's weights.  The photos are a pool of ``pool``
batches made on the device from the seed and held on the host.

Checked, for ``sample_batches`` batches drawn from the seed, stage by
stage against the float32 reference (relative L2 error): MarrNet-1's
maps from the photos; each MarrNet-2 on the program's maps; the critic
on each of the program's voxel grids, its error measured against the
size of its last layer's products (a score is a sum whose terms cancel,
and a score near 0 would make any error look large).  The control runs
each stage of the reference in fp8.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from types import SimpleNamespace

import drive
import inputs
import weights
from reference import models, nets, precision

KIND = "infer"
#: the end-to-end rate the window reports
RATE = "recon_per_s"
KEEP = ("depth", "normal", "silhou", "voxel_noft", "is_real",
        "is_real_noft")
NETS = ("net", "net_noft", "net_d")


def _write(path, modules_weights, names):
    from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint
    from genre_shapehd_tpu_torch.core.convert import torch_to_jax
    payload = []
    for w in modules_weights:
        params, stats = torch_to_jax({k: v.cpu() for k, v in w.items()})
        payload.append({"params": params, "batch_stats": stats})
    save_checkpoint(path, {"nets": payload, "optimizers": [], "epoch": 0,
                           "loss_eval": 0.0, "net_names": list(names),
                           "opt_names": []})


def setup(ctx):
    torch, cfg, wl, seed, dev = (ctx[k] for k in
                                 ("torch", "cfg", "wl", "seed", "device"))
    from genre_shapehd_tpu_torch.cli import options
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.marrnet import marrnet1_net
    from genre_shapehd_tpu_torch.models.marrnet2 import Marrnet2Net
    from genre_shapehd_tpu_torch.nn import VoxelDiscriminator
    res, size, b, pool = cfg["vox_res"], cfg["im_size"], wl["batch"], \
        wl["pool"]
    layouts = {"marrnet1": marrnet1_net(size),
               "net": Marrnet2Net(vox_res=res),
               "net_noft": Marrnet2Net(vox_res=res),
               "net_d": VoxelDiscriminator(cfg["critic_nf"], res)}
    w = {k: weights.seeded(m, seed, dev, offset=i)
         for i, (k, m) in enumerate(layouts.items())}
    del layouts
    ph = inputs.photos(b * pool, size, weights.generator(seed, "inputs",
                                                         dev), dev)
    weights.calibrate_marrnet1(w["marrnet1"], ph["rgb"][:2])
    tmp = tempfile.mkdtemp(prefix="bench_port_", dir=os.environ.get(
        "TMPDIR"))
    try:
        files = (os.path.join(tmp, "shapehd.pt"),
                 os.path.join(tmp, "marrnet1.pt"))
        _write(files[0], [w[k] for k in NETS], NETS)
        _write(files[1], [w["marrnet1"]], ["net"])
        argv = drive.argv(cfg, wl, dev) + ["--net_file", files[0],
                                           "--marrnet1_file", files[1]]
        model = get_model("shapehd", test=True)(options.parse_test(argv))
    finally:
        shutil.rmtree(tmp)
    batches = [{"rgb": ph["rgb"][i * b:(i + 1) * b].cpu().numpy()}
               for i in range(pool)]
    sink = drive.HostSink((b, res, res, res), getattr(torch, cfg["dtype"]),
                          wl["sample_batches"], dev)
    st = SimpleNamespace(torch=torch, cfg=cfg, wl=wl, dev=dev, model=model,
                         w={k: {n: x.to("cpu", copy=True)
                                for n, x in v.items()} for k, v in w.items()},
                         batches=batches, sample=drive.sample(seed, wl),
                         sink=sink, kept={})
    del w, ph
    for i in range(wl["warmup"]):
        _batch(st, i, False)
    return st


def _batch(st, i, keep):
    pred = st.model.predict_step(st.batches[i % len(st.batches)])
    return pred, st.sink.take(pred["voxel"], i, keep)


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
    torch, res = st.torch, st.cfg["vox_res"]
    thres = st.cfg["pred_silhou_thres"] * 100.0
    batch = st.batches[i % len(st.batches)]
    rows = st.wl["ref_rows"]
    w = {k: {n: x.to(st.dev) for n, x in v.items()}
         for k, v in st.w.items()}
    with torch.no_grad(), precision.float32_math():
        for r in range(0, st.wl["batch"], rows):
            rgb = torch.as_tensor(batch["rgb"][r:r + rows]).to(st.dev)
            got = {k: x[r:r + rows].float() for k, x in outs.items()}
            got["voxel"] = voxels[r:r + rows].to(st.dev).float()
            maps = (got["depth"], got["normal"], got["silhou"])

            def m1(key):
                return lambda c: nets.uresnet(
                    nets.Net(w["marrnet1"], c), rgb,
                    ("normal", "depth", "silhou"))[key]

            def m2(net):
                return lambda c: nets.marrnet2(nets.Net(w[net], c), *maps,
                                               thres, res)

            def critic(key):
                return lambda c: nets.critic(nets.Net(w["net_d"], c),
                                             torch.sigmoid(got[key]), res,
                                             scale=True)

            stages = {"marrnet1.depth": ("depth", m1("depth")),
                      "marrnet1.normal": ("normal", m1("normal")),
                      "marrnet1.silhou": ("silhou", m1("silhou")),
                      "marrnet2": ("voxel", m2("net")),
                      "marrnet2_noft": ("voxel_noft", m2("net_noft")),
                      "critic": ("is_real", critic("voxel")),
                      "critic_noft": ("is_real_noft", critic("voxel_noft"))}
            for name, (key, fn) in stages.items():
                scored = name.startswith("critic")
                ref, scale = fn(precision.exact) if scored else (
                    fn(precision.exact), None)
                subject = got[key]
                if control:
                    subject = fn(precision.fp8)
                    subject = subject[0] if scored else subject
                err.add(name, subject, ref, scale)


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
    """Per batch: the model's operations (the reference's, counted at a
    batch of 2 and scaled) and K3's calls (both decoders' last layer)."""
    torch, cfg, b = st.torch, st.cfg, st.wl["batch"]
    w = {k: {n: x.to(st.dev) for n, x in v.items()}
         for k, v in st.w.items()}
    rgb = torch.as_tensor(st.batches[0]["rgb"][:2]).to(st.dev)
    with torch.no_grad():
        flops = drive.count_flops(lambda: models.shapehd_test(
            w, rgb, precision.exact, cfg["vox_res"],
            cfg["pred_silhou_thres"] * 100.0))
    # the decoder halves its width at each of its log2(res / 4) - 1
    # doubling stages before the last layer
    cin = cfg["decoder_nf"] >> (cfg["vox_res"] // 4).bit_length() - 2
    call = (b, cin, cfg["vox_res"] // 2, cfg["dtype"])
    return {"flops_per_iter": flops * b / 2,
            "deconv_final_calls": [call, call], "dtype": cfg["dtype"]}
