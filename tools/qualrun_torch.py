"""Reconstruction quality of the PyTorch port on the procedural shape
dataset (counterpart of ``tools/qualrun.py``).

Trains GenRe's staged workflow with the port's ``cli.train`` models
(``train_marrnet1.sh`` -> ``train_inpaint.sh`` -> ``train_full_genre.sh``)
on analytic scenes (``genre_shapehd_tpu_torch/data/procedural.py``), then
reports held-out surface IoU and Chamfer distance against an untrained
baseline: the same JSON report and markdown as the JAX tool.

  stage 0 (--full_pipeline): marrnet1 --pred_depth_minmax
  stage 1: depth_pred_with_sph_inpaint (--net1_path <stage 0>, or the
           ground-truth depth oracle without --full_pipeline)
  stage 2: genre_full_model --inpaint_path <stage 1> --surface_weight 10
           (--surface_weight), then --steps2b more at --lr_b; with
           --joint2 the whole chain (--joint_train, --joint_w25d --w25d),
           its gradients into net1 probed first (joint_grad_split)

--init0 / --init2 warm-start stage 0 / stage 2 from a checkpoint, --lr0,
--lr0b and --lr2 override a stage's learning rate, as in the JAX tool.

Full size, on the card:
  python tools/qualrun_torch.py --full_pipeline --train_n 2048 \\
      --steps0 2000 --steps1 1500 --steps2 3000 --steps2b 1000 \\
      --lr_b 1e-4 --logdir runs/qualrun --out QUALRUN.md
Smoke (CPU, tiny):
  python tools/qualrun_torch.py --tiny --cpu --full_pipeline \\
      --steps0 2 --steps1 2 --steps2 2 --logdir runs/q

Imports the port and numpy only.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

THRESHOLDS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7)


def build(net, opt, seed=0):
    """Model, trainer and loaders of one stage; every scene is generated
    (in ``opt.workers`` processes) before the first step."""
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data.loader import DataLoader
    from genre_shapehd_tpu_torch.train.loggers import (ComposeLogger,
                                                       ProgbarLogger)
    from genre_shapehd_tpu_torch.train.loop import Trainer

    model = get_model(net)(opt)
    ds_train = get_dataset("procedural")(opt, "train", model=model)
    ds_vali = get_dataset("procedural")(opt, "vali", model=model)
    t0 = time.time()
    made = sum(ds.warm(opt.workers) for ds in (ds_train, ds_vali))
    print(f"[qualrun] cache warm ({len(ds_train)}+{len(ds_vali)} scenes, "
          f"{made} generated) in {time.time() - t0:.0f}s", flush=True)
    tl = DataLoader(ds_train, opt.batch_size, opt.workers, shuffle=True,
                    seed=seed, drop_last=True)
    vl = DataLoader(ds_vali, opt.batch_size, opt.workers)
    trainer = Trainer(model, opt, ComposeLogger([ProgbarLogger()]))
    trainer.initialize(seed)
    return model, trainer, tl, vl


def fit(trainer, tl, vl, steps):
    """``steps`` train steps in epochs of up to 100, 2 eval batches each."""
    spe = min(100, steps)
    return trainer.fit(tl, vl, epochs=max(steps // spe, 1),
                       steps_per_epoch=spe, eval_batches=2)


def probe_joint_grad_split(model, loader):
    """Under --joint2: L2 norms of the gradients into net1 of the voxel
    loss and of the (``--w25d``-weighted) 2.5D loss, on the loader's
    first batch at stage 2's start (the JAX tool's
    ``probe_joint_grad_split``): the nets in train mode, their running
    statistics left as they were."""
    import torch
    from genre_shapehd_tpu_torch.models.base import keep_batch_stats

    batch = model.device_batch(next(iter(loader)))
    params = list(model.net.depth_and_inpaint.net1.parameters())
    model.net.train()
    with keep_batch_stats(model.net):
        pred = model.forward_batch(batch)
        full, parts = model.compute_loss(pred, batch)
    vox = parts["voxel_loss"] + parts["surface_loss"]
    out = {}
    for which, loss in (("vox", vox), ("25d", full - vox)):
        grads = torch.autograd.grad(loss, params, retain_graph=True,
                                    allow_unused=True)
        out[f"net1_grad_norm_{which}"] = float(torch.sqrt(sum(
            (g.double() ** 2).sum() for g in grads if g is not None)))
    out["vox_over_25d"] = (out["net1_grad_norm_vox"]
                           / max(out["net1_grad_norm_25d"], 1e-30))
    return out


def eval_quality(model, vl, max_batches=None, tag=""):
    """Held-out metrics: surface IoU (sigmoid(pred) > th against the
    ground truth's two-erosion shell) at each threshold, the best one, and
    the Chamfer distance of the first 16 items (``cli.eval_chamfer``'s
    protocol, on the model's device)."""
    import torch
    from genre_shapehd_tpu_torch.cli.eval_chamfer import \
        chamfer_between_voxels
    from genre_shapehd_tpu_torch.ops.voxel import surface_from_solid

    inter = {t: 0.0 for t in THRESHOLDS}
    union = {t: 0.0 for t in THRESHOLDS}
    chamfers = []
    n_items = 0
    examples = []
    for bi, batch in enumerate(vl):
        if max_batches and bi >= max_batches:
            break
        _, pred = model.eval_step(batch)
        logits = pred["pred_voxel"].float().cpu().numpy()
        gt_solid = np.asarray(batch["voxel"])
        shells = surface_from_solid(torch.from_numpy(gt_solid)).numpy() > 0.5
        prob = 1.0 / (1.0 + np.exp(-logits))
        for i in range(len(logits)):
            for t in THRESHOLDS:
                p = prob[i] > t
                inter[t] += float((p & shells[i]).sum())
                union[t] += float((p | shells[i]).sum())
            if n_items < 16:
                chamfers.append(chamfer_between_voxels(
                    logits[i], shells[i].astype(np.float32), th=0.25,
                    use_sigmoid=True, n_points=1024, seed=i,
                    device=model.device))
            if len(examples) < 4:
                examples.append((logits[i], gt_solid[i]))
            n_items += 1
    iou = {t: inter[t] / max(union[t], 1.0) for t in THRESHOLDS}
    res = {
        "n_items": n_items,
        "iou_0.5": iou[0.5],
        "iou_best": max(iou.values()),
        "iou_best_th": max(iou, key=iou.get),
        "iou_by_th": iou,
        "chamfer_mean": float(np.mean(chamfers)) if chamfers else None,
        "chamfer_n": len(chamfers),
    }
    print(f"[qualrun] {tag}: "
          f"{json.dumps({k: v for k, v in res.items() if k != 'iou_by_th'})}",
          flush=True)
    return res, examples


def dump_examples(examples, outdir, tag):
    """Logits and ground truths as .npz, and their iso-surfaces as .obj."""
    import torch
    from genre_shapehd_tpu_torch.ops.voxel import surface_from_solid
    from genre_shapehd_tpu_torch.viz.mcubes import marching_cubes, write_obj
    os.makedirs(outdir, exist_ok=True)
    for i, (logits, gt_solid) in enumerate(examples):
        np.savez_compressed(os.path.join(outdir, f"{tag}_{i}.npz"),
                            pred_logits=logits.astype(np.float16),
                            gt_solid=gt_solid.astype(np.uint8))
        prob = 1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
        shell = surface_from_solid(torch.from_numpy(gt_solid)).numpy()
        for name, vol, th in ((f"{tag}_{i}_pred", prob, 0.25),
                              (f"{tag}_{i}_gt", shell, 0.5)):
            verts, faces = marching_cubes(vol, th)
            if len(faces):
                write_obj(os.path.join(outdir, name + ".obj"), verts, faces)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps0", type=int, default=2000,
                    help="net1 (marrnet1) steps (--full_pipeline only)")
    ap.add_argument("--steps0b", type=int, default=0,
                    help="extra net1 steps at --lr_b")
    ap.add_argument("--steps1", type=int, default=1500,
                    help="spherical inpainting steps (stage 1)")
    ap.add_argument("--steps2", type=int, default=4000,
                    help="full-GenRe refinement steps (stage 2)")
    ap.add_argument("--steps2b", type=int, default=0,
                    help="extra refinement steps at --lr_b")
    ap.add_argument("--surface_weight", type=float, default=10.0,
                    help="stage 2's --surface_weight (train_full_genre.sh's "
                         "10; the JAX tool trains with the model default, 1)")
    ap.add_argument("--lr_b", type=float, default=None,
                    help="learning rate of the *b phases (default lr/10)")
    ap.add_argument("--init0", default=None,
                    help="warm-start stage 0 from a net1 checkpoint "
                         "(continued training at --lr0)")
    ap.add_argument("--lr0", type=float, default=None,
                    help="stage 0's learning rate (default --lr)")
    ap.add_argument("--lr0b", type=float, default=None,
                    help="stage 0's *b learning rate (default --lr_b)")
    ap.add_argument("--init2", default=None,
                    help="warm-start stage 2 from a full-GenRe checkpoint "
                         "(continued refinement, or joint fine-tuning with "
                         "--joint2) instead of stage 1's inpainting net")
    ap.add_argument("--joint2", action="store_true",
                    help="stage 2 trains the whole chain end to end "
                         "(--joint_train: the voxel loss's gradients reach "
                         "net1 through the backprojections and the "
                         "renderer)")
    ap.add_argument("--w25d", type=float, default=0.01,
                    help="stage 2's --joint_w25d: the weight of the 2.5D "
                         "supervision beside the voxel loss")
    ap.add_argument("--lr2", type=float, default=None,
                    help="stage 2's learning rate (default --lr)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train_n", type=int, default=1024,
                    help="procedural training scenes (held out: 1/8, at "
                         "least 16)")
    ap.add_argument("--workers", type=int, default=8,
                    help="scene-generation processes and loader threads")
    ap.add_argument("--logdir", default="runs/qualrun")
    ap.add_argument("--out", default=None, help="markdown report path")
    ap.add_argument("--tiny", action="store_true",
                    help="64^2 -> 32^3, sph 32, z 64 (CPU smoke)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--eval_batches", type=int, default=None)
    ap.add_argument("--skip0", action="store_true",
                    help="reuse <logdir>/net1.pt instead of stage 0")
    ap.add_argument("--skip1", action="store_true",
                    help="reuse <logdir>/inpaint.pt instead of stage 1")
    ap.add_argument("--full_pipeline", action="store_true",
                    help="no ground-truth depth oracle: stage 0 trains "
                         "net1, and the geometry chain reads its predicted "
                         "depth in training and evaluation")
    ap.add_argument("--offline", action="store_true",
                    help="oracle cell: --load_offline everywhere (net2 "
                         "inpaints the ground-truth spherical map)")
    ap.add_argument("--gtminmax", action="store_true",
                    help="oracle split: net1's depth map with the "
                         "ground-truth min/max (--gt_minmax_input)")
    ap.add_argument("--gtsph", action="store_true",
                    help="oracle cell: --gt_sph_full (the refine net "
                         "backprojects the ground-truth spherical map); "
                         "stage 1 is skipped")
    ap.add_argument("--f32_heads", action="store_true",
                    help="net1's decoders and heads in float32")
    ap.add_argument("--decoder_width", type=float, default=1.0,
                    help="net1's decoder width multiplier")
    ap.add_argument("--no_aug", action="store_true",
                    help="no photometric augmentation in any stage")
    args = ap.parse_args(argv)

    import torch
    from genre_shapehd_tpu_torch.core.device import resolve_device
    from genre_shapehd_tpu_torch.models.base import default_opt

    device = resolve_device("cpu" if args.cpu else "cuda")
    dims = dict(im_size=64, vox_res=32, sph_res=32, z_res=64,
                padding_margin=16) if args.tiny else \
        dict(im_size=256, vox_res=128, sph_res=128, z_res=256,
             padding_margin=16)
    lr_b = args.lr_b if args.lr_b is not None else args.lr / 10
    common = dict(batch_size=args.batch, lr=args.lr,
                  gt_depth_input=not args.full_pipeline,
                  load_offline=args.offline,
                  gt_minmax_input=args.gtminmax,
                  f32_heads=args.f32_heads, decoder_width=args.decoder_width,
                  no_aug=args.no_aug,
                  procedural_length=args.train_n, workers=args.workers,
                  dtype="bfloat16", log_every=8, device=device.type,
                  **dims)
    os.makedirs(args.logdir, exist_ok=True)
    # the JAX tool's config keys
    report = {"config": {**common, "steps0": args.steps0,
                         "steps0b": args.steps0b, "steps1": args.steps1,
                         "steps2": args.steps2, "steps2b": args.steps2b,
                         "surface_weight": args.surface_weight,
                         "lr_b": lr_b, "init0": args.init0, "lr0": args.lr0,
                         "lr0b": args.lr0b, "init2": args.init2,
                         "joint2": args.joint2, "w25d": args.w25d,
                         "lr2": args.lr2, "offline": args.offline,
                         "gtsph": args.gtsph, "gtminmax": args.gtminmax,
                         "full_pipeline": args.full_pipeline}}
    report["backend"] = (f"cuda ({torch.cuda.get_device_name(device)})"
                         if device.type == "cuda" else "cpu")

    # ------------------------------- stage 0: net1, RGB -> 2.5D + min/max
    ckpt0 = os.path.join(args.logdir, "net1.pt")
    if args.full_pipeline:
        if args.skip0 and os.path.exists(ckpt0):
            report["stage0"] = {"reused": ckpt0}
        else:
            t0 = time.time()
            opt0 = default_opt(**{**common, "lr": args.lr0 if args.lr0
                                  is not None else args.lr},
                               pred_depth_minmax=True)
            _, trainer0, tl0, vl0 = build("marrnet1", opt0)
            if args.init0:
                trainer0.load(args.init0)
                trainer0.start_epoch = 0
            print(f"[qualrun] stage0: marrnet1 at lr {opt0.lr}"
                  + (f" from {args.init0}" if args.init0 else ""),
                  flush=True)
            log0 = fit(trainer0, tl0, vl0, args.steps0)
            trainer0.save(ckpt0, epoch=args.steps0)
            if args.steps0b:
                lr0b = args.lr0b if args.lr0b is not None else lr_b
                opt0b = default_opt(**{**common, "lr": lr0b},
                                    pred_depth_minmax=True)
                _, trainer0, tl0, vl0 = build("marrnet1", opt0b)
                trainer0.load(ckpt0)
                trainer0.start_epoch = 0
                log0 = fit(trainer0, tl0, vl0, args.steps0b)
                trainer0.save(ckpt0, epoch=args.steps0 + args.steps0b)
            del trainer0
            report["stage0"] = {
                "final_log": {k: float(v) for k, v in log0.items()},
                "seconds": round(time.time() - t0, 1)}
        print(f"[qualrun] stage0: {report['stage0']}", flush=True)

    # ------------------------------------- stage 1: spherical inpainting
    ckpt1 = os.path.join(args.logdir, "inpaint.pt")
    if args.gtsph:
        report["stage1"] = {"reused": "skipped (--gtsph bypasses net2)"}
    elif args.skip1 and os.path.exists(ckpt1):
        report["stage1"] = {"reused": ckpt1}
    else:
        t0 = time.time()
        opt1 = default_opt(**common, net1_path=(
            ckpt0 if args.full_pipeline else None))
        _, trainer1, tl1, vl1 = build("depth_pred_with_sph_inpaint", opt1)
        log1 = fit(trainer1, tl1, vl1, args.steps1)
        trainer1.save(ckpt1, epoch=args.steps1)
        del trainer1
        report["stage1"] = {
            "final_log": {k: float(v) for k, v in log1.items()},
            "seconds": round(time.time() - t0, 1)}
    print(f"[qualrun] stage1: {report['stage1']}", flush=True)

    # ---------------------------- untrained baseline (a fresh GenRe net)
    common2 = dict(common, gt_sph_full=args.gtsph,
                   surface_weight=args.surface_weight,
                   joint_train=args.joint2, joint_w25d=args.w25d,
                   lr=args.lr2 if args.lr2 is not None else args.lr)
    model2, trainer2, tl2, vl2 = build("genre_full_model",
                                       default_opt(**common2))
    base_res, base_ex = eval_quality(model2, vl2, args.eval_batches,
                                     tag="untrained")
    report["untrained"] = base_res

    # ---------------------------------------- stage 2: voxel refinement
    t0 = time.time()
    if args.init2:
        # continued training (joint fine-tuning with --joint2) from a
        # full-GenRe checkpoint of an earlier run
        trainer2.load(args.init2)
        trainer2.start_epoch = 0
    elif not args.gtsph:                   # --gtsph never runs net2
        model2.load_subnet("depth_and_inpaint", ckpt1)
    print(f"[qualrun] stage2: genre_full_model at lr {model2.opt.lr}"
          + (f", joint (w25d {args.w25d})" if args.joint2 else "")
          + (f" from {args.init2}" if args.init2 else ""), flush=True)
    if args.joint2:
        probe = probe_joint_grad_split(model2, tl2)
        report["joint_grad_split"] = probe
        print(f"[qualrun] joint grad split at stage-2 start: "
              f"{json.dumps(probe)}", flush=True)
    log2 = fit(trainer2, tl2, vl2, args.steps2)
    ckpt2 = os.path.join(args.logdir, "genre.pt")
    trainer2.save(ckpt2, epoch=args.steps2)
    if args.steps2b:
        del model2, trainer2
        model2, trainer2, tl2, vl2 = build(
            "genre_full_model", default_opt(**{**common2, "lr": lr_b}))
        trainer2.load(ckpt2)
        trainer2.start_epoch = 0
        log2 = fit(trainer2, tl2, vl2, args.steps2b)
        trainer2.save(ckpt2, epoch=args.steps2 + args.steps2b)
    report["stage2"] = {"final_log": {k: float(v) for k, v in log2.items()},
                        "seconds": round(time.time() - t0, 1)}
    print(f"[qualrun] stage2: {report['stage2']}", flush=True)

    trained_res, trained_ex = eval_quality(model2, vl2, args.eval_batches,
                                           tag="trained")
    report["trained"] = trained_res
    examples = os.path.join(args.logdir, "examples")
    dump_examples(trained_ex, examples, "trained")
    dump_examples(base_ex[:1], examples, "untrained")

    with open(os.path.join(args.logdir, "qualrun.json"), "w") as f:
        json.dump(report, f, indent=2)
    if args.out:
        write_markdown(args.out, report)
    print("[qualrun] report:", json.dumps(
        {k: report[k] for k in ("untrained", "trained")}, indent=2))
    return report


def write_markdown(path, report):
    u, t = report["untrained"], report["trained"]
    cfg = report["config"]
    full = cfg.get("full_pipeline")
    mode = (
        "with NO oracle anywhere: stage 0 trains net1 (RGB -> 2.5D, the "
        "reference's marrnet1 step) and the geometry chain consumes net1's "
        "PREDICTED depth through training and eval -- the complete RGB -> "
        "3D reference workflow"
        if full else
        "with oracle GT depth inputs (`--gt_depth_input`)")
    stage = lambda s: (f"{report[s]['seconds']}s, final "      # noqa: E731
                       f"{json.dumps(report[s]['final_log'])}"
                       if "seconds" in report.get(s, {})
                       else f"reused checkpoint {report[s]['reused']}")
    lines = [
        "# QUALRUN — reconstruction quality on the procedural benchmark"
        + (" (full RGB pipeline)" if full else "") + ", PyTorch port",
        "",
        "Staged GenRe training (" + ("net1 -> " if full else "")
        + "inpaint -> full refine, the reference's "
        + ("train_marrnet1.sh -> " if full else "")
        + "train_inpaint.sh -> train_full_genre.sh workflow) "
        + mode + " on analytic scenes "
        "(`genre_shapehd_tpu_torch/data/procedural.py`), by "
        "`tools/qualrun_torch.py`.",
        "",
        f"- backend: `{report['backend']}`, dtype {cfg['dtype']}, "
        f"batch {cfg['batch_size']}, lr {cfg['lr']}",
        f"- resolutions: voxel {cfg['vox_res']}^3, image {cfg['im_size']}^2, "
        f"spherical {cfg['sph_res']}^2, z_res {cfg['z_res']}",
    ] + ([
        f"- stage 0 (net1 2.5D prediction): {cfg['steps0']} steps"
        + (f" + {cfg['steps0b']} at lr {cfg['lr_b']}"
           if cfg.get("steps0b") else "") + ", " + stage("stage0")
    ] if full else []) + [
        f"- stage 1 (spherical inpainting): {cfg['steps1']} steps, "
        + stage("stage1"),
        f"- stage 2 (voxel refinement): {cfg['steps2']} steps"
        + (f" + {cfg['steps2b']} at lr {cfg['lr_b']}"
           if cfg.get("steps2b") else "") + ", " + stage("stage2"),
        f"- held-out scenes: {t['n_items']} (disjoint seed range from "
        f"{cfg['procedural_length']} train scenes)",
        "",
        "## Results (held-out)",
        "",
        "| metric | untrained | trained |",
        "|---|---|---|",
        f"| surface IoU @0.5 | {u['iou_0.5']:.4f} | {t['iou_0.5']:.4f} |",
        f"| surface IoU @best th | {u['iou_best']:.4f} "
        f"(th {u['iou_best_th']}) | {t['iou_best']:.4f} "
        f"(th {t['iou_best_th']}) |",
        f"| Chamfer distance (mean of {t['chamfer_n']}) | "
        f"{u['chamfer_mean']:.4f} | {t['chamfer_mean']:.4f} |",
        "",
        "Surface IoU = intersection-over-union of the thresholded sigmoid "
        "voxel prediction against the GT 2-iteration-erosion surface "
        "shell (the training target).  Chamfer follows "
        "`genre_shapehd_tpu_torch/cli/eval_chamfer.py`: marching-cubes "
        "surfaces, 1024 area-weighted samples, bidirectional "
        "`nndistance_score`.",
        "",
        "Artifacts: `qualrun.json`, `examples/*.npz`, `examples/*.obj` in "
        "the run logdir.",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
