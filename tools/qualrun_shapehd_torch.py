"""Reconstruction quality of the PyTorch port's MarrNet-2 / ShapeHD family
on the procedural shape dataset (counterpart of
``tools/qualrun_shapehd.py``).

Trains the reference's second workflow (``train_marrnet2.sh`` ->
``train_wgangp.sh`` -> ``finetune_shapehd.sh``) with the port's models on
analytic scenes (``genre_shapehd_tpu_torch/data/procedural.py``) and
reports held-out solid-voxel IoU and Chamfer distance against an
untrained baseline: the same JSON report and markdown as the JAX tool.

  stage A  marrnet2 --canon_sup: ground-truth 2.5D sketches -> voxels
  stage B  wgangp --canon_voxel, with the critic-separation probe (D on
           real solids, on G(z), on stage A's outputs) every --sep_every
           epochs
  stage C  shapehd --canon_sup --marrnet2 <A> --gan <B>, one run per
           entry of --w_gan_loss: a float, 0 (the continued-supervision
           control), or ``auto:R``, which sets w so that the critic's
           gradient norm is R times the BCE's at the start of the stage
           (``probe_grad_split``).  Each run keeps the state of its best
           held-out IoU.

Full size, on the card (round 5's settings of the JAX tool):
  python tools/qualrun_shapehd_torch.py --train_n 512 --steps_m2 3000 \\
      --steps_gan 6000 --steps_shd 1000 --logdir runs/qualshd \\
      --out QUALRUN_SHAPEHD.md
Smoke (CPU, tiny):
  python tools/qualrun_shapehd_torch.py --tiny --cpu --steps_m2 2 \\
      --steps_gan 2 --steps_shd 2 --train_n 8 --logdir runs/qshd

Imports the port and numpy only.
"""

import argparse
import copy
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
    from genre_shapehd_tpu_torch.train.loop import Trainer

    model = get_model(net)(opt)
    ds_train = get_dataset("procedural")(opt, "train", model=model)
    ds_vali = get_dataset("procedural")(opt, "vali", model=model)
    t0 = time.time()
    made = sum(ds.warm(opt.workers) for ds in (ds_train, ds_vali))
    print(f"[qualshd] cache warm ({len(ds_train)}+{len(ds_vali)} scenes, "
          f"{made} generated) in {time.time() - t0:.0f}s", flush=True)
    tl = DataLoader(ds_train, opt.batch_size, opt.workers, shuffle=True,
                    seed=seed, drop_last=True)
    vl = DataLoader(ds_vali, opt.batch_size, opt.workers)
    trainer = Trainer(model, opt)
    trainer.initialize(seed)
    return model, trainer, tl, vl


def run_epochs(trainer, tl, vl, steps, eval_batches=2, on_epoch=None):
    """``steps`` train steps in epochs of up to 100, ``eval_batches``
    held-out batches after each; ``on_epoch(epoch, log)`` probes between
    epochs."""
    from genre_shapehd_tpu_torch.data.loader import InfiniteLoader

    spe = min(100, steps)
    epochs = max(steps // spe, 1)
    trainer.logger.set_params({
        "epoch": epochs, "steps_per_epoch": spe,
        "steps_per_eval": eval_batches, "metrics": trainer.model.metrics})
    trainer.logger.on_train_begin()
    it = InfiniteLoader(tl)
    last = {}
    for e in range(1, epochs + 1):
        last = trainer.train_epoch_pair(e, it, vl, spe, eval_batches)
        print(f"[qualshd] epoch {e}/{epochs}: "
              f"{json.dumps({k: float(v) for k, v in last.items()})}",
              flush=True)
        if on_epoch is not None:
            on_epoch(e, last)
    trainer.logger.on_train_end()
    return last


def eval_quality(model, vl, voxel_key, max_batches=None, tag="",
                 with_chamfer=True, quiet=False):
    """Held-out metrics: solid-voxel IoU (sigmoid(pred) > th against the
    ground-truth occupancy) at each threshold and the best one, the
    Chamfer distance of the first 16 items (``cli.eval_chamfer``'s
    protocol, on the model's device), and ShapeHD's critic scores of the
    finetuned and the frozen net's outputs."""
    from genre_shapehd_tpu_torch.cli.eval_chamfer import \
        chamfer_between_voxels

    inter = {t: 0.0 for t in THRESHOLDS}
    union = {t: 0.0 for t in THRESHOLDS}
    chamfers, realism, realism_noft = [], [], []
    n_items = 0
    examples = []
    for bi, batch in enumerate(vl):
        if max_batches and bi >= max_batches:
            break
        _, pred = model.eval_step(batch)
        if "is_real" in pred:
            realism += pred["is_real"].float().cpu().tolist()
            realism_noft += pred["is_real_noft"].float().cpu().tolist()
        logits = pred["voxel"].float().cpu().numpy()
        gt_solid = np.asarray(batch[voxel_key]) > 0.5
        prob = 1.0 / (1.0 + np.exp(-logits))
        for i in range(len(logits)):
            for t in THRESHOLDS:
                p = prob[i] > t
                inter[t] += float((p & gt_solid[i]).sum())
                union[t] += float((p | gt_solid[i]).sum())
            if with_chamfer and n_items < 16:
                chamfers.append(chamfer_between_voxels(
                    logits[i], gt_solid[i].astype(np.float32), th=0.25,
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
    if realism:
        res["critic_score"] = float(np.mean(realism))
        res["critic_score_noft"] = float(np.mean(realism_noft))
    if not quiet:
        print(f"[qualshd] {tag}: "
              f"{json.dumps({k: v for k, v in res.items() if k != 'iou_by_th'})}",
              flush=True)
    return res, examples


def probe_grad_split(model, loader):
    """L2 norms of the supervised and the critic gradients with respect
    to the finetuned net on one training batch (train mode, the running
    statistics left as they were): the critic's at the model's
    ``w_gan_loss`` and per unit weight, and their ratios."""
    import torch
    from genre_shapehd_tpu_torch.models.base import (bce_with_logits,
                                                     keep_batch_stats)

    batch = model.device_batch(next(iter(loader)))
    params = list(model.net.parameters())
    model.net.train()
    with keep_batch_stats(model.net):
        pred = model.forward_batch(batch)
        parts = {"sup": bce_with_logits(pred["voxel"].float(),
                                        batch[model.voxel_key]),
                 "gan": -pred["is_real"].float().mean()}
        out = {}
        for which, loss in parts.items():
            grads = torch.autograd.grad(loss, params, retain_graph=True)
            out[f"grad_norm_{which}"] = float(torch.sqrt(sum(
                (g.float() ** 2).sum() for g in grads)))
    out["grad_norm_gan_unit"] = out["grad_norm_gan"]
    out["grad_norm_gan"] *= model.w_gan_loss
    out["gan_over_sup"] = out["grad_norm_gan"] / max(out["grad_norm_sup"],
                                                     1e-30)
    out["gan_over_sup_unit"] = out["grad_norm_gan_unit"] / max(
        out["grad_norm_sup"], 1e-30)
    return out


def critic_separation(model_b, real_vox, m2_prob, seed=11):
    """Mean critic scores on real solids, on fresh G(z) samples (G on the
    batch's statistics, its running ones left as they were) and on stage
    A's sigmoid outputs."""
    import torch
    from genre_shapehd_tpu_torch.models.base import keep_batch_stats

    dev = model_b.device
    z = torch.randn((real_vox.shape[0], model_b.nz),
                    generator=torch.Generator().manual_seed(seed)).to(dev)
    model_b.net_g.train()
    with torch.no_grad(), keep_batch_stats(model_b.net_g):
        gen = model_b.generate(z).float()
        d = {k: float(model_b.critic(torch.as_tensor(
            np.asarray(v, np.float32), device=dev)).mean())
            for k, v in (("d_real", real_vox), ("d_m2", m2_prob))}
        d["d_gz"] = float(model_b.critic(gen).mean())
    return ({k: d[k] for k in ("d_real", "d_gz", "d_m2")},
            gen.cpu().numpy())


def snapshot_state(model):
    """Copies of the finetuned net's weights and its Adam state."""
    return (copy.deepcopy(model.net.state_dict()),
            copy.deepcopy(model.optimizer.state_dict()))


def restore_state(model, state):
    model.net.load_state_dict(state[0])
    model.optimizer.load_state_dict(state[1])


def dump_examples(examples, outdir, tag, already_prob=False):
    """Logits (or probabilities) and ground truths as .npz, and their
    iso-surfaces as .obj."""
    from genre_shapehd_tpu_torch.viz.mcubes import marching_cubes, write_obj
    os.makedirs(outdir, exist_ok=True)
    for i, (logits, gt_solid) in enumerate(examples):
        payload = {"pred_logits": logits.astype(np.float16)}
        if gt_solid is not None:
            payload["gt_solid"] = gt_solid.astype(np.uint8)
        np.savez_compressed(os.path.join(outdir, f"{tag}_{i}.npz"),
                            **payload)
        prob = logits.astype(np.float32) if already_prob else \
            1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
        packs = [(f"{tag}_{i}_pred", prob, 0.25)]
        if gt_solid is not None:
            packs.append((f"{tag}_{i}_gt", gt_solid.astype(np.float32), 0.5))
        for name, vol, th in packs:
            verts, faces = marching_cubes(vol, th)
            if len(faces):
                write_obj(os.path.join(outdir, name + ".obj"), verts, faces)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps_m2", type=int, default=3000,
                    help="marrnet2 steps (stage A)")
    ap.add_argument("--steps_gan", type=int, default=6000,
                    help="wgangp steps (stage B)")
    ap.add_argument("--steps_shd", type=int, default=1000,
                    help="shapehd finetune steps (stage C), per variant")
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="stage A's lr (train_marrnet2.sh)")
    ap.add_argument("--lr_gan", type=float, default=1e-4,
                    help="stage B's lr (train_wgangp.sh)")
    ap.add_argument("--lr_shd", type=float, default=1e-4,
                    help="stage C's lr (finetune_shapehd.sh uses 1e-3; 1e-4 "
                         "is gentler for a 1000-step finetune)")
    ap.add_argument("--w_gan_loss", type=str, default="auto:0.25,0,1e-3",
                    help="stage C's critic weights, comma-separated: "
                         "floats, 0, or auto:R; the first is the primary "
                         "run")
    ap.add_argument("--gan_d_iter", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--train_n", type=int, default=512,
                    help="procedural training scenes (held out: 1/8, at "
                         "least 16)")
    ap.add_argument("--workers", type=int, default=8,
                    help="scene-generation processes and loader threads")
    ap.add_argument("--logdir", default="runs/qualshd")
    ap.add_argument("--out", default=None, help="markdown report path")
    ap.add_argument("--tiny", action="store_true",
                    help="64^2 -> 32^3 (CPU smoke)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--eval_batches", type=int, default=None)
    ap.add_argument("--traj_batches", type=int, default=4,
                    help="held-out batches of stage C's per-epoch IoU probe")
    ap.add_argument("--sep_every", type=int, default=5,
                    help="stage-B epochs between critic-separation probes")
    ap.add_argument("--skip_m2", action="store_true",
                    help="reuse <logdir>/marrnet2.pt")
    ap.add_argument("--skip_gan", action="store_true",
                    help="reuse <logdir>/wgangp.pt")
    args = ap.parse_args(argv)

    import torch
    from genre_shapehd_tpu_torch.core.device import resolve_device
    from genre_shapehd_tpu_torch.models.base import default_opt

    device = resolve_device("cpu" if args.cpu else "cuda")
    dims = dict(im_size=64, vox_res=32, sph_res=32, z_res=64,
                padding_margin=16) if args.tiny else \
        dict(im_size=256, vox_res=128, sph_res=128, z_res=256,
             padding_margin=16)
    common = dict(batch_size=args.batch, procedural_length=args.train_n,
                  workers=args.workers, dtype="bfloat16", log_every=8,
                  device=device.type, **dims)
    os.makedirs(args.logdir, exist_ok=True)
    report = {"config": {**common, "steps_m2": args.steps_m2,
                         "steps_gan": args.steps_gan,
                         "steps_shd": args.steps_shd, "lr": args.lr,
                         "lr_gan": args.lr_gan, "lr_shd": args.lr_shd,
                         "w_gan_loss": args.w_gan_loss,
                         "gan_d_iter": args.gan_d_iter}}
    report["backend"] = (f"cuda ({torch.cuda.get_device_name(device)})"
                         if device.type == "cuda" else "cpu")

    # ------------------------------- stage A: marrnet2 (train_marrnet2.sh)
    ckpt_m2 = os.path.join(args.logdir, "marrnet2.pt")
    opt_a = default_opt(**common, lr=args.lr, canon_sup=True)
    model_a, trainer_a, tl_a, vl_a = build("marrnet2", opt_a)
    base_res, base_ex = eval_quality(model_a, vl_a, model_a.voxel_key,
                                     args.eval_batches, tag="untrained")
    report["untrained"] = base_res
    if args.skip_m2 and os.path.exists(ckpt_m2):
        trainer_a.load(ckpt_m2)
        report["stageA"] = {"reused": ckpt_m2}
    else:
        t0 = time.time()
        log_a = run_epochs(trainer_a, tl_a, vl_a, args.steps_m2)
        trainer_a.save(ckpt_m2, epoch=args.steps_m2)
        report["stageA"] = {
            "final_log": {k: float(v) for k, v in log_a.items()},
            "seconds": round(time.time() - t0, 1)}
    print(f"[qualshd] stageA: {report['stageA']}", flush=True)
    m2_res, m2_ex = eval_quality(model_a, vl_a, model_a.voxel_key,
                                 args.eval_batches, tag="marrnet2")
    report["marrnet2"] = m2_res
    # the critic-separation probe's inputs: real solids and stage A's
    # sigmoid outputs on them
    sep_real = np.stack([gt.astype(np.float32) for _, gt in m2_ex[:4]])
    sep_m2 = np.stack([1.0 / (1.0 + np.exp(-lg.astype(np.float32)))
                       for lg, _ in m2_ex[:4]])
    del model_a, trainer_a

    # --------------------------------- stage B: wgangp (train_wgangp.sh)
    ckpt_gan = os.path.join(args.logdir, "wgangp.pt")
    opt_b = default_opt(**common, lr=args.lr_gan, canon_voxel=True,
                        gan_d_iter=args.gan_d_iter)
    model_b, trainer_b, tl_b, vl_b = build("wgangp", opt_b)
    sep_traj = []
    if args.skip_gan and os.path.exists(ckpt_gan):
        trainer_b.load(ckpt_gan)
        report["stageB"] = {"reused": ckpt_gan}
    else:
        t0 = time.time()

        def on_epoch_b(e, log):
            if e % max(args.sep_every, 1) == 0:
                sep, _ = critic_separation(model_b, sep_real, sep_m2)
                sep_traj.append({"epoch": e,
                                 "step": e * min(100, args.steps_gan),
                                 **sep})
                print(f"[qualshd] stageB sep e{e}: {json.dumps(sep)}",
                      flush=True)

        log_b = run_epochs(trainer_b, tl_b, vl_b, args.steps_gan,
                           on_epoch=on_epoch_b)
        trainer_b.save(ckpt_gan, epoch=args.steps_gan)
        report["stageB"] = {
            "final_log": {k: float(v) for k, v in log_b.items()},
            "seconds": round(time.time() - t0, 1)}
    print(f"[qualshd] stageB: {report['stageB']}", flush=True)
    sep_final, gz = critic_separation(model_b, sep_real, sep_m2, seed=12)
    sep_traj.append({"epoch": -1, "step": args.steps_gan, **sep_final})
    report["critic_separation"] = sep_traj
    dump_examples([(g, None) for g in gz[:3]],
                  os.path.join(args.logdir, "examples"), "prior_gz",
                  already_prob=True)
    del model_b, trainer_b
    json_path = os.path.join(args.logdir, "qualrun_shapehd.json")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)

    # ---------------------------- stage C: shapehd (finetune_shapehd.sh)
    shd_ex = None
    for wi, wtok in enumerate(str(args.w_gan_loss).split(",")):
        t0 = time.time()
        auto_ratio = None
        if wtok.startswith("auto"):
            auto_ratio = float(wtok.split(":")[1]) if ":" in wtok else 0.25
            w = 1.0                          # set from the probe below
        else:
            w = float(wtok)
        opt_c = default_opt(**common, lr=args.lr_shd, canon_sup=True,
                            marrnet2=ckpt_m2, gan=ckpt_gan, w_gan_loss=w)
        model_c, trainer_c, tl_c, vl_c = build("shapehd", opt_c)
        probe = probe_grad_split(model_c, tl_c)
        if auto_ratio is not None:
            w = auto_ratio / max(probe["gan_over_sup_unit"], 1e-30)
            model_c.w_gan_loss = w
            probe["grad_norm_gan"] = probe["grad_norm_gan_unit"] * w
            probe["gan_over_sup"] = auto_ratio
        wname = f"{w:g}" if auto_ratio is None else f"auto{auto_ratio:g}"
        print(f"[qualshd] stageC w={w:g} ({wtok}) grad split: "
              f"{json.dumps(probe)}", flush=True)
        traj = []
        best = {"iou": -1.0, "state": None, "epoch": 0}

        def on_epoch_c(e, log):
            r, _ = eval_quality(model_c, vl_c, model_c.voxel_key,
                                args.traj_batches, with_chamfer=False,
                                quiet=True)
            row = {"epoch": e, "iou_0.5": r["iou_0.5"],
                   "critic_score": r.get("critic_score"),
                   "critic_score_noft": r.get("critic_score_noft"),
                   "sup": float(log.get("sup", float("nan")))}
            traj.append(row)
            print(f"[qualshd] stageC w={w:g} e{e}: {json.dumps(row)}",
                  flush=True)
            if r["iou_0.5"] > best["iou"]:
                best.update(iou=r["iou_0.5"], state=snapshot_state(model_c),
                            epoch=e)

        log_c = run_epochs(trainer_c, tl_c, vl_c, args.steps_shd,
                           on_epoch=on_epoch_c)
        if best["state"] is not None:
            restore_state(model_c, best["state"])
        trainer_c.save(os.path.join(args.logdir, f"shapehd_w{wname}.pt"),
                       epoch=args.steps_shd)
        if wi == 0:
            trainer_c.save(os.path.join(args.logdir, "shapehd.pt"),
                           epoch=args.steps_shd)
        stage = {"w_gan_loss": w, "w_token": wtok, "grad_split": probe,
                 "best_epoch": best["epoch"], "trajectory": traj,
                 "final_log": {k: float(v) for k, v in log_c.items()},
                 "seconds": round(time.time() - t0, 1)}
        res, ex = eval_quality(model_c, vl_c, model_c.voxel_key,
                               args.eval_batches, tag=f"shapehd_w{wname}")
        if wi == 0:
            report["stageC"], report["shapehd"], shd_ex = stage, res, ex
        report.setdefault("shapehd_sweep", []).append({**stage, **res})
        with open(json_path, "w") as f:
            json.dump(report, f, indent=2)
        del model_c, trainer_c, best

    examples = os.path.join(args.logdir, "examples")
    dump_examples(shd_ex, examples, "shapehd")
    dump_examples(m2_ex[:2], examples, "marrnet2")
    dump_examples(base_ex[:1], examples, "untrained")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    if args.out:
        write_markdown(args.out, report)
    print("[qualshd] report:", json.dumps(
        {k: report[k] for k in ("untrained", "marrnet2", "shapehd")},
        indent=2))
    return report


def _fmt(v, spec=".4f", na="n/a"):
    return format(v, spec) if isinstance(v, (int, float)) and v == v else na


def write_markdown(path, report):
    u, m, s = report["untrained"], report["marrnet2"], report["shapehd"]
    cfg = report["config"]
    stage = lambda k: (f"{report[k]['seconds']}s, final "     # noqa: E731
                       f"{json.dumps(report[k]['final_log'])}"
                       if "seconds" in report[k]
                       else f"reused {report[k]['reused']}")
    lines = [
        "# QUALRUN — MarrNet-2 / ShapeHD reconstruction quality on the "
        "procedural benchmark, PyTorch port",
        "",
        "The reference's second training workflow (train_marrnet2.sh -> "
        "train_wgangp.sh -> finetune_shapehd.sh) on analytic scenes "
        "(`genre_shapehd_tpu_torch/data/procedural.py`), by "
        "`tools/qualrun_shapehd_torch.py`: MarrNet-2 maps ground-truth "
        "2.5D sketches to voxels, a 3D-WGAN-GP learns the canonical shape "
        "prior, and ShapeHD finetunes MarrNet-2 with the frozen critic as "
        "a perceptual loss.",
        "",
        f"- backend: `{report['backend']}`, dtype {cfg['dtype']}, "
        f"batch {cfg['batch_size']}",
        f"- resolutions: voxel {cfg['vox_res']}^3, image {cfg['im_size']}^2",
        f"- stage A (marrnet2): {cfg['steps_m2']} steps @ lr {cfg['lr']}, "
        + stage("stageA"),
        f"- stage B (wgangp): {cfg['steps_gan']} steps @ lr "
        f"{cfg['lr_gan']}, " + stage("stageB"),
        f"- stage C (shapehd): {cfg['steps_shd']} steps @ lr "
        f"{cfg['lr_shd']}, w_gan_loss {cfg['w_gan_loss']}, "
        f"{report['stageC']['seconds']}s, best-IoU state kept "
        f"(epoch {report['stageC'].get('best_epoch')}), final "
        f"{json.dumps(report['stageC']['final_log'])}",
        f"- held-out scenes: {s['n_items']} (disjoint seed range from "
        f"{cfg['procedural_length']} train scenes)",
        "",
        "## Results (held-out, solid-voxel IoU)",
        "",
        "| metric | untrained | marrnet2 | shapehd |",
        "|---|---|---|---|",
        f"| IoU @0.5 | {u['iou_0.5']:.4f} | {m['iou_0.5']:.4f} | "
        f"{s['iou_0.5']:.4f} |",
        f"| IoU @best th | {u['iou_best']:.4f} (th {u['iou_best_th']}) | "
        f"{m['iou_best']:.4f} (th {m['iou_best_th']}) | "
        f"{s['iou_best']:.4f} (th {s['iou_best_th']}) |",
        f"| Chamfer distance (mean of {s['chamfer_n']}) | "
        f"{_fmt(u['chamfer_mean'])} | {_fmt(m['chamfer_mean'])} | "
        f"{_fmt(s['chamfer_mean'])} |",
        f"| critic score (realism, higher=better) | — | "
        f"{_fmt(s.get('critic_score_noft'), '.1f')} (frozen stage-A net) | "
        f"{_fmt(s.get('critic_score'), '.1f')} |",
        "",
        "## Critic separation during stage B",
        "",
        "Critic scores on one held-out batch: real solids, fresh G(z) "
        "samples, the stage-A net's outputs.",
        "",
        "| step | D(real) | D(G(z)) | D(marrnet2(x)) |",
        "|---|---|---|---|",
    ]
    for row in report.get("critic_separation", []):
        tag = f"{row['step']}" + (" (final)" if row["epoch"] < 0 else "")
        lines.append(f"| {tag} | {row['d_real']:.1f} | {row['d_gz']:.1f} | "
                     f"{row['d_m2']:.1f} |")
    lines += [
        "",
        "## Stage-C critic-weight sweep",
        "",
        "`auto:R` sets w so that the critic's gradient norm is R times the "
        "BCE's at the start of stage C; w=0 is the continued-supervision "
        "control.  Each variant keeps its best-IoU epoch.",
        "",
        "| w_gan_loss | grad gan/sup at start | best epoch | IoU @0.5 | "
        "IoU @best th | Chamfer | critic score |",
        "|---|---|---|---|---|---|---|",
    ]
    for sw in report.get("shapehd_sweep", []):
        lines.append(
            f"| {sw['w_token']} (={sw['w_gan_loss']:.2g}) | "
            f"{sw['grad_split']['gan_over_sup']:.2f} | "
            f"{sw['best_epoch']} | {sw['iou_0.5']:.4f} | "
            f"{sw['iou_best']:.4f} (th {sw['iou_best_th']}) | "
            f"{_fmt(sw['chamfer_mean'])} | "
            f"{_fmt(sw.get('critic_score'), '.1f')} |")
    lines += [
        "",
        "IoU is against the solid ground-truth occupancy (the MarrNet-2 / "
        "ShapeHD supervision target).  Chamfer follows "
        "`genre_shapehd_tpu_torch/cli/eval_chamfer.py`: marching-cubes "
        "surfaces, 1024 area-weighted samples, bidirectional "
        "`nndistance_score`.",
        "",
        "Artifacts: `qualrun_shapehd.json`, `examples/*.npz`, "
        "`examples/*.obj` in the run logdir.",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
