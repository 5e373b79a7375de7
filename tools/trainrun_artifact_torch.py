"""A full-scale training log of the PyTorch port, as markdown
(counterpart of ``tools/trainrun_artifact.py``, with its flags).

Runs the full-GenRe training step at reference scale (batch 4, 256^2
images, 128^3 voxels, bf16; scripts/train_full_genre.sh) for --steps
steps on synthetic data, recording the loss series and each step's wall
time, and writes a markdown file with the loss curve (a table of bucket
means), the start and end loss, the median step time and the raw series
as a JSON block.  The device is named as ``torch.cuda.get_device_name``
gives it.

Usage:  python tools/trainrun_artifact_torch.py --steps 200 \\
            --out build/TRAINRUN_torch.md
        python tools/trainrun_artifact_torch.py --steps 4 --tiny \\
            --device cpu                      # a smoke run at 64^2 -> 32^3
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("build",
                                                  "TRAINRUN_torch.md"))
    ap.add_argument("--net", default="genre_full_model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="64^2 images -> 32^3 voxels, float32 (a smoke run)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch
    from genre_shapehd_tpu_torch.core.device import resolve_device
    from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
    from genre_shapehd_tpu_torch.data.loader import DataLoader, InfiniteLoader
    from genre_shapehd_tpu_torch.models.base import default_opt
    from genre_shapehd_tpu_torch.train.loggers import ComposeLogger
    from genre_shapehd_tpu_torch.train.loop import Trainer

    device = resolve_device(args.device)
    size = (dict(im_size=64, vox_res=32, sph_res=32, z_res=64,
                 padding_margin=16, dtype="float32") if args.tiny else
            dict(im_size=256, vox_res=128, sph_res=128, z_res=256,
                 padding_margin=16, dtype="bfloat16"))
    opt = default_opt(device=str(device), batch_size=args.batch,
                      synthetic_length=args.batch * 8, workers=2, **size)
    torch.manual_seed(0)
    model = get_model(args.net)(opt)
    ds = get_dataset("synthetic")(opt, "train", model=model)
    loader = InfiniteLoader(DataLoader(ds, args.batch, num_workers=2))
    trainer = Trainer(model, opt, ComposeLogger([]))
    trainer.initialize(0)

    losses, times = [], []
    prev = time.perf_counter()
    for i, (dev_batch, _, _) in enumerate(
            trainer._prefetched(loader, args.steps)):
        metrics = trainer._train_step(dev_batch)
        loss = float(metrics["loss"])   # reading it waits for the step
        now = time.perf_counter()
        losses.append(loss)
        if i >= 2 or args.steps <= 2:   # the first two build and warm up
            times.append(now - prev)
        prev = now
        if (i + 1) % 20 == 0:
            print(f"step {i + 1:4d}  loss {loss:.4f}  ({times[-1]:.2f}s)",
                  flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"a loss is not finite: {losses}")

    step_med = statistics.median(times)
    k = max(1, len(losses) // 20)
    rows = "\n".join(
        f"| {i} | {statistics.mean(losses[i:i + k]):.4f} |"
        for i in range(0, len(losses), k))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    res = (f"{size['im_size']}^2 images -> {size['vox_res']}^3 voxels, "
           f"{'bf16' if size['dtype'] == 'bfloat16' else 'float32'}")
    flags = f"--steps {args.steps}" + (" --tiny" if args.tiny else "") + (
        f" --device {args.device}" if args.device != "cuda" else "")
    md = f"""# Full-scale training run (PyTorch port)

Full-GenRe training at reference scale on one GPU, synthetic dataset.
Produced by `python tools/trainrun_artifact_torch.py {flags}`.

- model: `{args.net}`, batch {args.batch}, {res}
  compute, Adam (model defaults), device `{name}`
- steps: {args.steps}
- loss: **{statistics.mean(losses[:k]):.4f} -> {statistics.mean(losses[-k:]):.4f}**
  (first-{k} mean -> last-{k} mean)
- step time (median, incl. host pipeline): **{step_med:.3f}s**
  ({args.batch / step_med:.1f} examples/s)

## Loss series (mean per {k}-step bucket)

| step | loss |
|---|---|
{rows}

Raw JSON: see the fenced block below.

```json
{json.dumps({"losses": [round(x, 5) for x in losses],
             "step_time_median_s": round(step_med, 4)})}
```
"""
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)
    print(f"wrote {args.out}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{step_med:.3f}s/step on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
