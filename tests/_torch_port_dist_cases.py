"""Train steps of the PyTorch port for the data-parallel tests
(``tests/test_torch_port_dist.py``): the cases, their seeded inputs, and
a rank's entry point.

Each case builds its model and global batch from seeds, takes this
process's slice of the batch (``parallel.mesh.shard_slice``; all of it
with no group joined) and returns what the tests compare: the global loss
terms, the gradients after the all-reduce, the parameters and buffers
after the step.  Run as a script, one process a rank under torchrun's
environment variables, it joins a gloo group on the CPU, runs every case
and saves each rank's results to ``<out_dir>/rank<r>.pt``:

  RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
      python tests/_torch_port_dist_cases.py <out_dir> <weights_dir> \\
      [<device> [<case>,...]]

(the BatchNorm cases on ``device``, ``cuda:0`` in the card's test).

Imports torch, numpy and the port only (no JAX): the parent test process
holds the JAX side.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from genre_shapehd_tpu_torch.core.registry import (  # noqa: E402
    get_dataset, get_model)
from genre_shapehd_tpu_torch.data.loader import collate  # noqa: E402
from genre_shapehd_tpu_torch.models.base import default_opt  # noqa: E402
from genre_shapehd_tpu_torch.nn.resnet import batch_norm  # noqa: E402
from genre_shapehd_tpu_torch.parallel import mesh  # noqa: E402

TINY = dict(im_size=64, vox_res=32, sph_res=32, z_res=32, padding_margin=16)
LR = 1e-4
#: the global batch (MarrNet-1 also runs B = 3, which 2 ranks do not
#: divide)
B = 4


# ------------------------------------------------------------------ inputs
def bn_input(dims: int, seed: int = 0) -> np.ndarray:
    """(4, 3, ...) with the second half's channel means 1 std above the
    first half's."""
    rng = np.random.default_rng(seed)
    shape = (4, 3) + (6,) * (dims - 1)
    x = rng.standard_normal(shape).astype(np.float32)
    x[2:] += 1.0 + rng.uniform(0, 0.5, (1, 3) + (1,) * (dims - 1))
    return x


def marrnet1_batch(b: int, seed: int = 1) -> dict:
    """A MarrNet-1 batch at 64²: disc silhouettes whose radius grows with
    the sample index, so that the two halves' foreground counts differ."""
    rng = np.random.default_rng(seed)
    s = TINY["im_size"]
    yy, xx = np.mgrid[:s, :s]
    sil = np.zeros((b, s, s, 1), np.float32)
    for i in range(b):
        r = (0.18 + 0.06 * i) * s
        sil[i, ..., 0] = (((yy - s / 2) ** 2 + (xx - s / 2) ** 2)
                          < r * r) * 100.0
    f = lambda *shape: rng.random(shape).astype(np.float32)   # noqa: E731
    return {"rgb": rng.standard_normal((b, s, s, 3)).astype(np.float32),
            "depth": f(b, s, s, 1) * 100.0, "silhou": sil,
            "normal": f(b, s, s, 3) * 100.0,
            "depth_minmax": np.stack([1.2 + 0.2 * f(b), 2.2 + 0.2 * f(b)],
                                     1)}


def _synthetic_batch(model, b: int) -> dict:
    ds = get_dataset("synthetic")(model.opt, "train", model=model)
    batch = collate([ds[i] for i in range(b)])
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def wgangp_draws(b: int, seed: int = 3):
    """z1, alpha, z2 for a global batch of ``b``."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, 200), generator=g),
            torch.rand((b, 1, 1, 1), generator=g),
            torch.randn((b, 200), generator=g))


# ------------------------------------------------------------------- models
def make_model(kind: str, weights_dir: str = None, batch_size: int = B):
    """The case's model on the CPU, from its seeded start or the state
    dict in ``weights_dir`` (the tests write one per case)."""
    if kind == "marrnet1":
        opt = default_opt(device="cpu", pred_depth_minmax=True, no_aug=True,
                          lr=LR, batch_size=batch_size, **TINY)
        model = get_model("marrnet1")(opt)
    elif kind == "genre_joint":
        opt = default_opt(device="cpu", joint_train=True, no_aug=True,
                          surface_weight=10.0, lr=LR, batch_size=batch_size,
                          synthetic_length=batch_size, **TINY)
        model = get_model("genre_full_model")(opt)
    elif kind == "wgangp":
        opt = default_opt(device="cpu", canon_voxel=True, gan_d_iter=1,
                          lr=LR, batch_size=batch_size, vox_res=32,
                          synthetic_length=batch_size)
        model = get_model("wgangp")(opt)
    else:
        raise KeyError(kind)
    model.init_state(0)
    path = weights_dir and os.path.join(weights_dir, f"{kind}.pt")
    if path and os.path.isfile(path):
        for name, sd in torch.load(path).items():
            model.net_modules()[name].load_state_dict(sd)
    if kind == "marrnet1":
        model.net.double()
    return model


def save_atomic(obj, path: str) -> None:
    """``torch.save`` that a reader never sees half written."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def wait_for(path: str, timeout: float = 300) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.isfile(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def case_batch(kind: str, model, b: int = B) -> dict:
    if kind == "marrnet1":
        return marrnet1_batch(b)
    return _synthetic_batch(model, b)


def local(batch: dict) -> dict:
    """This rank's slice of a global numpy batch."""
    idx = mesh.shard_slice(len(next(iter(batch.values()))), mesh.world(),
                           mesh.rank())
    return {k: v[idx] for k, v in batch.items()}


def snapshot(model, metrics) -> dict:
    """Loss terms, gradients (as the optimizers saw them) and every
    parameter and buffer, by net."""
    out = {"loss": {k: float(v) for k, v in metrics.items()},
           "grads": {}, "state": {}}
    for name, net in model.net_modules().items():
        for k, p in net.named_parameters():
            if p.grad is not None:
                out["grads"][f"{name}.{k}"] = p.grad.detach().clone()
        for k, v in net.state_dict().items():
            out["state"][f"{name}.{k}"] = v.detach().clone()
    return out


def run_step(kind: str, weights_dir: str = None, b: int = B,
             steps: int = 1) -> dict:
    """``steps`` train steps of ``kind`` on this rank's slice of its global
    batch of ``b``: the snapshot after the first, each step's loss, and
    the digest of the state after the last."""
    if kind == "genre_joint" and weights_dir and mesh.joined():
        # the parent writes GenRe's start and pinned values while the
        # ranks run the other cases
        for name in ("genre_joint.pt", "genre_joint_pins.pt"):
            wait_for(os.path.join(weights_dir, name))
    model = make_model(kind, weights_dir, batch_size=b)
    dtype = next(model.net_modules()["net" if "net" in model.net_modules()
                                     else "net_d"].parameters()).dtype
    batch = {k: torch.from_numpy(v).to(dtype)
             for k, v in local(case_batch(kind, model, b)).items()}
    kw = {"draws": tuple(d.to(dtype) for d in wgangp_draws(b))} \
        if kind == "wgangp" else {}
    pins = os.path.join(weights_dir or "", "genre_joint_pins.pt")
    with pinned(model, pins if kind == "genre_joint" else None) as own:
        out = snapshot(model, model.train_step(batch, **kw))
    out["pins"] = own
    out["losses"] = [out["loss"]["loss"]] + [
        float(model.train_step(batch, **kw)["loss"])
        for _ in range(steps - 1)]
    out["digest"] = mesh.state_digest(model.net_modules().values())
    return out


PINNED = ("pred_sph_full", "proj_depth")


@contextlib.contextmanager
def pinned(model, path):
    """GenRe's step with net2's output and the camera backprojection at
    the values saved in ``path`` (this rank's rows): each becomes
    x + (saved - x).detach(), the saved value with the gradient of the
    rank's own graph.  Both backprojections assign points to voxels with
    ``floor()``, which turns a rounding difference into a voxel's.
    Yields the values the step computed (to save them, with no ``path``,
    for the other runs)."""
    own = {}
    if model is None or not hasattr(model.net, "depth_and_inpaint"):
        yield own
        return
    dn = model.net.depth_and_inpaint
    forward = dn.forward
    saved = torch.load(path) if path and os.path.isfile(path) else None

    def pin(*args, **kwargs):
        out = forward(*args, **kwargs)
        for k in PINNED:
            own[k] = out[k].detach().clone()
            if saved is not None:
                ref = mesh.local_slice(saved[k]).to(out[k].dtype)
                out[k] = out[k] + (ref - out[k]).detach()
        return out
    dn.forward = pin
    try:
        yield own
    finally:
        del dn.forward


def run_bn(dims: int, device: str = "cpu") -> dict:
    """A train-mode BatchNorm forward and backward on this rank's slice
    of ``bn_input(dims)``: the loss is the mean over samples of a seeded
    weighting of the output, so the ranks' mean is the global one."""
    torch.manual_seed(0)
    bn = batch_norm(3, dims).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    bn.to(device)
    x_all = bn_input(dims)
    w_all = np.random.default_rng(5).standard_normal(x_all.shape).astype(
        np.float32)
    idx = mesh.shard_slice(len(x_all), mesh.world(), mesh.rank())
    x = torch.from_numpy(x_all[idx]).to(device).requires_grad_(True)
    y = bn(x)
    loss = (y * torch.from_numpy(w_all[idx]).to(device)).reshape(
        len(idx), -1).sum(1).mean()
    loss.backward()
    mesh.all_reduce_grads(bn.parameters())
    return {k: v.detach().cpu() for k, v in (
        ("y", y), ("x_grad", x.grad), ("weight_grad", bn.weight.grad),
        ("bias_grad", bn.bias.grad), ("running_mean", bn.running_mean),
        ("running_var", bn.running_var))}


#: every model that ``cli.train`` trains, with its flags
MODELS = {
    "marrnet1": ("marrnet1", dict(pred_depth_minmax=True)),
    "depth_pred_with_sph_inpaint": ("depth_pred_with_sph_inpaint", {}),
    "genre_stage3": ("genre_full_model", dict(surface_weight=10.0)),
    "genre_joint": ("genre_full_model", dict(joint_train=True)),
    "marrnet2": ("marrnet2", dict(canon_sup=True)),
    "marrnet": ("marrnet", dict(canon_sup=True)),
    "shapehd": ("shapehd", dict(canon_sup=True, w_gan_loss=1e-3)),
    "wgangp": ("wgangp", dict(canon_voxel=True)),
}


def run_models() -> dict:
    """One train step and one eval step of every model, from its seeded
    start, on this rank's slice of a synthetic batch of ``B`` (WGAN-GP
    draws its own noise for the global batch): the global loss terms and
    the digest of the state after the step."""
    out = {}
    for name, (net, flags) in MODELS.items():
        opt = default_opt(device="cpu", no_aug=True, lr=LR, batch_size=B,
                          synthetic_length=B, manual_seed=0,
                          **{**TINY, **flags})
        model = get_model(net)(opt)
        model.init_state(0)
        batch = local(_synthetic_batch(model, B))
        train = model.train_step(batch)
        loss, _ = model.eval_step(batch)
        out[name] = {"train": {k: float(v) for k, v in train.items()},
                     "eval": {k: float(v) for k, v in loss.items()},
                     "digest": mesh.state_digest(
                         model.net_modules().values())}
    return out


CASES = {
    "bn2d": lambda w, dev: run_bn(2, dev),
    "bn3d": lambda w, dev: run_bn(3, dev),
    "marrnet1": lambda w, dev: run_step("marrnet1", w, steps=3),
    "marrnet1_b3": lambda w, dev: run_step("marrnet1", w, b=3),
    "wgangp": lambda w, dev: run_step("wgangp", w),
    "models": lambda w, dev: run_models(),
    "genre_joint": lambda w, dev: run_step("genre_joint", w)}


def run_all(weights_dir: str, cases=tuple(CASES), device: str = "cpu"
            ) -> dict:
    """The named cases of the data-parallel tests (BatchNorm's on
    ``device``, the train steps on the CPU)."""
    torch.set_num_threads(2)
    return {c: CASES[c](weights_dir, device) for c in cases}


def spawn_ranks(out_dir: str, weights_dir: str, device: str = "cpu",
                cases=tuple(CASES), world: int = 2):
    """Start ``world`` processes running ``cases`` as the ranks of a gloo
    group; each writes its output to ``<out_dir>/rank<r>.log``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), out_dir,
                 weights_dir, device, ",".join(cases)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def gather(procs, out_dir: str, timeout: float = 300) -> list:
    """Each rank's results, once every rank has exited 0; raises with the
    ranks' output otherwise (a rank still running after ``timeout`` s is
    killed)."""
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    logs = [open(os.path.join(out_dir, f"rank{r}.log")).read()[-3000:]
            for r in range(len(procs))]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"ranks exited {[p.returncode for p in procs]}:"
                           "\n" + "\n".join(logs))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(len(procs))]


def main(argv) -> int:
    out_dir, weights_dir = argv[:2]
    device = argv[2] if len(argv) > 2 else "cpu"
    cases = argv[3].split(",") if len(argv) > 3 else tuple(CASES)
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))
    mesh.join("gloo", torch.device(device), timeout_s=120)
    try:
        results = run_all(weights_dir, cases, device)
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    finally:
        mesh.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
