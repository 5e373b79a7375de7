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
      [<device> [<case>,...] [<sp>]]

(the BatchNorm cases on ``device``, ``cuda:0`` in the card's test).
With ``sp`` > 1 the ranks form a (world / sp, sp) grid and the
spatial-parallel cases (:data:`SP_CASES`, ``tests/test_torch_port_sp.py``)
run GenRe's 3D U-Net on Z slabs; they hold the large results against
the references the parent test writes (:func:`agreement`) and return
the summaries alone.

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
from genre_shapehd_tpu_torch.nn import UNet3D, init_weights  # noqa: E402
from genre_shapehd_tpu_torch.nn.resnet import (  # noqa: E402
    _FlaxStats, batch_norm)
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
    elif kind in ("sp_joint", "sp_stage3"):
        opt = default_opt(device="cpu", joint_train=kind == "sp_joint",
                          no_aug=True, surface_weight=10.0, lr=LR,
                          batch_size=batch_size,
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
    """This rank's slice of a global numpy batch: its dp index's."""
    idx = mesh.shard_slice(len(next(iter(batch.values()))),
                           mesh.size(mesh.DP), mesh.index(mesh.DP))
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


# ---------------------------------------------------- spatial parallelism
#: the 3D U-Net alone: float64, published width, 32³, batch 2
UNET = dict(nf=20, res=32, batch=2)


def unet_inputs():
    """The U-Net's input (B, 32, 32, 32, 2) and the loss's weights."""
    rng = np.random.default_rng(9)
    shape = (UNET["batch"],) + (UNET["res"],) * 3
    return (rng.standard_normal(shape + (2,)),
            rng.standard_normal(shape))


@contextlib.contextmanager
def zero_halos():
    """The negative control of the halos: every slab padded with zeros,
    as if it were the volume."""
    real = mesh.halo

    def pad(x, lo, hi, align=1):
        return torch.nn.functional.pad(
            x, (lo, hi + (-(lo + x.shape[-1] + hi) % align)))
    mesh.halo = pad
    try:
        yield
    finally:
        mesh.halo = real


def run_unet(broken: bool = False) -> dict:
    """The refine net alone in train mode, from a seeded start (float64),
    on the whole input (one process) or on this rank's Z slab of it (sp
    ranks, each holding every row): the logits, each layer's output and
    the gradient of ``sum(logits * w) / B`` there, the input's gradient,
    the parameters' gradients after the all-reduce (every one a slab's
    share) and the running statistics.  ``broken``: zero halos."""
    net = UNet3D(nf=UNET["nf"], res=UNET["res"])
    init_weights(net, torch.Generator().manual_seed(0))
    net.double().train()
    x_all, w_all = unet_inputs()
    sharded = mesh.size(mesh.SP) > 1
    x = torch.from_numpy(x_all).requires_grad_(True)
    acts = {}

    def keep(name):
        def hook(_, __, out):
            out.retain_grad()
            acts[name] = out
        return hook
    for name, m in net.named_children():
        m.register_forward_hook(keep(name))
    with zero_halos() if broken else contextlib.nullcontext():
        xs = mesh.z_slab(x, 3, grad="gather") if sharded else x
        out = net(xs, sharded=sharded)
        loss = (out * torch.from_numpy(w_all)).sum() / UNET["batch"]
        loss.backward()
    mesh.all_reduce_grads(net.parameters(), net.parameters())
    return {"out": out.detach(), "x_grad": x.grad,
            "acts": {k: v.detach() for k, v in acts.items()},
            "act_grads": {k: v.grad for k, v in acts.items()},
            "grads": {k: p.grad for k, p in net.named_parameters()},
            "stats": {k: v for k, v in net.state_dict().items()
                      if "running_" in k}}


def run_halo_align() -> dict:
    """``mesh.halo`` of this rank's slab of 4 planes with a plane of each
    neighbour, aligned to 8 (two zero planes after), and its backward of
    a seeded gradient that is not zero on the align planes: the slab, the
    halo'd slab, that gradient and the slab's gradient."""
    g = torch.Generator().manual_seed(11 + mesh.index(mesh.SP))
    x = torch.randn((2, 3, 4), generator=g, dtype=torch.float64,
                    requires_grad=True)
    y = mesh.halo(x, 1, 1, align=8)
    up = torch.randn(y.shape, generator=g, dtype=torch.float64)
    y.backward(up)
    return {"x": x.detach(), "y": y.detach(), "up": up, "x_grad": x.grad}


def agreement(got: dict, ref: dict) -> dict:
    """Per tensor of ``ref``: the cosine with ``got``, their norm ratio,
    the largest absolute difference and ``ref``'s largest magnitude (the
    summary the sp cases return instead of the tensors)."""
    out = {}
    for k, r in ref.items():
        g, r = got[k].double().ravel(), r.double().ravel()
        gn, rn = float(g.norm()), float(r.norm())
        out[k] = (float(g @ r) / max(gn * rn, 1e-300), gn / max(rn, 1e-300),
                  float((g - r).abs().max()), float(r.abs().max()))
    return out


@contextlib.contextmanager
def sp_fault(model, fault):
    """A fault of the sharded GenRe step: ``avg``, the refine net's
    gradients averaged over sp instead of summed; ``cut``, the slab cut's
    backward without its gather (each rank's 2D nets see their own
    slab's voxel gradient); ``bn_slab``, the U-Net's slab layers'
    BatchNorm reduced over the dp group (each rank's own slab); ``bn_sp``,
    the 2D nets' BatchNorm reduced over the sp group (the dp index's rows
    alone); ``bn_world``, the 2D nets' BatchNorm summed over the world,
    count included, without the division by sp (the sp copies' rows
    counted sp times in the sums and in the count alike: no fault)."""
    if fault is None:
        yield
        return
    saved = {}
    if fault == "avg":
        saved[model, "slab_params"] = model.slab_params
        model.slab_params = lambda: []
    elif fault == "cut":
        real = mesh.z_slab
        saved[mesh, "z_slab"] = real
        mesh.z_slab = lambda x, dim, grad: real(x, dim, "local")
    elif fault == "bn_slab":
        real = mesh.all_reduce_sum
        saved[mesh, "all_reduce_sum"] = real
        mesh.all_reduce_sum = lambda t, g: real(
            t, mesh.DP if g == mesh.WORLD else g)
    elif fault in ("bn_sp", "bn_world"):
        # in the BatchNorm layers alone (masked_mse's count also takes
        # all_reduce_batch)
        reduce = (lambda t: mesh.all_reduce_sum(t, mesh.SP)
                  / mesh.size(mesh.SP)) if fault == "bn_sp" else \
            (lambda t: mesh.all_reduce_sum(t, mesh.WORLD))
        real_forward = _FlaxStats._global_forward
        saved[_FlaxStats, "_global_forward"] = real_forward

        def global_forward(self, x, sharded):
            real = mesh.all_reduce_batch
            mesh.all_reduce_batch = reduce
            try:
                return real_forward(self, x, sharded)
            finally:
                mesh.all_reduce_batch = real
        _FlaxStats._global_forward = global_forward
    else:
        raise KeyError(fault)
    try:
        yield
    finally:
        for (obj, name), v in saved.items():
            if obj is model:
                del model.slab_params
            else:
                setattr(obj, name, v)


def run_sp_step(kind: str, weights_dir: str, fault=None,
                summarize: bool = True) -> dict:
    """GenRe's step (``sp_joint`` or ``sp_stage3``) at the weights and the
    pinned values in ``weights_dir``, on this rank's rows (its dp index's
    slice) and, under sp, its Z slab of the U-Net: the loss terms, the
    digest of the state after the step, and the agreement of the
    gradients and the running statistics with ``<kind>_ref.pt`` (one
    process) and, where it exists, ``<kind>_jax.pt`` (the JAX package);
    without ``summarize``, the gradients and statistics themselves."""
    for name in (f"{kind}.pt", f"{kind}_pins.pt") + (
            (f"{kind}_ref.pt",) if summarize else ()):
        wait_for(os.path.join(weights_dir, name))
    model = make_model(kind, weights_dir)
    batch = {k: torch.from_numpy(v)
             for k, v in local(case_batch(kind, model)).items()}
    pins = os.path.join(weights_dir, f"{kind}_pins.pt")
    with pinned(model, pins), sp_fault(model, fault):
        metrics = model.train_step(batch)
    snap = snapshot(model, metrics)
    out = {"loss": snap["loss"],
           "digest": mesh.state_digest(model.net_modules().values())}
    stats = {k: v for k, v in snap["state"].items() if "running_" in k}
    if not summarize:
        return {**out, "grads": snap["grads"], "stats": stats}
    for ref_name in ("ref", "jax"):
        path = os.path.join(weights_dir, f"{kind}_{ref_name}.pt")
        if os.path.isfile(path):
            ref = torch.load(path)
            out[ref_name] = {"grads": agreement(snap["grads"], ref["grads"]),
                             "stats": agreement(stats, ref["stats"])}
    return out


SP_CASES = {
    "unet": lambda w, dev: run_unet(),
    "unet_zero_halos": lambda w, dev: run_unet(broken=True),
    "halo_align": lambda w, dev: run_halo_align(),
    "sp_stage3": lambda w, dev: run_sp_step("sp_stage3", w),
    "sp_joint": lambda w, dev: run_sp_step("sp_joint", w),
    **{f"sp_joint_{f}": (lambda f: lambda w, dev: run_sp_step(
        "sp_joint", w, f))(f)
       for f in ("avg", "cut", "bn_slab", "bn_sp", "bn_world")}}


def run_all(weights_dir: str, cases=tuple(CASES), device: str = "cpu"
            ) -> dict:
    """The named cases of the data-parallel and spatial-parallel tests
    (BatchNorm's on ``device``, the train steps on the CPU)."""
    torch.set_num_threads(2)
    return {c: {**CASES, **SP_CASES}[c](weights_dir, device) for c in cases}


def spawn_ranks(out_dir: str, weights_dir: str, device: str = "cpu",
                cases=tuple(CASES), world: int = 2, sp: int = 1):
    """Start ``world`` processes running ``cases`` as the ranks of a gloo
    group, laid out (world / sp, sp); each writes its output to
    ``<out_dir>/rank<r>.log``."""
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
                 weights_dir, device, ",".join(cases), str(sp)], env=env,
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
    sp = int(argv[4]) if len(argv) > 4 else 1
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))
    mesh.join("gloo", torch.device(device), timeout_s=120, sp=sp)
    try:
        results = run_all(weights_dir, cases, device)
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    finally:
        mesh.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
