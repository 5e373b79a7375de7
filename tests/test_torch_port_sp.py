"""PyTorch port, spatial parallelism (``cli.train --sp``,
``parallel/mesh.py``, ``nn/unet3d.py``) on the CPU: GenRe's 3D U-Net on Z
slabs of gloo ranks against one process on the same global batch, and
against the JAX package on its (dp 4, sp 2) mesh.

The ranks run once for the module (``tests/_torch_port_dist_cases.py``):
2 ranks (dp 1 x sp 2) run the U-Net alone (float64, published width,
32³, batch 2; and with zero halos, the negative control), GenRe's stage-3
and joint steps at 64² -> 32³ (``n_mid`` 2: the 4³ level and the gather
point), and the joint step with each of three faults; 4 ranks (dp 2 x
sp 2) run the two steps again.  GenRe runs in float32 at weights from
the JAX package's init, with net2's output and the camera
backprojection pinned to the JAX step's values, as
``tests/test_torch_port_train.py`` holds one process to JAX (both
backprojections assign points with ``floor()``).  The ranks hold their
gradients and statistics against the one-process run's and JAX's
themselves (``agreement``) and return the summaries.  Bounds, as the
data-parallel tests' (``tests/test_torch_port_dist.py``): loss terms
rtol 1e-5 of one process, gradients by direction and size (net1 0.999,
1 %; net2 and the refine net 0.995, 3 %), running statistics 1e-4 of
their scale.
"""

import contextlib
import os
import re
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.parallel import mesh as pmesh
from genre_shapehd_tpu_torch.core.convert import jax_to_torch
from genre_shapehd_tpu_torch.nn import UNet3D
from genre_shapehd_tpu_torch.nn.voxel_nets import (Conv3D, Deconv3D,
                                                   conv_halo, deconv_halo)
from genre_shapehd_tpu_torch.parallel import mesh
from genre_shapehd_tpu_torch.utils import trace

import _torch_port_dist_cases as C
from _torch_port_util import (calibrate, exact_flax_variance, jax_step,
                              release_memory, to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("sp_stage3", "sp_joint")
#: the negative controls on 2 ranks, and on 4 (the 2D nets' BatchNorm
#: group needs dp > 1 to show)
FAULTS2 = ("avg", "cut", "bn_slab")
FAULTS4 = ("bn_sp",)
#: (cosine, norm ratio) bounds by parameter prefix, as
#: ``tests/test_torch_port_dist.py``'s
BOUNDS = {"net.depth_and_inpaint.net1.": (0.999, 0.01),
          "net.depth_and_inpaint.net2.": (0.995, 0.03),
          "net.refine_net.": (0.995, 0.03)}
#: seconds a group of spawned ranks may take before the test fails
RANK_TIMEOUT = 420


def _jax_reference(kind, wd):
    """The JAX model at the test size from its seeded init, calibrated on
    the case's synthetic batch so that both backprojections see points;
    its float32 step (Flax's two-pass variance) at those weights; the
    weights, its pinned values and its gradients and statistics written
    for the ranks.  Returns (jax model, params, stats, batch, step)."""
    joint = kind == "sp_joint"
    batch = C.case_batch(kind, C.make_model(kind))
    jm = jax_model("genre_full_model")(jax_opt(
        joint_train=joint, no_aug=True, surface_weight=10.0, lr=C.LR,
        batch_size=C.B, **C.TINY))
    state = jm.init_state(jax.random.PRNGKey(0))
    params, stats = calibrate(to_np(state.params["net"]),
                              to_np(state.batch_stats["net"]),
                              batch["rgb"], batch["silhou"], cfg=C.TINY,
                              train=joint)
    state = state.replace(params={"net": jax.tree.map(jnp.asarray, params)})
    step = jax_step(jm, state, batch, dtype="float32")
    C.save_atomic({"net": jax_to_torch(params, stats)},
                  os.path.join(wd, f"{kind}.pt"))
    C.save_atomic({k: torch.from_numpy(np.array(step["pred"][k]))
                   for k in C.PINNED}, os.path.join(wd, f"{kind}_pins.pt"))
    C.save_atomic(_by_net(step["grads"], step["stats"]),
                  os.path.join(wd, f"{kind}_jax.pt"))
    return jm, params, stats, batch, step


def _by_net(grads, stats):
    """JAX-layout gradients and batch statistics under the port's names
    (``net.`` + the state dict's key), running statistics only."""
    return {"grads": {f"net.{k}": v for k, v in
                      jax_to_torch(grads, {}).items()},
            "stats": {f"net.{k}": v for k, v in
                      jax_to_torch({}, stats).items() if "running_" in k}}


@contextlib.contextmanager
def _jax_pinned(pred):
    """The JAX GenRe forward with net2's output and the camera
    backprojection at ``pred``'s values (x + stop_gradient(pinned - x)),
    as the port's are pinned."""
    from genre_shapehd_tpu.models import depth_inpaint as jax_di
    forward = jax_di.DepthInpaintNet.__call__

    def pinned(self, *args, **kwargs):
        out = dict(forward(self, *args, **kwargs))
        for k in C.PINNED:
            ref = jnp.asarray(pred[k], out[k].dtype)
            out[k] = out[k] + jax.lax.stop_gradient(ref - out[k])
        return out
    with mock.patch.object(jax_di.DepthInpaintNet, "__call__", pinned):
        yield


def _jax_mesh_step(jm, params, stats, batch, pred):
    """The JAX joint step's loss terms and gradients on the (dp 4, sp 2)
    mesh of the 8 CPU devices, as ``tests/test_mesh_2d.py`` runs it: the
    batch over dp, the state replicated, the refine net's input sharded
    along Z over sp (``maybe_shard_spatial``), float32; net2's output and
    the camera backprojection pinned to the one-device step's values
    ``pred``."""
    dmesh = pmesh.make_mesh_2d(dp=4, sp=2)
    pmesh.set_active_mesh(dmesh)
    try:
        with exact_flax_variance(), _jax_pinned(pred):
            rep = pmesh.replicated(dmesh)
            grads, (loss, new_stats, _) = jax.jit(
                jax.grad(jm._loss, has_aux=True), static_argnums=3)(
                    jax.device_put(params, rep), jax.device_put(stats, rep),
                    pmesh.shard_batch(batch, dmesh), True)
            return dict(loss=to_np(loss), **_by_net(to_np(grads),
                                                    to_np(new_stats)))
    finally:
        pmesh.set_active_mesh(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks (every case), the references in this process meanwhile
    (the U-Net, the JAX steps, the port's one-process steps pinned at
    JAX's values), then four ranks (the two steps) and, meanwhile, the
    JAX mesh's joint step."""
    d = tmp_path_factory.mktemp("sp")
    out2, out4, wd = (str(d / n) for n in ("out2", "out4", "weights"))
    for p in (out2, out4, wd):
        os.makedirs(p)
    cases2 = ("unet", "unet_zero_halos", "halo_align") + KINDS + tuple(
        f"sp_joint_{f}" for f in FAULTS2 + ("bn_world",))
    procs = C.spawn_ranks(out2, wd, cases=cases2, world=2, sp=2)
    ref, jax_ref = {}, {}
    try:
        torch.set_num_threads(2)
        ref["unet"] = C.run_unet()
        for kind in KINDS:
            jax_ref[kind] = _jax_reference(kind, wd)
            one = C.run_sp_step(kind, wd, summarize=False)
            C.save_atomic({"grads": one["grads"], "stats": one["stats"]},
                          os.path.join(wd, f"{kind}_ref.pt"))
            ref[kind] = {"loss": one["loss"]}
    finally:
        ranks2 = C.gather(procs, out2, timeout=RANK_TIMEOUT)
    procs = C.spawn_ranks(out4, wd, cases=KINDS + tuple(
        f"sp_joint_{f}" for f in FAULTS4), world=4, sp=2)
    try:
        jm, params, stats, batch, step = jax_ref["sp_joint"]
        jax_mesh = _jax_mesh_step(jm, params, stats, batch, step["pred"])
    finally:
        ranks4 = C.gather(procs, out4, timeout=RANK_TIMEOUT)
    shutil.rmtree(d, ignore_errors=True)
    yield dict(ref=ref, ranks2=ranks2, ranks4=ranks4, jax_mesh=jax_mesh,
               jax={k: {"loss": v[4]["loss"], **_by_net(v[4]["grads"],
                                                        v[4]["stats"])}
                    for k, v in jax_ref.items()})
    release_memory()


def _within(summary, bounds=BOUNDS, stats_tol=1e-4):
    """The faults of a rank's ``agreement`` summary against the bounds:
    a gradient whose reference is not negligible (1e-6 of its prefix's
    largest) outside its prefix's (cosine, norm ratio) bound, one that is
    negligible beyond 1e-4 of that largest, a running statistic beyond
    ``stats_tol`` of its scale."""
    bad = []
    grads = summary["grads"]
    for prefix, (cos_min, ratio_max) in bounds.items():
        keys = [k for k in grads if k.startswith(prefix)]
        big = max(grads[k][3] for k in keys)
        for k in keys:
            cos, ratio, err, scale = grads[k]
            if scale <= 1e-6 * big:
                if err > 1e-4 * big:
                    bad.append((k, err, big))
            elif cos < cos_min or abs(ratio - 1) > ratio_max:
                bad.append((k, cos, ratio))
    for k, (_, _, err, scale) in summary["stats"].items():
        if err > stats_tol * (scale + 1e-6):
            bad.append((k, err, scale))
    return bad


# ------------------------------------------------------------ the U-Net
def _assemble(values, full):
    """The ranks' values of one tensor as one process holds it: slabs
    joined along Z (the last dim), or the whole where each holds it."""
    if values[0].shape == full.shape:
        return values[0]
    return torch.cat(values, -1)


def test_unet_on_two_ranks_is_one_process(runs):
    """The refine net on Z slabs of 2 ranks (float64): the logits, every
    layer's output and the gradient of the loss there (the ranks' slabs
    joined; where every rank holds the whole, a redundant layer past the
    gather point, each holds its slab's share, and the shares sum to it),
    the input's gradient, each parameter's gradient after the all-reduce
    and the running statistics of every BatchNorm equal one process's
    within 1e-9 of their scale (a bias ahead of a BatchNorm, 0 in exact
    arithmetic: 1e-12 of the largest gradient)."""
    ref = runs["ref"]["unet"]
    got = [r["unet"] for r in runs["ranks2"]]
    for r in got:
        assert r["out"].shape == ref["out"].shape   # gathered on each rank

    def close(a, b, what, floor=0.0):
        scale = max(float(b.abs().max()), floor)
        err = float((a - b).abs().max())
        assert err <= 1e-9 * scale, (what, err, scale)
    for r in got:
        close(r["out"], ref["out"], "logits")
        close(r["x_grad"], ref["x_grad"], "input gradient")
    sharded = 0
    for k, full in ref["acts"].items():
        close(_assemble([r["acts"][k] for r in got], full), full, k)
        grads = [r["act_grads"][k] for r in got]
        whole = grads[0].shape == full.shape
        sharded += not whole
        close(sum(grads) if whole else torch.cat(grads, -1),
              ref["act_grads"][k], f"gradient at {k}")
    # stem, 2 levels, dec k4, dec k8, dec6, their 5 BatchNorms
    assert sharded == 11, sharded
    big = max(float(v.abs().max()) for v in ref["grads"].values())
    for r in got:
        for k, v in ref["grads"].items():
            close(r["grads"][k], v, k, floor=1e-3 * big)
        for k, v in ref["stats"].items():
            close(r["stats"][k], v, k)


def test_unet_without_halos_is_caught(runs):
    """The negative control: with zero planes for every halo the slabs'
    logits, and the gradients, miss one process's by far more than the
    bound."""
    ref = runs["ref"]["unet"]
    got = runs["ranks2"][0]["unet_zero_halos"]
    err = float((got["out"] - ref["out"]).abs().max())
    assert err > 1e-3 * float(ref["out"].abs().max()), err
    gx = float((got["x_grad"] - ref["x_grad"]).abs().max())
    assert gx > 1e-3 * float(ref["x_grad"].abs().max()), gx


def test_the_halo_returns_each_plane_s_gradient_to_its_owner(runs):
    """``mesh.halo`` on 2 ranks, slabs of 4 planes, a plane of each
    neighbour and zero planes up to 8: forward, a neighbour's plane and
    zeros at the volume's ends; backward, the gradient of the halo'd
    slab's own planes, plus the neighbour's gradient of the plane it
    borrowed, and nothing of the align planes', exactly."""
    r0, r1 = (r["halo_align"] for r in runs["ranks2"])
    x0, x1 = r0["x"], r1["x"]
    zero = torch.zeros_like(x0[..., :1])
    align = torch.zeros_like(x0[..., :2])
    assert torch.equal(r0["y"], torch.cat([zero, x0, x1[..., :1], align],
                                          -1))
    assert torch.equal(r1["y"], torch.cat([x0[..., -1:], x1, zero, align],
                                          -1))
    want0 = r0["up"][..., 1:5].clone()
    want0[..., -1] += r1["up"][..., 0]
    want1 = r1["up"][..., 1:5].clone()
    want1[..., 0] += r0["up"][..., 5]
    assert torch.equal(r0["x_grad"], want0)
    assert torch.equal(r1["x_grad"], want1)


def _reach(layer, z, s, transposed):
    """The input planes (outside a slab of ``s`` planes at ``z``) that the
    slab's outputs of ``layer`` read, by the gradient of their sum on a
    volume of 1 channel, 3 x 3 x 24: (before, after)."""
    x = torch.zeros((1, layer.in_channels, 3, 3, 24), dtype=torch.float64,
                    requires_grad=True)
    with torch.no_grad():
        layer.weight.fill_(1.0)
    y = layer(x + 1.0)
    st = layer.stride[2]
    lo, hi = (z * st, (z + s) * st) if transposed else (z // st,
                                                        (z + s) // st)
    y[..., lo:hi].sum().backward()
    reads = (x.grad[0, 0, 1, 1] != 0).nonzero().ravel().tolist()
    return z - min(reads), max(reads) - (z + s - 1)


@pytest.mark.parametrize("res", [32, 128])
def test_every_layer_takes_the_halo_it_reaches(res):
    """Each Conv3d and ConvTranspose3d of the U-Net (stem k8 s2 p3, k4 s2
    p1 levels, dec5 k8 s2 p3, dec6 k4 s2 p1; not the VALID layers past
    the gather point): the halo that ``conv_halo`` / ``deconv_halo``
    derive from (k, s, p) is the one the layer's outputs of a slab read,
    measured by gradient, on a slab of 8 planes in the middle of 24."""
    net = UNet3D(nf=4, res=res)
    layers = [(n, m) for n, m in net.named_children()
              if isinstance(m, (Conv3D, Deconv3D))]
    checked = 0
    for name, m in layers:
        transposed = isinstance(m, Deconv3D)
        c = m.ConvTranspose_0 if transposed else m.Conv_0
        k, s, p = c.kernel_size[2], c.stride[2], c.padding[2]
        if p == 0:                  # the VALID layers run on the whole
            continue
        layer = torch.nn.Conv3d(1, 1, k, s, p, bias=False) if not \
            transposed else torch.nn.ConvTranspose3d(1, 1, k, s, p,
                                                     bias=False)
        layer.double()
        want = _reach(layer, 8, 8, transposed)
        got = deconv_halo(k, s, p)[:2] if transposed else conv_halo(k, s, p)
        assert tuple(got) == want, (name, (k, s, p), got, want)
        checked += 1
    assert checked == 2 * (int(np.log2(res)) - 3) + 2, checked


# ------------------------------------------------------------ GenRe steps
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_genre_step_on_z_slabs_is_one_process(runs, kind, world):
    """GenRe's stage-3 and joint steps on 2 ranks (dp 1 x sp 2) and 4
    (dp 2 x sp 2): the loss terms within rtol 1e-5 of one process's on
    the global batch, every gradient within the bounds, the running
    statistics within 1e-4 of their scale; every rank's state the same
    bits.  In stage 3 the 2D nets take no gradient."""
    ref = runs["ref"][kind]
    ranks = runs[f"ranks{world}"]
    assert len({r[kind]["digest"] for r in ranks}) == 1
    bounds = dict(BOUNDS) if kind == "sp_joint" else {
        "net.refine_net.": BOUNDS["net.refine_net."]}
    for r in ranks:
        got = r[kind]
        assert sorted(got["loss"]) == sorted(ref["loss"])
        for k, v in ref["loss"].items():
            np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5,
                                       err_msg=k)
        assert not _within(got["ref"], bounds), _within(got["ref"], bounds)
        if kind == "sp_stage3":
            nets = [v for k, v in got["ref"]["grads"].items()
                    if k.startswith("net.depth_and_inpaint.")]
            assert all(err == 0.0 and scale == 0.0
                       for _, _, err, scale in nets)


@pytest.mark.parametrize("fault", FAULTS2 + FAULTS4)
def test_each_fault_of_the_sharded_step_is_caught(runs, fault):
    """The negative controls, each on the joint step: the refine net's
    gradients averaged over sp instead of summed (its gradients half
    their size); the slab cut's backward without its gather (the 2D nets
    see half the voxel loss's gradient); the U-Net's slab layers'
    BatchNorm over the dp group (one slab's statistics); on 4 ranks, the
    2D nets' BatchNorm over the sp group (one dp index's rows).  Each
    breaks the bounds that the step holds, where its mechanism acts."""
    ranks = runs["ranks4"] if fault in FAULTS4 else runs["ranks2"]
    bad = _within(ranks[0][f"sp_joint_{fault}"]["ref"])
    assert bad, f"{fault}: within every bound"
    prefixes = {"avg": "net.refine_net.", "cut": "net.depth_and_inpaint.",
                "bn_slab": "net.refine_net.",
                "bn_sp": "net.depth_and_inpaint."}
    assert any(b[0].startswith(prefixes[fault]) for b in bad), bad


def test_the_2d_batchnorm_over_the_world_equals_the_dp_groups(runs):
    """The 2D nets' BatchNorm summed over the world, its count with it (no
    division by sp), is the same function as over the dp group: the sp
    copies' rows count sp times in the sums and in the count alike, so
    the statistics are the global batch's, and the backward's sum over
    the world of each copy's gradient, through 1 / n, is one copy's.  On
    2 ranks the step stays within every bound, as the step of
    ``mesh.all_reduce_batch`` (the world's sum over sp, which gives every
    copy the same bits) does."""
    got = runs["ranks2"][0]["sp_joint_bn_world"]
    assert not _within(got["ref"]), _within(got["ref"])
    for k, v in runs["ref"]["sp_joint"]["loss"].items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5, err_msg=k)


def test_dp2_sp2_matches_the_jax_mesh(runs):
    """The joint step on the shared weights: the JAX package on its (dp 4,
    sp 2) mesh of 8 CPU devices, and the port on dp 2 x sp 2, each
    against the JAX one-device step with
    ``tests/test_torch_port_train.py``'s bounds (loss terms rtol 1e-4;
    net1 0.999, 1 %; net2 and the refine net 0.995, 3 %; running
    statistics 2e-3 of their scale), each pinned to the one-device step's
    values of net2's output and the camera backprojection (unpinned, the
    mesh's partitioned 2D nets move points across voxel faces: its voxel
    loss 2.2e-5 from one device's, net2's gradients at cosine 0.94).
    The batches over dp differ in size (1 and 2 a shard); the global
    batch is the same."""
    one = runs["jax"]["sp_joint"]
    mesh_run = runs["jax_mesh"]
    for k, v in one["loss"].items():
        np.testing.assert_allclose(float(mesh_run["loss"][k]), float(v),
                                   rtol=1e-4, err_msg=k)
    jax_vs_jax = {"grads": C.agreement(mesh_run["grads"], one["grads"]),
                  "stats": C.agreement(mesh_run["stats"], one["stats"])}
    assert not _within(jax_vs_jax, BOUNDS, 2e-3), _within(jax_vs_jax,
                                                          BOUNDS, 2e-3)
    for r in runs["ranks4"]:
        got = r["sp_joint"]
        for k, v in one["loss"].items():
            np.testing.assert_allclose(got["loss"][k], float(v), rtol=1e-4,
                                       err_msg=k)
        assert not _within(got["jax"], BOUNDS, 2e-3), _within(
            got["jax"], BOUNDS, 2e-3)


# ---------------------------------------------------------------- cli.train
def _cli_args(logdir, expr, net="genre_full_model"):
    flags = (["--joint_train", "--pred_depth_minmax", "--surface_weight",
              "10"] if net == "genre_full_model" else ["--canon_voxel"])
    return ["--net", net] + flags + [
        "--dataset", "synthetic", "--batch_size", "4", "--epoch", "1",
        "--epoch_batches", "2", "--eval_batches", "1",
        "--synthetic_length", "4", "--workers", "2", "--logdir", logdir,
        "--device", "cpu", "--log_batch", "--manual_seed", "0",
        "--save_net", "0", "--im_size", "64", "--vox_res", "32",
        "--sph_res", "32", "--z_res", "32", "--vis_batches_vali", "1",
        "--expr_id", expr]


def _csv(path):
    import csv
    with open(path) as f:
        return list(csv.DictReader(f))


def _torchrun(args):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "genre_shapehd_tpu_torch.cli.train",
         "--multihost", "--sp", "2", "--dist_backend", "gloo"] + args,
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_cli_train_sp2_on_two_cpu_ranks(tmp_path):
    """``cli.train --multihost --sp 2`` under ``torch.distributed.run`` on 2
    CPU ranks, GenRe's joint step at 64² -> 32³, 2 steps and an eval
    batch, beside the same command in one process: both ranks end with
    one parameter hash, rank 0 alone writes, the batch losses are the
    one-process run's (step 1: the loss rtol 1e-4, every term 2e-3, for
    the backprojections are not pinned and another summation order moves
    a point across a voxel face; step 2, after Adam's first, sign-like,
    update: 1e-2, measured 3.2e-3), rank 0's profiled step 2 holds the
    halo and gather spans; and
    WGAN-GP, which does not shard, runs replicated over sp with one
    hash."""
    logdir = str(tmp_path / "logs")
    try:
        sp = _torchrun(_cli_args(logdir, "1") + ["--profile_step", "2"])
        gan = _torchrun(_cli_args(logdir, "2", "wgangp"))
        from genre_shapehd_tpu_torch.cli import train
        torch.set_num_threads(2)
        assert train.main(_cli_args(logdir, "0") + [
            "--vis_batches_vali", "0"]) == 0
        for proc in (sp, gan):
            out, _ = proc.communicate(timeout=RANK_TIMEOUT)
            assert proc.returncode == 0, out[-5000:]
            hashes = re.findall(
                r"\[dp\] rank \d of 2: parameters and buffers sha1 "
                r"([0-9a-f]+); kernel launches \{", out)
            assert len(hashes) == 2 and hashes[0] == hashes[1], hashes
        run = os.path.join(logdir, "genre_full_model_synthetic_0.0001")
        got = _csv(os.path.join(run, "1", "batch_loss.csv"))
        ref = _csv(os.path.join(run, "0", "batch_loss.csv"))
        assert len(got) == len(ref) == 2
        for step, (g, r) in enumerate(zip(got, ref)):
            assert g["size"] == r["size"] == "4.0"
            for k in ("loss", "voxel_loss", "surface_loss", "depth",
                      "spherical"):
                tol = (1e-4 if k == "loss" else 2e-3) if step == 0 \
                    else 1e-2
                np.testing.assert_allclose(float(g[k]), float(r[k]),
                                           rtol=tol,
                                           err_msg=f"step {step} {k}")
        import json
        with open(os.path.join(run, "1", "profile_step.json")) as f:
            prof = json.load(f)
        assert prof["world"] == 2 and prof["sp"] == 2, prof
        # forward and backward: a halo a slab layer (stem, 2 levels, 3
        # deconvs); the 4³ gather and its sum, the logits' gather, the
        # cut's gradient
        assert prof["spans"][trace.SP_HALO]["calls"] == 12, prof["spans"]
        assert prof["spans"][trace.SP_GATHER]["calls"] == 4, prof["spans"]
        assert os.path.isfile(os.path.join(run, "1", "epoch0001_vali",
                                           "batch0000.npz"))
        assert len(_csv(os.path.join(
            logdir, "wgangp_synthetic_0.0001", "2", "batch_loss.csv"))) == 2
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def test_sp_launch_faults_raise(tmp_path, monkeypatch):
    """``--sp 2`` without ``--multihost`` raises, and so does ``--sp 3`` on
    2 ranks (the JAX package drops the spare devices instead), before any
    group is joined or logdir made."""
    from genre_shapehd_tpu_torch.cli import train
    args = _cli_args(str(tmp_path / "logs"), "0")
    with pytest.raises(ValueError, match="--multihost"):
        train.main(args + ["--sp", "2"])
    for k, v in dict(RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29998").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="does not divide the 2 ranks"):
        train.main(args + ["--multihost", "--sp", "3"])
    assert not mesh.joined()
    assert not os.path.exists(tmp_path / "logs")
