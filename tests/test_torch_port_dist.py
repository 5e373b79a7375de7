"""PyTorch port, data parallelism across processes (``parallel/mesh.py``,
``cli.train --multihost``) on the CPU: two ranks on the gloo backend
against one process on the same global batch, and MarrNet-1's step
against the JAX package on a 2-device mesh.

The ranks run once for the module (``tests/_torch_port_dist_cases.py``,
two spawned processes): BatchNorm2d / 3d, MarrNet-1 (one step compared,
three steps hashed; global batch 4, and 3 on 2 ranks), GenRe's joint
step and a WGAN-GP step with the global draws passed in.  Precision
shapes the bounds:
- MarrNet-1 runs in float64 in both runs, so the comparison sees the
  semantics and not float32 rounding (at 64² a deep BatchNorm's bias
  gradient moves by 0.6 % of its scale with the summation order alone).
  Leaves that are 0 in exact arithmetic (a bias ahead of a BatchNorm)
  are held to the scale of the largest gradient (1e-6 of it).
- GenRe runs in float32 (its renderer and nets take the compute dtype),
  with net2's output and the camera backprojection pinned to the
  one-process values: both backprojections assign points to voxels with
  ``floor()``.  Its gradients are held per tensor by direction and size,
  with ``tests/test_torch_port_train.py``'s bounds.
- WGAN-GP runs in float32.  The critic's LeakyReLU puts kinks in the
  penalty's input gradient: a 1e-7 change of the input moves one
  sample's gradient norm by 2.6e-4 (measured, in one process), so the
  penalty is held to 2e-3; G's step reads the critic after its Adam
  step, whose first update is a sign, so G's gradients are held by
  direction and size.
"""

import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.data.loader import DataLoader as JaxDataLoader
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.parallel import mesh as pmesh
from genre_shapehd_tpu_torch.core.convert import jax_to_torch, torch_to_jax
from genre_shapehd_tpu_torch.core.device import device_name, resolve_device
from genre_shapehd_tpu_torch.data.loader import DataLoader
from genre_shapehd_tpu_torch.models.base import masked_mse
from genre_shapehd_tpu_torch.parallel import mesh

import _torch_port_dist_cases as C
from _torch_port_util import (calibrate, exact_flax_variance, f64,
                              release_memory, to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The weights each case starts from (MarrNet-1 from the JAX init,
    GenRe calibrated so that both backprojections see points), GenRe's
    pinned values from one process, then the two ranks and, meanwhile,
    every case in this process."""
    d = tmp_path_factory.mktemp("dist")
    out, wd = str(d / "out"), str(d / "weights")
    os.makedirs(out)
    os.makedirs(wd)
    jm = jax_model("marrnet1")(jax_opt(
        pred_depth_minmax=True, no_aug=True, lr=C.LR, batch_size=C.B,
        **C.TINY))
    state = jm.init_state(jax.random.PRNGKey(0))
    torch.save({"net": jax_to_torch(to_np(state.params["net"]),
                                    to_np(state.batch_stats["net"]))},
               os.path.join(wd, "marrnet1.pt"))
    procs = C.spawn_ranks(out, wd)       # GenRe last: it waits for its files
    try:
        torch.set_num_threads(2)
        genre = C.make_model("genre_joint")
        batch = C.case_batch("genre_joint", genre)
        params, stats = calibrate(*torch_to_jax(genre.net.state_dict()),
                                  batch["rgb"], batch["silhou"], cfg=C.TINY,
                                  train=True)
        C.save_atomic({"net": jax_to_torch(params, stats)},
                      os.path.join(wd, "genre_joint.pt"))
        # unpinned, so the values it pins for the ranks are its own
        ref = {"genre_joint": C.run_step("genre_joint", wd)}
        C.save_atomic(ref["genre_joint"]["pins"],
                      os.path.join(wd, "genre_joint_pins.pt"))
        ref.update(C.run_all(wd, [c for c in C.CASES if c != "genre_joint"]))
    finally:
        ranks = C.gather(procs, out)
    # the ranks' results hold GenRe's gradients and state: ~3 GB
    shutil.rmtree(d, ignore_errors=True)
    yield dict(ref=ref, ranks=ranks, jm=jm, state=state)
    release_memory()


def _close(got, ref, tol, what, floor=0.0):
    """max |got - ref| within ``tol`` of ref's scale (at least ``floor``)."""
    scale = max(float(ref.abs().max()), floor)
    err = float((got.double() - ref.double()).abs().max())
    assert err <= tol * scale, (what, err, scale)


def _grads_close(got, ref, tol):
    """Every gradient within ``tol`` of its own scale; a leaf that is 0
    in exact arithmetic is held to 1e-6 of the largest one's scale."""
    assert sorted(got) == sorted(ref)
    big = max(float(v.abs().max()) for v in ref.values())
    for k, v in ref.items():
        _close(got[k], v, tol, k, floor=1e-6 * big)


def _direction_and_size(got, ref, prefix, cos_min, ratio_max):
    """Under ``prefix``: every gradient's cosine with the reference and
    the distance of their norm ratio from 1, where the reference is not
    negligible (1e-6 of the largest); elsewhere within 1e-4 of it."""
    keys = [k for k in ref if k.startswith(prefix)]
    big = max(float(ref[k].abs().max()) for k in keys)
    for k in keys:
        g, r = got[k].double().ravel(), ref[k].double().ravel()
        if float(r.abs().max()) <= 1e-6 * big:
            assert float((g - r).abs().max()) <= 1e-4 * big, k
            continue
        cos = float(g @ r / (g.norm() * r.norm()))
        ratio = abs(float(g.norm() / r.norm()) - 1)
        assert cos >= cos_min and ratio <= ratio_max, (k, cos, ratio)


def _stats_close(got, ref, tol):
    for k, v in ref.items():
        if "running_" in k:
            _close(got[k], v, tol, k)


# ------------------------------------------------------------------ loader
class _Indices:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"i": np.array([i], np.float32)}


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_are_the_jax_loaders(shuffle):
    """N = 2 dividing B = 4: each shard's batches are the JAX loader's,
    shuffled by the same seed or in order, and the data its indices'."""
    for shard in range(2):
        kw = dict(shuffle=shuffle, seed=3, drop_last=True, shard_id=shard,
                  num_shards=2)
        got = DataLoader(_Indices(), 4, num_workers=2, **kw)
        ref = JaxDataLoader(_Indices(), 4, num_workers=2, **kw)
        assert got._index_batches() == ref._index_batches()
        assert [b["i"][:, 0].astype(int).tolist() for b in got] == \
            ref._index_batches()


def test_loader_repeats_a_batch_the_shards_do_not_divide():
    """B = 3 on N = 2: the batch repeated to lcm(3, 2) = 6, each sample
    twice over the two shards; the shards of one size."""
    shards = [DataLoader(_Indices(), 3, shuffle=True, seed=1,
                         drop_last=True, shard_id=r, num_shards=2)
              ._index_batches() for r in range(2)]
    full = DataLoader(_Indices(), 3, shuffle=True, seed=1,
                      drop_last=True)._index_batches()
    for a, b, whole in zip(*shards, full):
        assert len(a) == len(b) == 3
        assert sorted(a + b) == sorted(whole * 2)
        assert a == [whole[0], whole[0], whole[1]]
    assert mesh.shard_slice(4, 8, 5).tolist() == [2]
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(_Indices(), 4, shard_id=0, num_shards=2)


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("dims", [2, 3])
def test_batchnorm_takes_the_global_batch(runs, dims):
    """Two ranks' train-mode BatchNorm equals one process's on the whole
    batch: outputs and input gradients within 1e-5 of their scale (a
    rank's input gradient is that of the sum of the ranks' losses, N
    times the mean's), parameter gradients after the all-reduce, running
    statistics within 1e-6.  The halves' channel means differ by more
    than 0.5 std, and statistics of the halves would miss by more than
    the bound (the negative control)."""
    case = f"bn{dims}d"
    ref = runs["ref"][case]
    x = C.bn_input(dims)
    axes = (0,) + tuple(range(2, x.ndim))
    gap = np.abs(x[2:].mean(axes) - x[:2].mean(axes)) / x.std(axes)
    assert (gap >= 0.5).all(), gap
    for r, res in enumerate(runs["ranks"]):
        idx = mesh.shard_slice(4, 2, r)
        mine = {k: v[idx] for k, v in ref.items() if k in ("y", "x_grad")}
        _close(res[case]["y"], mine["y"], 1e-5, "y")
        _close(res[case]["x_grad"], 2 * mine["x_grad"], 1e-5, "x_grad")
        for k in ("weight_grad", "bias_grad"):
            _close(res[case][k], ref[k], 1e-5, k)
        for k in ("running_mean", "running_var"):
            err = float((res[case][k] - ref[k]).abs().max())
            assert err <= 1e-6, (k, err)
    # one process on a half (its own statistics) misses the global output
    from genre_shapehd_tpu_torch.nn.resnet import batch_norm
    torch.manual_seed(0)
    bn = batch_norm(3, dims).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        half = bn(torch.from_numpy(x[:2]))
    err = float((half - ref["y"][:2]).abs().max())
    assert err > 1e-5 * float(ref["y"].abs().max()), err


# ------------------------------------------------------------- train steps
def test_marrnet1_step_on_two_ranks_is_the_global_batchs(runs):
    """MarrNet-1 (float64): loss terms rtol 1e-5, gradients within 1e-4
    of each leaf's scale, running statistics 1e-5.  The halves'
    foreground counts differ by more than 20 %, and a rank-local
    normalizer of ``masked_mse`` would miss the global loss by more than
    the bound (the negative control)."""
    ref = runs["ref"]["marrnet1"]
    for res in runs["ranks"]:
        got = res["marrnet1"]
        assert sorted(got["loss"]) == sorted(ref["loss"])
        for k, v in ref["loss"].items():
            np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5,
                                       err_msg=k)
        _grads_close(got["grads"], ref["grads"], 1e-4)
        _stats_close(got["state"], ref["state"], 1e-5)
    batch = C.marrnet1_batch(C.B)
    fg = (batch["silhou"] != 0).reshape(C.B, -1).sum(1)
    assert fg[2:].sum() >= 1.2 * fg[:2].sum(), fg
    rng = np.random.default_rng(7)
    pred = torch.from_numpy(rng.random(batch["depth"].shape) * 100)
    gt, mask = (torch.from_numpy(batch[k]) for k in ("depth", "silhou"))
    whole = float(masked_mse(pred, gt, mask != 0))
    halves = np.mean([float(masked_mse(pred[s], gt[s], mask[s] != 0))
                      for s in (slice(0, 2), slice(2, 4))])
    assert abs(halves / whole - 1) > 1e-3, (halves, whole)


def test_marrnet1_two_ranks_match_the_jax_mesh(runs):
    """The same global batch through the JAX package's MarrNet-1 loss on
    a 2-device mesh (batch sharded, state replicated, float64 with Flax's
    two-pass variance): loss terms rtol 1e-4, gradients by direction and
    size (0.999, 1 %), running statistics 2e-3 of their scale -- the
    bounds of ``test_train_step_matches_jax``."""
    jm, state = runs["jm"], runs["state"]
    batch = C.marrnet1_batch(C.B)
    dmesh = pmesh.make_mesh(jax.devices()[:2])
    jm.net = jm.net.clone(dtype=jnp.float64)
    with jax.enable_x64(True), exact_flax_variance():
        rep = pmesh.replicated(dmesh)
        params = jax.device_put(f64(state.params["net"]), rep)
        stats = jax.device_put(f64(state.batch_stats["net"]), rep)
        grads, (loss, new_stats, _) = jax.jit(
            jax.grad(jm._loss, has_aux=True), static_argnums=3)(
                params, stats, pmesh.shard_batch(f64(batch), dmesh), True)
        grads, loss, new_stats = to_np(grads), to_np(loss), \
            to_np(new_stats)
    ref_grads = {f"net.{k}": v for k, v in jax_to_torch(grads, {}).items()}
    ref_stats = {f"net.{k}": v for k, v in
                 jax_to_torch({}, new_stats).items()}
    for res in runs["ranks"]:
        got = res["marrnet1"]
        for k, v in loss.items():
            np.testing.assert_allclose(got["loss"][k], float(v), rtol=1e-4,
                                       err_msg=k)
        _direction_and_size(got["grads"], ref_grads, "net.", 0.999, 0.01)
        for k, v in ref_stats.items():
            if "running_" in k:
                _close(got["state"][k], v, 2e-3, k, floor=1e-6)


def test_batch_of_three_on_two_ranks_is_the_batch_of_three(runs):
    """B = 3 on 2 ranks (each sample twice over the ranks): loss terms and
    gradients of B = 3 in one process, as ``tests/test_mesh_pad.py``
    holds the JAX mesh to."""
    ref = runs["ref"]["marrnet1_b3"]
    for res in runs["ranks"]:
        got = res["marrnet1_b3"]
        for k, v in ref["loss"].items():
            np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5,
                                       err_msg=k)
        _grads_close(got["grads"], ref["grads"], 1e-4)
        _stats_close(got["state"], ref["state"], 1e-5)


def test_genre_joint_step_on_two_ranks_is_the_global_batchs(runs):
    """GenRe's joint step (float32, net2's output and the camera
    backprojection pinned): loss terms rtol 1e-5; gradients by direction
    and size with ``test_train_step_matches_jax``'s bounds (net1 0.999,
    1 %; net2 and the refine net 0.995, 3 %); running statistics 1e-4 of
    their scale (float32 through ~80 layers)."""
    ref = runs["ref"]["genre_joint"]
    for r, res in enumerate(runs["ranks"]):
        got = res["genre_joint"]
        for k, v in ref["loss"].items():
            np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5,
                                       err_msg=k)
        for prefix, bound in (("net.depth_and_inpaint.net1.", (0.999, 0.01)),
                              ("net.depth_and_inpaint.net2.", (0.995, 0.03)),
                              ("net.refine_net.", (0.995, 0.03))):
            _direction_and_size(got["grads"], ref["grads"], prefix, *bound)
        _stats_close(got["state"], ref["state"], 1e-4)
        # the renderer and both backprojections are per sample: the
        # rank's own values are its rows of the one-process run's
        for k, v in got["pins"].items():
            _close(v, ref["pins"][k][mesh.shard_slice(C.B, 2, r)], 1e-3, k)


def test_wgangp_step_on_two_ranks_is_the_global_batchs(runs):
    """WGAN-GP (float32, the global draws passed in, ``--gan_d_iter 1``):
    err_d_real, err_d_fake and err_g rtol 1e-5, the penalty (and err_d)
    2e-3; D's gradients by direction and size (0.99999, 1e-4), G's
    (0.9999, 0.3 %); G's running statistics 1e-5."""
    ref = runs["ref"]["wgangp"]
    for res in runs["ranks"]:
        got = res["wgangp"]
        assert sorted(got["loss"]) == sorted(ref["loss"])
        for k, v in ref["loss"].items():
            tol = 2e-3 if k in ("err_d_gp", "err_d", "loss") else 1e-5
            np.testing.assert_allclose(got["loss"][k], v, rtol=tol,
                                       err_msg=k)
        _direction_and_size(got["grads"], ref["grads"], "net_d.", 0.99999,
                            1e-4)
        _direction_and_size(got["grads"], ref["grads"], "net_g.", 0.9999,
                            3e-3)
        _stats_close(got["state"], ref["state"], 1e-5)


@pytest.mark.parametrize("name", list(C.MODELS))
def test_every_model_trains_on_two_ranks(runs, name):
    """Each model ``cli.train`` trains (GenRe in stage 3 and joint), one
    train and one eval step from its seeded start on the ranks' slices of
    a synthetic batch (WGAN-GP drawing its own noise for the global
    batch): the train loss terms within 2e-3 of one process's (float32;
    the backprojections unpinned, the critic's kinks), the eval terms
    equal on both ranks and finite, both ranks' states bit for bit."""
    ref = runs["ref"]["models"][name]
    a, b = (res["models"][name] for res in runs["ranks"])
    assert a["digest"] == b["digest"]
    assert a["eval"] == b["eval"] and sorted(a["eval"]) == sorted(
        ref["eval"])
    assert all(np.isfinite(v) for v in a["eval"].values())
    for got in (a, b):
        assert sorted(got["train"]) == sorted(ref["train"])
        for k, v in ref["train"].items():
            np.testing.assert_allclose(got["train"][k], v, rtol=2e-3,
                                       err_msg=k)


def test_ranks_hold_bit_identical_states(runs):
    """After each case (MarrNet-1 after 3 steps) both ranks hold the same
    parameters and buffers, bit for bit; MarrNet-1's three losses are the
    one-process run's (float64, rtol 1e-6: Adam's state carries the
    global gradients from step to step)."""
    a, b = runs["ranks"]
    np.testing.assert_allclose(a["marrnet1"]["losses"],
                               runs["ref"]["marrnet1"]["losses"], rtol=1e-6)
    for case in ("marrnet1", "marrnet1_b3", "genre_joint", "wgangp"):
        assert a[case]["digest"] == b[case]["digest"], case


# ---------------------------------------------------------------- cli.train
def _cli_args(logdir, expr):
    return ["--net", "marrnet1", "--pred_depth_minmax", "--dataset",
            "synthetic", "--batch_size", "4", "--epoch", "1",
            "--epoch_batches", "2", "--eval_batches", "1",
            "--synthetic_length", "8", "--workers", "2", "--logdir",
            logdir, "--device", "cpu", "--log_batch", "--manual_seed", "1",
            "--save_net", "0", "--im_size", "64", "--vis_batches_vali", "1",
            "--expr_id", expr]


def _csv(path):
    import csv
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_train_multihost_on_two_cpu_ranks(tmp_path):
    """``cli.train --multihost`` under ``torch.distributed.run
    --nproc_per_node 2 --device cpu``, 2 steps, beside the same command in
    one process: rank 0 alone writes (one row a step, one a phase), both
    ranks print one parameter hash, the batch losses are the one-process
    run's (step 1 rtol 1e-5; step 2 1e-3, after Adam's first step, a sign
    for the gradients that rounding alone sets), rank 0 profiles step 2,
    and a one-process run resumes the checkpoint."""
    logdir = str(tmp_path / "logs")
    try:
        _cli_multihost(logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def _cli_multihost(logdir):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    dp = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "genre_shapehd_tpu_torch.cli.train",
         "--multihost", "--profile_step", "2"] + _cli_args(logdir, "1"),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    one = subprocess.run(
        [sys.executable, "-m", "genre_shapehd_tpu_torch.cli.train"]
        + _cli_args(logdir, "0"), cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    out, _ = dp.communicate(timeout=300)
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    assert dp.returncode == 0, out[-5000:]
    # the ranks share one stdout: a line may start behind a progress bar
    hashes = re.findall(r"\[dp\] rank \d of 2: parameters and buffers "
                        r"sha1 ([0-9a-f]+); kernel launches \{", out)
    assert len(hashes) == 2 and hashes[0] == hashes[1], hashes
    run = os.path.join(logdir, "marrnet1_synthetic_0.0001")
    got = _csv(os.path.join(run, "1", "batch_loss.csv"))
    ref = _csv(os.path.join(run, "0", "batch_loss.csv"))
    assert len(got) == len(ref) == 2
    assert len(_csv(os.path.join(run, "1", "epoch_loss.csv"))) == 2
    for step, (g, r) in enumerate(zip(got, ref)):
        assert g["size"] == r["size"] == "4.0"
        for k in ("loss", "normal", "depth", "silhou", "depth_minmax"):
            np.testing.assert_allclose(float(g[k]), float(r[k]),
                                       rtol=1e-5 if step == 0 else 1e-3,
                                       err_msg=f"step {step} {k}")
    import json
    with open(os.path.join(run, "1", "profile_step.json")) as f:
        prof = json.load(f)
    assert prof["step"] == 2 and prof["world"] == 2 and prof["backend"] \
        == "gloo" and prof["all_reduce_grads"]["calls"] == 1, prof
    assert os.path.isfile(os.path.join(run, "1", "epoch0001_vali",
                                       "batch0000.npz"))
    from genre_shapehd_tpu_torch.cli import train
    assert train.main(_cli_args(logdir, "1") + [
        "--epoch", "2", "--resume", "-1", "--vis_batches_vali", "0"]) == 0
    rows = _csv(os.path.join(run, "1", "epoch_loss.csv"))
    assert [(r["epoch"], r["phase"]) for r in rows] == [
        ("1", "train"), ("1", "eval"), ("2", "train"), ("2", "eval")]


# ------------------------------------------------------- one process, faults
def test_one_process_calls_no_collective(monkeypatch):
    """Without --multihost no collective runs: with every collective
    patched to raise, a train and an eval step and the trainer's start
    run as before."""
    import torch.distributed as dist
    from genre_shapehd_tpu_torch.train.loop import Trainer

    def refuse(*a, **k):
        raise AssertionError("a collective was called")
    for name in ("all_reduce", "broadcast", "init_process_group",
                 "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    assert not mesh.joined() and mesh.world() == 1 and mesh.rank() == 0
    model = C.make_model("marrnet1")
    model.net.float()
    Trainer(model, model.opt).initialize(0)
    batch = C.marrnet1_batch(2)
    metrics = model.train_step(batch)
    assert np.isfinite(float(metrics["loss"]))
    loss, _ = model.eval_step(batch)
    assert np.isfinite(float(loss["loss"]))


def test_launch_faults_raise(tmp_path, monkeypatch):
    """--multihost with --device cuda and no card raises; so do ranks
    launched without --multihost, --dist_backend without it, and NCCL on
    the CPU.  ``--device`` takes cpu, cuda and cuda:N."""
    from genre_shapehd_tpu_torch.cli import train
    args = _cli_args(str(tmp_path / "logs"), "0")
    if not torch.cuda.is_available():
        cuda = [a if a != "cpu" else "cuda" for a in args]
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(cuda + ["--multihost"])
    with pytest.raises(ValueError, match="multihost"):
        train.main(args + ["--dist_backend", "gloo"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="--multihost"):
        train.main(args)
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29999").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="nccl"):
        train.main(args + ["--multihost", "--dist_backend", "nccl"])
    assert not mesh.joined()
    assert not os.path.exists(tmp_path / "logs")
    assert [device_name(n) for n in ("cpu", "cuda", "cuda:1")] == \
        ["cpu", "cuda", "cuda:1"]
    for bad in ("mps", "cpu:1"):
        with pytest.raises((ValueError, RuntimeError)):
            device_name(bad)
    assert resolve_device("cpu", local_rank=1) == torch.device("cpu")
