"""The fine-tuning cell, ``shapehd-finetune-b64``, on the CPU: its files
found by name, its plain reference against the port's step at a small
size, the stem's cost pinned at the cell's shape, and a fault in the
critic's backward that only the ``critic_grad`` check sees.

The directory's cell-wide tests (``test_bench_port_cells.py``) size each
cell by its configuration in ``conftest.TINY``; this module gives the
configuration ``shapehd-finetune`` its CPU size there, so that they run
the cell too whenever the directory is collected whole."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from conftest import TINY, tiny

import drive
import harness
import inputs
import run
import weights
from cost import critic_stem
from reference import precision
from reference import shapehd_finetune as ref_step

TINY.setdefault("shapehd-finetune", dict(im_size=64, vox_res=32))
CELL = "shapehd-finetune-b64"
CPU = torch.device("cpu")
SEED = 3000000007


def test_the_cell_is_found_and_reports_its_metrics():
    b = harness.benchmark()
    entry = harness.cell_entry(b, CELL)
    assert (entry["config"], entry["chips"]) == ("shapehd-finetune", 1)
    wl = harness.workload(CELL)
    drv = harness.driver(wl["driver"])
    assert (drv.KIND, drv.RATE) == ("train", "train_samples_per_s")
    assert sorted(wl["limits"]) == ["change_gap", "critic_grad", "grad_gap",
                                    "loss_gap"]
    e2e = {m["name"] for m in harness.cell_metrics(b, CELL, "end_to_end")}
    assert e2e == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    per_layer = {m["name"] for m in harness.cell_metrics(b, CELL,
                                                          "per_layer")}
    assert per_layer == {
        "device_idle.train", "mfu.train", "backward_ms.train",
        "optimizer_ms.train", "deconv_final_roofline.train",
        "marrnet2_ms.train", "critic_ms.train", "critic_stem_ms.train",
        "critic_stem_roofline.train"}
    cfg = harness.config("shapehd-finetune")
    assert cfg["reduced"] == [] and (
        cfg["im_size"], cfg["vox_res"], cfg["encode_dims"],
        cfg["decoder_nf"], cfg["critic_nf"], cfg["w_gan_loss"],
        cfg["lr"]) == (256, 128, 200, 512, 64, 0.001, 1e-4)


def test_stem_cost_at_the_cells_shape():
    """At batch 64 and 128³: forward v 537 MB in and y 2.15 GB out,
    backward g and y in and v's gradient out, 2.2436 ms at 3.35 TB/s."""
    (fb, fo), (bb, bo) = critic_stem.cost(64, 128)
    v, y, w = 64 * 128 ** 3 * 4, 64 * 64 * 64 ** 3 * 2, 64 * 64 * 4
    assert (fb, bb) == (v + w + y, 2 * y + w + v)
    assert fo == bo == 128 * 64 * 64 * 64 ** 3
    assert critic_stem.bound_s(64, 128) == pytest.approx(2.24365e-3,
                                                         rel=1e-4)


def test_reference_step_agrees_with_the_port():
    """Three steps at 64² and 32³, batch 2, float32, on the benchmark's
    weights and inputs: the reference's loss terms, first gradients and
    changes against the port's ``train_step``, and its critic gradient
    against the port's critic."""
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.base import default_opt
    model = get_model("shapehd")(default_opt(
        device="cpu", im_size=64, vox_res=32, canon_sup=True,
        w_gan_loss=1e-3, lr=1e-4, no_aug=True, batch_size=2))
    model.init_state(0)
    w = weights.seeded(model.net, SEED, CPU)
    w_d = weights.seeded(model.net_d, SEED, CPU, offset=1)
    model.net.load_state_dict(w)
    model.net_d.load_state_dict(w_d)
    data = inputs.genre_batch(6, 64, 32, 1, 1, weights.generator(
        SEED, "inputs", CPU), CPU)
    batches = [{"depth": data["depth"][i:i + 2],
                "normal": data["normal"][i:i + 2],
                "silhou": data["silhou"][i:i + 2],
                "voxel_canon": data["voxel"][i:i + 2]} for i in (0, 2, 4)]
    named = list(model.net.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    losses = []
    for k, b in enumerate(batches):
        losses.append({n: float(v) for n, v in model.train_step(b).items()})
        if k == 0:
            grads = drive.first_gradients(model.optimizer, named, 0.5)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    ref = ref_step.shapehd_steps(w, w_d, batches, dict(
        params=[n for n, _ in named], lr=1e-4, betas=(0.5, 0.9),
        w_gan_loss=1e-3, vox_res=32), precision.exact)
    drv = harness.driver("shapehd_finetune")
    logits = torch.randn(2, 32, 32, 32,
                         generator=torch.Generator().manual_seed(1))
    x = logits.clone().requires_grad_(True)
    (got_g,) = torch.autograd.grad(
        -model.critic(x).float().mean() * 1e-3, x)
    nums = drv._numbers((losses, grads, change), ref, got_g,
                        ref_step.critic_grad(w_d, logits, precision.exact,
                                             32, 1e-3))
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-5, nums
    assert nums["change_gap"] < 1e-2 and nums["critic_grad"] < 1e-5, nums


class _NoSlope(torch.autograd.Function):
    """LeakyReLU(0.2) forward, a backward that drops the slope: the
    fault a wrong mask in the stem's backward would make."""

    @staticmethod
    def forward(ctx, x):
        return F.leaky_relu(x, 0.2)

    @staticmethod
    def backward(ctx, g):
        return g


def test_a_wrong_stem_backward_fails_critic_grad(monkeypatch):
    """With the stem's backward missing the activation's slope, the run
    is not correct, by ``critic_grad``."""
    from genre_shapehd_tpu_torch.nn import VoxelDiscriminator

    def stem(x, weight):
        return _NoSlope.apply(F.conv3d(x, weight, None, 2, 1))

    monkeypatch.setattr(VoxelDiscriminator, "stem", staticmethod(stem))
    wl, cfg = tiny(CELL)
    args = SimpleNamespace(workload=CELL, seed=SEED, seconds=0.0, trace=0)
    result = run.run_cell(args, harness.benchmark(), CPU, wl=wl, cfg=cfg)
    checks = result["checks"]
    assert not result["correct"], checks
    assert checks["critic_grad"]["value"] > checks["critic_grad"]["limit"]
