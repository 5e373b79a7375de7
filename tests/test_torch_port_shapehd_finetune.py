"""PyTorch port, ShapeHD's fine-tuning step on the CPU at a small size:
``shapehd.Model.train_step`` against the benchmark's plain reference of
the step (``bench_port/reference/shapehd_finetune.py``); the critic
stem's backward, K6's on the card (mask, K3's transposed convolution,
upcast), in its formulation against autograd of the plain layer, and
through its ``autograd.Function`` with both kernels stood in by their
formulations; the stem's backward span; the benchmark's readers of the
fine-tuning cell; and a profiled WGAN-GP step (the critic's double
backward through the stem's span) against an unprofiled one.

The kernels themselves run on the card only
(``tests/test_torch_port_critic_stem_cuda.py``)."""

import contextlib
import os
import statistics
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genre_shapehd_tpu_torch.core.registry import get_model
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.ops.cuda import critic_stem_kernel as ck
from genre_shapehd_tpu_torch.ops.cuda import subpixel_kernel as sk
from genre_shapehd_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "bench_port"))
import drive  # noqa: E402
import harness  # noqa: E402
import inputs  # noqa: E402
import weights  # noqa: E402
from reference import precision  # noqa: E402
from reference import shapehd_finetune as ref_step  # noqa: E402

torch.set_num_threads(4)
CPU = torch.device("cpu")
RES, SIZE, BATCH, W_GAN, LR = 32, 64, 2, 0.5, 1e-4
STEM_BWD = trace.CRITIC_STEM + trace.BACKWARD_SUFFIX


def _shapehd(dtype="float32"):
    model = get_model("shapehd")(default_opt(
        device="cpu", im_size=SIZE, vox_res=RES, canon_sup=True,
        w_gan_loss=W_GAN, lr=LR, no_aug=True, batch_size=BATCH,
        dtype=dtype))
    model.init_state(0)
    return model


def _seeded(model, seed):
    """The benchmark's seeded weights in MarrNet-2 and the critic."""
    w = weights.seeded(model.net, seed, CPU)
    w_d = weights.seeded(model.net_d, seed, CPU, offset=1)
    model.net.load_state_dict(w)
    model.net_d.load_state_dict(w_d)
    return w, w_d


def _batches(n, seed):
    out = []
    for i in range(n):
        d = inputs.genre_batch(BATCH, SIZE, RES, 1, 1, weights.generator(
            seed + i, "inputs", CPU), CPU)
        out.append({"depth": d["depth"], "normal": d["normal"],
                    "silhou": d["silhou"], "voxel_canon": d["voxel"]})
    return out


def test_train_step_matches_the_reference():
    """Three steps of the port's ``train_step`` (float32, the port's own
    precision: its critic and loss read the logits as float32, so a
    float64 run would not pass through them) on seeded weights against
    the reference's three steps from the same weights and batches: each
    step's loss terms within 1e-5 (the ``gan`` term of its size before
    the scores cancel), each leaf's first gradient within 1e-5 of the
    median leaf's, each moving leaf's change over the three steps within
    1 % of the median leaf's (two Adams, their rounding of the updates of
    tiny gradients apart); the critic and the frozen copy stay as they
    were."""
    model = _shapehd()
    w, w_d = _seeded(model, 11)
    noft = {k: v.clone() for k, v in model.net_noft.state_dict().items()}
    batches = _batches(3, 11)
    named = list(model.net.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    losses = []
    for k, b in enumerate(batches):
        losses.append({n: float(v) for n, v in model.train_step(b).items()})
        if k == 0:
            grads = drive.first_gradients(model.optimizer, named, 0.5)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    ref = ref_step.shapehd_steps(w, w_d, batches, dict(
        params=[n for n, _ in named], lr=LR, betas=(0.5, 0.9),
        w_gan_loss=W_GAN, vox_res=RES), precision.exact)
    rl, rg, rc, scales = ref
    assert sorted(losses[0]) == ["gan", "loss", "sup"]
    for got, want, scale in zip(losses, rl, scales):
        for k in want:
            den = max(abs(want[k]), scale if k == "gan" else 0.0)
            assert abs(got[k] - want[k]) <= 1e-5 * den, (k, got, want)
    assert max(drive.leaf_gaps(grads, rg, rg)) <= 1e-5
    assert max(drive.leaf_gaps(change, rc, drive.moving(rg))) <= 1e-2
    assert all(torch.equal(v, w_d[k])
               for k, v in model.net_d.state_dict().items())
    assert all(torch.equal(v, noft[k])
               for k, v in model.net_noft.state_dict().items())


def test_critic_grad_matches_the_reference():
    """The gradient of the critic's term with respect to the logits,
    through the port's critic (``Model.critic``, as the benchmark's check
    takes it) and through the reference's, in float32: within 1e-5
    relative L2."""
    model = _shapehd()
    _, w_d = _seeded(model, 12)
    logits = torch.randn(BATCH, RES, RES, RES,
                         generator=torch.Generator().manual_seed(2)) * 3
    x = logits.clone().requires_grad_(True)
    gan = -model.critic(x).float().mean() * W_GAN
    (got,) = torch.autograd.grad(gan, x)
    want = ref_step.critic_grad(w_d, logits, precision.exact, RES, W_GAN)
    assert float((got - want).norm() / want.norm()) <= 1e-5


@pytest.mark.parametrize("r", [32, 64])
def test_stem_backward_formulation_matches_autograd(r):
    """``input_grad`` (the output's gradient masked by the sign of the
    output, then ``deconv_final_plain``, K3's function, on the stem's
    weight with a zero bias, then float32) against autograd of
    ``critic_stem_plain`` with respect to v, in float64: within 1e-12 of
    the gradient's scale; the weight (64, 1, 4, 4, 4) is K3's layout."""
    g = torch.Generator().manual_seed(r)
    v = torch.rand(2, 1, r, r, r, dtype=torch.float64, generator=g)
    w = torch.randn(64, 1, 4, 4, 4, dtype=torch.float64, generator=g) * 0.2
    v.requires_grad_(True)
    y = ck.critic_stem_plain(v, w)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    (want,) = torch.autograd.grad(y, v, gy)
    got = ck.input_grad(gy, y.detach(), w)
    assert got.dtype == torch.float32 and got.shape == v.shape
    assert bool((y < 0).any()) and bool((y > 0).any())
    err = float((got.double() - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max())


@contextlib.contextmanager
def _stand_ins(monkeypatch):
    """K6 and K3 stood in on the CPU by their formulations (K6's rounded
    to bf16 as it writes it), and the critic routed to K6."""
    calls = []

    def k6(v, w):
        calls.append("critic_stem")
        return ck.critic_stem_gemm(v, w).to(torch.bfloat16)

    def k3(x, w, b):
        calls.append("deconv_final")
        return sk.deconv_final_gemm(x, w.to(x.dtype), b)

    monkeypatch.setattr(ck, "_launch", k6)
    monkeypatch.setattr(sk, "_launch", k3)
    monkeypatch.setattr(ck, "uses_kernel", lambda v, w: True)
    monkeypatch.setattr(ck, "takes", lambda v, w: True)
    yield calls


def test_autograd_function_gives_v_its_gradient(monkeypatch):
    """K6's ``autograd.Function`` with the kernels stood in: v's gradient
    within two bf16 roundings of the plain layer's (the output's, and K3's
    rounding of its sum), the weight none, a backward launch counted."""
    g = torch.Generator().manual_seed(4)
    v = torch.rand(2, 1, 32, 32, 32, generator=g, requires_grad=True)
    w = torch.randn(64, 1, 4, 4, 4, generator=g) * 0.2
    ck.reset_launches()
    with _stand_ins(monkeypatch) as calls:
        y = ck.critic_stem(v, w)
        gy = torch.randn(y.shape, generator=g).to(torch.bfloat16)
        (got,) = torch.autograd.grad(y, v, gy)
    assert calls == ["critic_stem", "deconv_final"]
    assert ck.launches["critic_stem_backward"] == 1
    vv = v.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(ck.critic_stem_plain(vv, w), vv,
                                  gy.float())
    assert got.dtype == torch.float32
    err = float((got - want).norm() / want.norm())
    assert err <= 2 * 2.0 ** -8, err


def test_shapehd_step_routes_the_stem_to_k6_both_ways(monkeypatch):
    """A bf16 fine-tuning step with the stem routed to K6 (stood in):
    one forward and one backward of the stem on the critic's input, none
    of the plain layer; the step's loss terms and MarrNet-2's gradients
    within a few bf16 roundings of the plain step's (each leaf's against
    its own size or the median leaf's, whichever is larger: a bias before
    a train-mode BatchNorm has a gradient of round-off alone)."""
    batch = _batches(1, 13)[0]
    plain = _shapehd("bfloat16")
    _seeded(plain, 13)
    want = {k: float(v) for k, v in plain.train_step(batch).items()}
    want_g = {n: p.grad.clone() for n, p in plain.net.named_parameters()}
    model = _shapehd("bfloat16")
    _seeded(model, 13)
    seen = []
    monkeypatch.setattr(torch.nn.functional, "conv3d", _counting(
        torch.nn.functional.conv3d, seen))
    with _stand_ins(monkeypatch) as calls:
        got = {k: float(v) for k, v in model.train_step(batch).items()}
    assert calls == ["critic_stem", "deconv_final"]
    assert not [s for s in seen if s[1] == 1], seen
    assert abs(got["sup"] - want["sup"]) <= 1e-5 * abs(want["sup"])
    assert abs(got["gan"] - want["gan"]) <= 0.05 * abs(want["gan"]) + 1e-6
    med = statistics.median(float(g.norm()) for g in want_g.values())
    for n, p in model.net.named_parameters():
        scale = max(float(want_g[n].norm()), med)
        assert float((p.grad - want_g[n]).norm()) <= 0.05 * scale, n


def _counting(fn, seen):
    def conv3d(x, w, *args, **kw):
        seen.append(tuple(w.shape))
        return fn(x, w, *args, **kw)
    return conv3d


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def test_stem_backward_span_holds_the_stems_nodes():
    """A profiled fine-tuning step opens ``shapehd.critic.stem.backward``
    once, inside ``shapehd.critic.backward``, and every autograd node it
    holds (the convolution's, the activation's) was made by the stem's
    forward."""
    model = _shapehd()
    batch = _batches(1, 14)[0]
    _, events = _profiled(lambda: model.train_step(batch))
    span = [(e.time_range.start, e.time_range.end) for e in events
            if e.name == STEM_BWD]
    outer = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == trace.CRITIC + trace.BACKWARD_SUFFIX]
    fwd = [(e.time_range.start, e.time_range.end) for e in events
           if e.name == trace.CRITIC_STEM]
    assert len(span) == 1 and len(outer) == 1 and len(fwd) == 1
    (a, b), = span
    assert outer[0][0] <= a and b <= outer[0][1]

    def inside(e, r):
        return r[0] <= e.time_range.start and e.time_range.end <= r[1]

    made = {e.sequence_nr for e in events if e.sequence_nr >= 0
            and inside(e, fwd[0])}
    nodes = [e for e in events
             if e.name.startswith("autograd::engine::evaluate_function")
             and inside(e, span[0])]
    assert nodes and all(e.sequence_nr in made for e in nodes), \
        [e.name for e in nodes]


def _wgangp():
    model = get_model("wgangp")(default_opt(
        device="cpu", vox_res=RES, canon_voxel=True, lr=1e-4,
        batch_size=BATCH))
    model.init_state(0)
    return model


def _wgangp_state(model):
    out = {}
    for name, net in model.net_modules().items():
        out.update({f"{name}.{k}": v.clone()
                    for k, v in net.state_dict().items()})
        opt = model.optimizer_entries()[name][0]
        for i, p in enumerate(opt.param_groups[0]["params"]):
            out[f"{name}.grad.{i}"] = p.grad.clone()
    return out


def test_profiled_wgangp_step_matches_an_unprofiled_one():
    """The WGAN-GP step (D's gradient penalty differentiates through the
    critic's input gradient, the stem's span included) profiled and not,
    from one start on one batch and one set of draws: every metric,
    gradient and weight bit for bit; the profiled step opens the stem's
    backward span."""
    real = (torch.rand(BATCH, RES, RES, RES,
                       generator=torch.Generator().manual_seed(6)) > 0.7
            ).float()
    draws = _wgangp().draw(BATCH)
    plain, traced = _wgangp(), _wgangp()
    m1 = plain.train_step({"voxel_canon": real}, draws)
    m2, events = _profiled(lambda: traced.train_step(
        {"voxel_canon": real}, draws))
    assert any(e.name == STEM_BWD for e in events)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    a, b = _wgangp_state(plain), _wgangp_state(traced)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


#: each reader of the fine-tuning cell and the spans it sums
READS = {
    "marrnet2_ms.train": (trace.MARRNET2,
                          trace.MARRNET2 + trace.BACKWARD_SUFFIX),
    "critic_ms.train": (trace.CRITIC, trace.CRITIC + trace.BACKWARD_SUFFIX),
    "critic_stem_ms.train": (trace.CRITIC_STEM, STEM_BWD),
}


@pytest.mark.parametrize("metric", sorted(READS))
def test_fine_tuning_readers_read_their_spans(metric):
    """Each reader, as the harness loads it, reads the device ms per step
    of its spans and of no other, and None where none ran (the stem's
    also where its backward span is missing, as on a program without
    one); ``BENCHMARK.json`` lists it in ms for the fine-tuning cell."""
    reader = harness.metric_reader(metric)
    spans = READS[metric]
    times = {name: 0.001 * (i + 1) for i, name in enumerate(spans)}
    other = {trace.LOSS: 5.0, trace.BACKWARD: 7.0, "shapehd.other": 3.0}
    got = reader.read({"iters": 4, "span_kernel_s": {**times, **other}})
    assert got == pytest.approx(1e3 * sum(times.values()) / 4)
    assert reader.read({"iters": 4, "span_kernel_s": other}) is None
    fwd_only = {spans[0]: 0.002, **other}
    want_fwd = None if metric == "critic_stem_ms.train" else 0.5
    assert reader.read({"iters": 4, "span_kernel_s": fwd_only}) == (
        want_fwd if want_fwd is None else pytest.approx(want_fwd))
    entry, = [m for m in harness.benchmark()["per_layer"]
              if m["name"] == metric]
    assert (entry["unit"], entry["better"], entry["source"],
            entry["workloads"]) == ("ms", "lower", "device_trace",
                                    ["shapehd-finetune-b64"])


def test_stem_roofline_reader():
    """``critic_stem_roofline.train``: the stem's least time forward and
    backward at the step's shape (at batch 64 and 128³: 2.684 GB and
    4.832 GB, 2.2436 ms at 3.35 TB/s) over its two spans' device time;
    None without the shape or either span."""
    reader = harness.metric_reader("critic_stem_roofline.train")
    calls = [(64, 128, "bfloat16")]
    spans = {trace.CRITIC_STEM: 0.0025, STEM_BWD: 0.0035}
    got = reader.read({"iters": 2, "critic_stem_calls": calls,
                       "span_kernel_s": spans})
    assert got == pytest.approx(100 * 2 * 2.24365e-3 / 0.006, rel=1e-4)
    assert reader.read({"iters": 2, "span_kernel_s": spans}) is None
    assert reader.read({"iters": 2, "critic_stem_calls": calls,
                        "span_kernel_s": {trace.CRITIC_STEM: 1.0}}) is None
    entry, = [m for m in harness.benchmark()["per_layer"]
              if m["name"] == "critic_stem_roofline.train"]
    assert (entry["unit"], entry["better"], entry["moves"]) == (
        "%", "higher", "train_samples_per_s")
