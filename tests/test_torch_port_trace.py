"""The port's profiler spans (``genre_shapehd_tpu_torch/utils/trace.py``)
on the CPU, at small sizes: each stage's backward span on a profiled
GenRe joint step holds its own stage's autograd nodes and no other's;
a profiled step updates the weights bit for bit as an unprofiled one
(GenRe joint, ShapeHD's fine-tuning with its critic term); without a
profiler a stage adds no node to the graph; each ``predict_step`` opens
its upload span; ``--profile_step`` lists the stages; and the
benchmark's per-layer metrics that read the new spans
(``bench_port/metrics/``) read them from a hand-made summary."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint
from genre_shapehd_tpu_torch.core.convert import torch_to_jax
from genre_shapehd_tpu_torch.core.registry import get_dataset, get_model
from genre_shapehd_tpu_torch.data.loader import collate
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.train.loop import profile_step
from genre_shapehd_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "bench_port"))
import harness  # noqa: E402

torch.set_num_threads(4)
TINY = dict(im_size=64, vox_res=32, sph_res=32, z_res=32, padding_margin=16)
GENRE_STAGES = (trace.NET1, trace.CAMERA_BP, trace.RENDER, trace.NET2,
                trace.SPHERICAL_BP, trace.REFINE, trace.REFINE_ENCODER,
                trace.REFINE_DECODER)
EVALUATE = "autograd::engine::evaluate_function"


def _genre(joint=True):
    model = get_model("genre_full_model")(default_opt(
        device="cpu", **TINY, joint_train=joint, surface_weight=10.0,
        lr=1e-4, no_aug=True, batch_size=2))
    model.init_state(0)
    return model


def _genre_batch(model):
    ds = get_dataset("synthetic")(default_opt(device="cpu", **TINY,
                                              no_aug=True), "train",
                                  model=model)
    batch = collate([ds[i] for i in range(2)])
    return {k: torch.as_tensor(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _shapehd():
    model = get_model("shapehd")(default_opt(
        device="cpu", im_size=64, vox_res=32, canon_sup=True,
        w_gan_loss=0.5, lr=1e-4, no_aug=True, batch_size=2))
    model.init_state(0)
    return model


def _shapehd_batch():
    g = torch.Generator().manual_seed(5)
    silhou = (torch.rand(2, 64, 64, 1, generator=g) > 0.3) * 100.0
    return {"depth": torch.randn(2, 64, 64, 1, generator=g) * 30 + 50,
            "normal": torch.randn(2, 64, 64, 3, generator=g) * 30,
            "silhou": silhou,
            "voxel_canon": (torch.rand(2, 32, 32, 32, generator=g)
                            > 0.8).float()}


def _cpu_events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _ranges(events, name):
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.name == name]


def _inside(e, ranges):
    return any(a <= e.time_range.start and e.time_range.end <= b
               for a, b in ranges)


def _state(model):
    """Every parameter, gradient and Adam moment of the model, and its
    BatchNorm statistics."""
    out = {f"sd.{k}": v.clone() for k, v in model.net.state_dict().items()}
    for i, p in enumerate(model.optimizer.param_groups[0]["params"]):
        out[f"grad.{i}"] = p.grad.clone()
        for k, v in model.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v.clone()
    return out


def _steps(make, data):
    """Two models from one start, one batch; one step each, the second
    under the profiler: the states after the steps, the events, and the
    first model and the batch for more."""
    plain, traced = make(), make()
    batch = data(plain)
    plain.train_step(batch)
    events = _cpu_events(lambda: traced.train_step(batch))
    return dict(plain=_state(plain), traced=_state(traced), events=events,
                model=plain, batch=batch)


@pytest.fixture(scope="module")
def genre_steps():
    return _steps(_genre, _genre_batch)


def test_genre_backward_spans_hold_their_own_stages_nodes(genre_steps):
    """Each GenRe stage's ``.backward`` span is on the trace of a profiled
    joint step; every autograd node evaluated inside it (parameters'
    accumulations aside, which no forward op makes) was made by an op
    inside the stage's own span, by sequence number, or inside the
    backward span itself (the renderer's backward differentiates its
    recomputed depth); the U-Net's decoder finishes its backward before
    its encoder starts."""
    events = genre_steps["events"]
    for stage in GENRE_STAGES:
        fwd = _ranges(events, stage)
        bwd = _ranges(events, stage + trace.BACKWARD_SUFFIX)
        assert len(fwd) == 1 and len(bwd) == 1, (stage, fwd, bwd)
        made = {e.sequence_nr for e in events
                if e.sequence_nr >= 0 and not e.name.startswith(EVALUATE)
                and _inside(e, fwd + bwd)}
        nodes = [e for e in events if e.name.startswith(EVALUATE)
                 and not e.name.endswith("AccumulateGrad")
                 and _inside(e, bwd)]
        assert nodes, stage
        strays = [e.name for e in nodes if e.sequence_nr not in made]
        assert not strays, (stage, strays)
    (_, dec_end), = _ranges(events, trace.REFINE_DECODER + ".backward")
    (enc_start, _), = _ranges(events, trace.REFINE_ENCODER + ".backward")
    assert dec_end <= enc_start
    for phase in (trace.TRAIN_STEP, trace.ZERO_GRAD, trace.LOSS,
                  trace.BACKWARD, trace.OPTIMIZER):
        assert len(_ranges(events, phase)) == 1, phase


@pytest.mark.parametrize("net", ["genre_joint", "shapehd"])
def test_a_profiled_step_updates_bit_for_bit(net, genre_steps):
    """The same step, with and without a profiler recording: gradients,
    Adam's moments and the weights after the update are equal bit for
    bit."""
    run = genre_steps if net == "genre_joint" else _steps(
        _shapehd, lambda m: _shapehd_batch())
    assert any(e.name.endswith(trace.BACKWARD_SUFFIX) for e in run["events"])
    a, b = run["plain"], run["traced"]
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _node_names(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_without_a_profiler_a_stage_adds_no_node(genre_steps):
    """Unprofiled, ``stage`` hands back ``fn``'s own result and GenRe's
    loss has no boundary node in its graph; profiled with grad on, the
    boundaries are there; under ``no_grad`` a profiled stage adds none."""
    x = torch.randn(3, requires_grad=True)
    y = x * 2
    assert trace.stage("t.x", lambda v: y, x) is y
    model, batch = genre_steps["model"], genre_steps["batch"]

    def loss():
        model.net.train()
        return model.compute_loss(model.forward_batch(batch), batch)[0]

    names = _node_names(loss())
    assert names and not [n for n in names if n.startswith(
        ("_Enter", "_Leave"))]
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _node_names(loss())
        with torch.no_grad():
            assert trace.stage("t.x", lambda v: v * 2, x).grad_fn is None
    assert len([n for n in traced if n.startswith("_Enter")]) \
        == len(GENRE_STAGES)
    assert len(traced) > len(names)


def test_in_a_process_group_a_profiled_stage_adds_no_node(tmp_path):
    """In a joined process group (``--multihost``, where rank 0 alone
    profiles) a profiled stage keeps the graph its ops build, so that
    every rank's backward runs its collectives in the same order."""
    import torch.distributed as dist
    x = torch.randn(3, requires_grad=True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            inside = trace.stage("t.x", lambda v: v * 2, x)
    finally:
        dist.destroy_process_group()
    with profile(activities=[ProfilerActivity.CPU]):
        outside = trace.stage("t.x", lambda v: v * 2, x)
    assert _node_names(inside) == ["MulBackward0", "AccumulateGrad"]
    assert _node_names(outside)[0].startswith("_Enter")


def _write(path, modules, names):
    payload = []
    for m in modules:
        params, stats = torch_to_jax(m.state_dict())
        payload.append({"params": params, "batch_stats": stats})
    save_checkpoint(path, {"nets": payload, "optimizers": [], "epoch": 0,
                           "loss_eval": 0.0, "net_names": list(names),
                           "opt_names": []})


def _shapehd_test(tmp_path):
    from genre_shapehd_tpu_torch.cli import options
    from genre_shapehd_tpu_torch.models.marrnet import marrnet1_net
    train = _shapehd()
    files = (str(tmp_path / "shapehd.pt"), str(tmp_path / "marrnet1.pt"))
    _write(files[0], train.net_modules().values(), train.net_names)
    _write(files[1], [marrnet1_net(64)], ["net"])
    return get_model("shapehd", test=True)(options.parse_test([
        "--net", "shapehd", "--input_rgb", "none", "--output_dir",
        str(tmp_path), "--vis_workers", "0", "--im_size", "64",
        "--vox_res", "32", "--batch_size", "2", "--device", "cpu",
        "--net_file", files[0], "--marrnet1_file", files[1]]))


@pytest.mark.parametrize("net,span", [
    ("genre_full_model", trace.GENRE_UPLOAD),
    ("marrnet", trace.MARRNET_UPLOAD),
    ("shapehd", trace.SHAPEHD_UPLOAD)])
def test_predict_step_opens_its_upload_span(net, span, tmp_path):
    """Each inference path converts its host batch under its upload span,
    before any stage of its forward."""
    if net == "shapehd":
        model = _shapehd_test(tmp_path)
    else:
        model = get_model(net)(default_opt(device="cpu", **TINY))
        model.init_state(0)
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "silhou": (rng.random((2, 64, 64, 1)) > 0.5).astype(
                 np.float32) * 100.0}
    events = _cpu_events(lambda: model.predict_step(batch))
    (start, _), = _ranges(events, span)
    stages = [e.time_range.start for e in events if e.name in trace.STAGES]
    assert stages and start < min(stages)


def test_profile_step_lists_each_stage_and_its_backward(genre_steps):
    """``--profile_step``'s report has each GenRe stage and its backward
    span, once each on a joint step, with their CPU time; no card here,
    so no device time; the sp spans are left as they were."""
    _, report = profile_step(genre_steps["model"], genre_steps["batch"])
    want = {n for s in GENRE_STAGES for n in (s, s + trace.BACKWARD_SUFFIX)}
    assert set(report["stages"]) == want
    for name, row in report["stages"].items():
        assert row["calls"] == 1 and row["cpu_ms"] > 0, name
        assert row["device_ms"] == 0, name
    assert report["spans"] == {}


#: each new per-layer metric and the spans it sums
READS = {
    "upload_ms.infer": (trace.GENRE_UPLOAD, trace.MARRNET_UPLOAD,
                        trace.SHAPEHD_UPLOAD),
    "unet3d_decoder_ms.infer": (trace.REFINE_DECODER,),
    "voxel3d_ms.train": (trace.REFINE, trace.REFINE + ".backward"),
    "unet3d_decoder_ms.train": (trace.REFINE_DECODER,
                                trace.REFINE_DECODER + ".backward"),
    "uresnet_ms.train": (trace.NET1, trace.NET2, trace.NET1 + ".backward",
                         trace.NET2 + ".backward"),
    "backproject_ms.train": (trace.CAMERA_BP, trace.SPHERICAL_BP,
                             trace.CAMERA_BP + ".backward",
                             trace.SPHERICAL_BP + ".backward"),
    "render_ms.train": (trace.RENDER, trace.RENDER + ".backward"),
    "optimizer_ms.train": (trace.OPTIMIZER, trace.ZERO_GRAD),
}


@pytest.mark.parametrize("metric", sorted(READS))
def test_new_metrics_read_their_spans(metric):
    """Each metric's file, as the harness loads it, reads the device ms
    per iteration of its spans (and of no other) from a summary, and
    None where none of them ran; ``BENCHMARK.json`` lists it in ms."""
    reader = harness.metric_reader(metric)
    spans = READS[metric]
    times = {name: 0.001 * (i + 1) for i, name in enumerate(spans)}
    other = {trace.LOSS: 5.0, trace.BACKWARD: 7.0, "genre.other": 3.0}
    got = reader.read({"iters": 4, "span_kernel_s": {**times, **other}})
    assert got == pytest.approx(1e3 * sum(times.values()) / 4)
    assert reader.read({"iters": 4, "span_kernel_s": other}) is None
    entry, = [m for m in harness.benchmark()["per_layer"]
              if m["name"] == metric]
    assert (entry["unit"], entry["better"], entry["source"]) == (
        "ms", "lower", "device_trace")
