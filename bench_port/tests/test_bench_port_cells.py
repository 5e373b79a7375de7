"""Every cell run through the harness on the CPU at a small size, all of
a run but the look for a chip: a sound run comes out correct; the
control (the reference in fp8 in the program's place) and each fault
the cell can have, planted under the timed path, come out not correct
by the cell's own limits."""

from types import SimpleNamespace

import pytest
import torch
from conftest import cells, tiny

import control
import harness
import run

CPU = torch.device("cpu")
SEED = 3000000003


def _run(cell):
    wl, cfg = tiny(cell)
    args = SimpleNamespace(workload=cell, seed=SEED, seconds=0.0, trace=0)
    return run.run_cell(args, harness.benchmark(), CPU, wl=wl, cfg=cfg)


@pytest.mark.parametrize("cell", cells())
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, "end_to_end")}
    assert set(result["metrics"]) == names


@pytest.mark.parametrize("cell", cells())
def test_the_control_is_not_correct(cell):
    wl, cfg = tiny(cell)
    out = control.readings(cell, SEED, 0.0, CPU, wl=wl, cfg=cfg)
    ok, _ = harness.judge(out["program"], wl["limits"])
    bad, checks = harness.judge(out["control"], wl["limits"])
    assert ok and not bad, checks


# ---------------------------------------------------------------- faults
def _infer_class(cell):
    from genre_shapehd_tpu_torch.models import genre_full, shapehd
    return genre_full.Model if cell.startswith("genre") else \
        shapehd.ModelTest


def _train_class(cell):
    from genre_shapehd_tpu_torch.models import base
    return base.ModelBase


def _half_infer(orig):
    def predict_step(self, batch):
        n = len(next(iter(batch.values()))) // 2
        pred = orig(self, {k: v[:n] for k, v in batch.items()})
        return {k: torch.cat([v, v]) if v.dim() and v.shape[0] == n else v
                for k, v in pred.items()}
    return predict_step


def _altered_infer(orig):
    def predict_step(self, batch):
        pred = dict(orig(self, batch))
        for key in ("pred_voxel", "voxel"):
            if key in pred:
                pred[key] = pred[key].clone()
                pred[key][0] = -pred[key][0]
        return pred
    return predict_step


def _half_train(orig):
    def train_step(self, batch):
        n = len(next(iter(batch.values()))) // 2
        return orig(self, {k: v[:n] for k, v in batch.items()})
    return train_step


INFER_FAULTS = {"half_batch": _half_infer, "answer_altered": _altered_infer}
TRAIN_FAULTS = {"half_batch": _half_train}


def _kind(cell):
    return harness.driver(harness.workload(cell)["driver"]).KIND


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in cells()
    for f in (INFER_FAULTS if _kind(c) == "infer" else
              list(TRAIN_FAULTS) + ["state_unchanged"])])
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    if _kind(cell) == "infer":
        cls = _infer_class(cell)
        monkeypatch.setattr(cls, "predict_step",
                            INFER_FAULTS[fault](cls.predict_step))
    elif fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        cls = _train_class(cell)
        monkeypatch.setattr(cls, "train_step",
                            TRAIN_FAULTS[fault](cls.train_step))
    result = _run(cell)
    assert not result["correct"], result["checks"]
