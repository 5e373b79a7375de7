"""The benchmark's CPU tests: ``python -m pytest bench_port/tests`` from
the repository's root.  The cells run at a size the CPU holds (64²
photos, 32³ voxels, batches of 2), the port on its plain paths, in
float32: the CPU's bfloat16 autocast runs other kernels than the card's,
with other rounding, so the cells' limits, read on the card in bfloat16,
say nothing of it."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402

#: the sizes of the CPU runs, per configuration
TINY = {"genre": dict(im_size=64, vox_res=32, sph_res=32, z_res=32,
                      padding_margin=16),
        "shapehd": dict(im_size=64, vox_res=32)}
#: the traffic of the CPU runs (training at 4, so that half a batch still
#: gives BatchNorm more than one row)
TINY_WL = dict(batch=2, pool=3, sample_from=3, sample_batches=2, ref_rows=2,
               trace_iters=2)
TINY_TRAIN = dict(TINY_WL, batch=4)


def tiny(cell: str):
    """(workload, configuration) of ``cell`` at the CPU's size."""
    bench = harness.benchmark()
    entry = harness.cell_entry(bench, cell)
    cfg = dict(harness.config(entry["config"]), dtype="float32",
               **TINY[entry["config"]])
    wl = harness.workload(cell)
    train = harness.driver(wl["driver"]).KIND == "train"
    wl = dict(wl, **(TINY_TRAIN if train else TINY_WL))
    return wl, cfg


def cells():
    return [c["name"] for c in harness.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    import torch
    was = torch.get_num_threads()
    torch.set_num_threads(min(4, was))
    yield
    torch.set_num_threads(was)
