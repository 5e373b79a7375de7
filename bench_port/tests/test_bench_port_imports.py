"""Nothing the benchmark runs is JAX or the JAX package, by top-level
module names compared whole (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest
from conftest import BENCH

import harness

ROOT = BENCH.parent
PORT = "genre_shapehd_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert PORT not in set(_imports(path))


def test_names_are_compared_whole():
    sys.modules.setdefault("genre_shapehd_tpu_torch_probe", sys)
    try:
        assert "genre_shapehd_tpu_torch_probe" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["genre_shapehd_tpu_torch_probe"]


def test_what_a_run_loads_holds_no_jax():
    """Every driver, reader and reference module, and the port's modules
    that the drivers load, in a fresh process."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness, run, profiling, drive, control\n"
        "from reference import models, geometry, nets, precision\n"
        "b = harness.benchmark()\n"
        "for w in b['workloads']:\n"
        "    harness.driver(harness.workload(w['name'])['driver'])\n"
        "for m in b['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "from genre_shapehd_tpu_torch.cli import options\n"
        "from genre_shapehd_tpu_torch.core import registry, checkpoint, "
        "convert\n"
        "registry.get_model('genre_full_model')\n"
        "for n in ('genre_full_model', 'shapehd'):\n"
        "    registry.get_model(n, test=True)\n"
        "from genre_shapehd_tpu_torch.models import marrnet, marrnet2\n"
        "print(harness.forbidden_modules())\n") % (str(BENCH), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "genre-infer-b128",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
