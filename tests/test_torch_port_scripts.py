"""PyTorch port, its launch scripts ``scripts_torch/*.sh`` against the JAX
package's ``scripts/*.sh`` on the CPU: the same arguments, verbatim, to
the port's module (``--tensorboard`` aside where tensorboardX cannot be
imported), the same failure on a missing variable or class, and one
script run for real at a tiny size.
"""

import glob
import os
import re
import subprocess
import sys

import pytest

from genre_shapehd_tpu_torch.data.procedural import generate_sample

from _shapenet_tree import script_argv, write_shapenet_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "scripts", "*.sh")) if not p.endswith("common.sh"))
#: every variable a script reads
ENV = {"NET1": "n1.pt", "INPAINT": "inpaint.pt", "MARRNET1": "m1.pt",
       "MARRNET2": "m2.pt", "GAN": "gan.pt", "W_GAN_LOSS": "1e-3",
       "NET_FILE": "net.pt", "MARRNET1_FILE": "m1file.pt",
       "RGB": "photos/*_rgb.png", "MASK": "photos/*_mask.png"}


def _cls(script):
    return None if script.startswith("test_") else "chair"


def test_every_script_has_its_counterpart():
    port = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "scripts_torch", "*.sh")))
    assert port == sorted(SCRIPTS + ["common.sh"])
    assert len(SCRIPTS) == 11
    for s in port:
        assert os.access(os.path.join(REPO, "scripts_torch", s), os.X_OK), s


def _argv(script, package, env, tensorboardx=True, extra=()):
    """The script's arguments to its module and its stderr: ``scripts/``
    for the package ``genre_shapehd_tpu``, ``scripts_torch/`` for the
    port."""
    mod = f"{package}.cli.{'test' if script.startswith('test_') else 'train'}"
    return script_argv(script, _cls(script), env, mod,
                       "scripts" if package == "genre_shapehd_tpu"
                       else "scripts_torch", tensorboardx, True, extra)


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_script_passes_the_jax_scripts_arguments(script):
    """The port's script gives its module the JAX script's arguments,
    verbatim, with every variable set and extra flags last; where
    tensorboardX cannot be imported, the same but ``--tensorboard``, and
    one line on stderr that says so."""
    for extra in ([], ["--epoch", "3", "--logdir", "elsewhere"]):
        ref, _ = _argv(script, "genre_shapehd_tpu", ENV, extra=extra)
        if extra:
            assert ref[-len(extra):] == extra
        got, err = _argv(script, "genre_shapehd_tpu_torch", ENV,
                         extra=extra)
        assert got == ref and err == ""
        got, err = _argv(script, "genre_shapehd_tpu_torch", ENV, False,
                         extra)
        assert got == [a for a in ref if a != "--tensorboard"]
        if "--tensorboard" in ref:
            assert err.splitlines() == [
                f"{script}: tensorboardX is not installed; leaving out "
                "--tensorboard"]
        else:
            assert err == ""


def _required(script):
    """The variables a JAX script requires (``${VAR:?...}``); ``1`` is
    the class argument."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        return re.findall(r"\$\{(\w+):\?", f.read())


MISSING = [(s, v) for s in SCRIPTS for v in _required(s)]


@pytest.mark.parametrize("script,var", MISSING)
def test_a_missing_variable_fails_as_in_the_jax_script(script, var):
    """Without a required variable (or the class), both scripts stop
    before they start Python, with the same exit status and message (the
    script's path and line aside)."""
    assert len(MISSING) == 17
    env = {k: v for k, v in ENV.items() if k != var}
    cls = None if var == "1" else _cls(script)
    failures = []
    for scripts in ("scripts", "scripts_torch"):
        with pytest.raises(subprocess.CalledProcessError) as e:
            script_argv(script, cls, env, scripts=scripts)
        msg = re.sub(r"^.*?: line \d+: ", "", e.value.stderr.strip())
        failures.append((e.value.returncode,
                         msg.replace(os.path.join(REPO, scripts), "DIR")))
    assert failures[0] == failures[1]
    assert failures[0][0] != 0 and failures[0][1].startswith(f"{var}: ")


def test_train_wgangp_script_runs_on_the_cpu(tmp_path):
    """``scripts_torch/train_wgangp.sh chair`` with ``--device cpu`` and a
    tiny tree (32³ canonical voxels) for one step: it writes its
    checkpoint under the directory its suffix names, and TensorBoard's
    event file where tensorboardX imports (else the line on stderr)."""
    root = str(tmp_path / "shapenet")
    chair = "03001627"
    write_shapenet_tree(root, [
        dict(item=f"{chair}/{m}/{m}_view000", train=train,
             sample=generate_sample(i, 64, 32, 32),
             missing=("voxel", "voxel_canon") if m == "x0" else ())
        for i, (m, train) in enumerate(
            (("a0", True), ("a1", True), ("x0", True), ("b0", False),
             ("b1", False)))])
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "python").write_text(
        f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (bindir / "python").chmod(0o755)
    logs = str(tmp_path / "logs")
    res = subprocess.run(
        ["bash", os.path.join(REPO, "scripts_torch", "train_wgangp.sh"),
         "chair", "--device", "cpu", "--data_root", root, "--logdir", logs,
         "--vox_res", "32", "--batch_size", "2", "--epoch", "1",
         "--epoch_batches", "1", "--eval_batches", "1", "--workers", "1",
         "--vis_batches_vali", "0"],
        capture_output=True, text=True, timeout=300, stdin=subprocess.DEVNULL,
        env=dict(os.environ, OMP_NUM_THREADS="2",
                 PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "[setup] 2 train / 2 vali samples" in res.stdout
    run = os.path.join(logs, "wgangp_shapenet_0.0001_chair", "0")
    assert os.path.isfile(os.path.join(run, "checkpoint.pt"))
    try:
        import tensorboardX                                  # noqa: F401
        assert glob.glob(os.path.join(run, "tensorboard", "events.out.*"))
    except ImportError:
        assert "leaving out --tensorboard" in res.stderr
