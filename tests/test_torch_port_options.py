"""PyTorch port, the entry points' flags against the JAX package's
(``cli/options.py``, ``cli/test.py``): every JAX flag either means the
same in the port or is refused (no abbreviation of a port flag takes
it), ``--sp`` and ``--printhelp``, the command lines of
``scripts/test_*.sh`` through the port's ``cli.test`` into the JAX
package's output directory, and a ``--decoder_width 0.5`` checkpoint of
the port's ``cli.train`` rebuilt by its ``cli.test`` against the JAX
``ModelTest``.  Sizes 64² -> 32³."""

import argparse
import glob
import os
import shutil

import numpy as np
import pytest
import torch

from genre_shapehd_tpu.cli import options as jax_options
from genre_shapehd_tpu.cli import test as jax_cli_test
from genre_shapehd_tpu.core import registry as jax_registry
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu_torch.cli import options
from genre_shapehd_tpu_torch.cli import test as port_cli
from genre_shapehd_tpu_torch.cli import train as port_train
from genre_shapehd_tpu_torch.core.checkpoint import save_checkpoint
from genre_shapehd_tpu_torch.core.registry import get_model
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.train.state import state_to_reference_payload

from _shapenet_tree import script_argv
from _torch_port_util import jax_test_outputs, release_memory, write_photos

torch.set_num_threads(2)
#: the JAX flags the port refuses on purpose (ROADMAP.md: no code of
#: either package reads them; ``--gpu`` is ``--device`` in the port)
NOT_PORTED = {"--gpu", "--sgd_momentum", "--sgd_dampening", "--sgd_wdecay",
              "--save_net_opt", "--vis_every_train", "--vis_batches_train"}
DIMS = dict(im_size=64, vox_res=32, sph_res=32, z_res=32)
#: the models with a test-time class (``cli.test --net``)
TEST_MODELS = ("genre_full_model", "marrnet", "shapehd")


@pytest.fixture(scope="module", autouse=True)
def _release_memory_at_the_end():
    yield
    release_memory()


def _long_flags(parser):
    return {s: a.dest for a in parser._actions for s in a.option_strings
            if s.startswith("--")}


def _jax_train_parser(net, dataset):
    p = argparse.ArgumentParser()
    jax_options.add_general_arguments(p)
    p.add_argument("--printhelp", action="store_true")
    if dataset is not None:
        jax_registry.get_dataset(dataset).add_arguments(p)
    jax_registry.get_model(net).add_arguments(p)
    return p


def _shadowed(jax_parser, port_parser):
    """JAX flags that the port reads otherwise: a flag of another dest,
    or an abbreviation of a port flag; and JAX flags the port neither
    has nor refuses on purpose."""
    port = _long_flags(port_parser)
    bad = []
    for flag, dest in _long_flags(jax_parser).items():
        if flag in port:
            if port[flag] != dest:
                bad.append((flag, dest, port[flag]))
            continue
        prefixed = [f for f in port if f.startswith(flag)]
        if prefixed or flag not in NOT_PORTED:
            bad.append((flag, "missing", prefixed))
    return bad


@pytest.mark.parametrize("net", sorted(jax_registry.model_aliases()))
@pytest.mark.parametrize("dataset", [None, "shapenet", "synthetic"])
def test_no_jax_flag_means_another_thing_in_the_port(net, dataset):
    """Each flag of the JAX train parser (the general flags, the dataset's
    and the model's) and of its test parser is the port's flag of the
    same name and dest, or is refused by the port's: none is an
    abbreviation of a port flag (``--sp`` was one of ``--sph_res``).  The
    test parser is held for the models ``cli.test`` takes."""
    port, _ = options.train_parser(net, dataset)
    assert not _shadowed(_jax_train_parser(net, dataset), port)
    if dataset is None and net in TEST_MODELS:
        jp = argparse.ArgumentParser()
        jax_options.add_general_arguments(jp)
        for flag in ("--input_rgb", "--input_mask", "--net_file",
                     "--output_dir", "--marrnet1_file"):
            jp.add_argument(flag)
        jp.add_argument("--overwrite", action="store_true")
        jax_registry.get_model(net, test=True).add_arguments(jp)
        assert not _shadowed(jp, options.test_parser(net))


def test_sp_is_its_own_flag():
    """``--sp 2`` sets ``sp`` and leaves ``sph_res`` at 128, in the train
    and the test parser, as in the JAX package's."""
    opt, unique = options.parse_train(["--net", "genre_full_model",
                                       "--sp", "2"])
    ref, _ = jax_options.parse_train(["--net", "genre_full_model",
                                      "--sp", "2"])
    assert (opt.sp, opt.sph_res) == (ref.sp, ref.sph_res) == (2, 128)
    assert "sp" in unique
    assert options.parse_train(["--net", "marrnet1"])[0].sp == 1
    opt = options.parse_test(["--net", "genre_full_model", "--net_file",
                              "x.pt", "--input_rgb", "x", "--output_dir",
                              "o", "--sp", "2"])
    assert (opt.sp, opt.sph_res) == (2, 128)


def test_printhelp_lists_the_model_and_dataset_flags(capsys):
    """``--printhelp`` prints the help after the model's and the dataset's
    flags are registered and exits 0, as the JAX parser does; ``--help``
    of the port lists them too."""
    argv = ["--net", "genre_full_model", "--dataset", "shapenet",
            "--printhelp"]
    with pytest.raises(SystemExit) as e:
        options.parse_train(argv)
    assert e.value.code == 0
    text = capsys.readouterr().out
    for flag in ("--surface_weight", "--exact_render", "--decoder_width",
                 "--sp", "--data_root", "--printhelp"):
        assert flag in text, flag
    with pytest.raises(SystemExit) as e:
        options.parse_train(argv[:-1] + ["--help"])
    assert e.value.code == 0 and "--surface_weight" in capsys.readouterr().out


# ------------------------------------------------------ scripts/test_*.sh
def _checkpoint(path, net, **flags):
    """A port model's seeded start, written as ``cli.train`` writes it,
    without the optimizers' states (``cli.test`` reads the nets)."""
    model = get_model(net)(default_opt(device="cpu", **DIMS, **flags))
    model.init_state(0)
    payload = state_to_reference_payload(model, 0, 0.0)
    payload.update(optimizers=[], opt_names=[])
    save_checkpoint(path, payload)
    return path


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


SCRIPTS = {"test_genre.sh": ("genre_full_model", {}),
           "test_marrnet.sh": ("marrnet", {}),
           "test_shapehd.sh": ("shapehd", {"MARRNET1_FILE": "marrnet1"})}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_command_lines_write_where_jax_writes(script, tmp_path,
                                                     monkeypatch):
    """The arguments ``scripts/<script>`` passes to the JAX ``cli.test``
    (its ``--suffix '{net}'``, ``--workers 0``, ``--batch_size 1``),
    with the test sizes and, for the port, ``--device cpu``: the JAX
    ``cli.test`` makes ``output/test_<net>`` (run up to its model) and
    the port's writes its batches there, not to ``output/test``."""
    try:
        _script_command_line(script, tmp_path, monkeypatch)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _script_command_line(script, tmp_path, monkeypatch):
    net, env = SCRIPTS[script]
    photos = str(tmp_path / "photos")
    write_photos(photos, 2)
    env = {k: _checkpoint(str(tmp_path / f"{v}.pt"), v,
                          pred_depth_minmax=True)
           for k, v in env.items()}
    env.update(NET_FILE=_checkpoint(str(tmp_path / f"{net}.pt"), net,
                                    canon_sup=net == "shapehd"),
               RGB=os.path.join(photos, "*_rgb.png"),
               MASK=os.path.join(photos, "*_silhouette.png"))
    argv = script_argv(script, None, env=env,
                       module="genre_shapehd_tpu.cli.test")
    assert argv[argv.index("--suffix") + 1] == "{net}"
    sizes = [f"--{k}={v}" for k, v in DIMS.items()]
    for who in ("jax", "port"):
        os.makedirs(tmp_path / who)
        monkeypatch.chdir(tmp_path / who)
        if who == "jax":
            monkeypatch.setattr(jax_cli_test, "get_model", _stop)
            with pytest.raises(_Stop):
                jax_cli_test.main(argv + sizes)
        else:
            assert port_cli.main(argv + sizes + ["--device", "cpu"]) == 0
    want = sorted(os.listdir(tmp_path / "jax" / "output"))
    assert want == [f"test_{net}"]
    assert sorted(os.listdir(tmp_path / "port" / "output")) == want
    got = sorted(os.path.basename(p) for p in glob.glob(str(
        tmp_path / "port" / "output" / want[0] / "*.npz")))
    assert got == ["batch0000.npz", "batch0001.npz"]


# ------------------------------------------- a --decoder_width checkpoint
def test_decoder_width_checkpoint_is_rebuilt_by_cli_test(tmp_path):
    """``cli.train --decoder_width 0.5`` (GenRe, stage 3, one step) writes
    a checkpoint whose net1 has half the decoder channels; the port's
    ``cli.test --decoder_width 0.5`` rebuilds that net and writes the JAX
    ``ModelTest``'s arrays on the same photos and checkpoint (cv2
    against the port's resize, then float32 nets: 99.9 % of the values
    within 1e-3 of their scale, the mean within 1e-3), where the default
    width cannot load it; ``--exact_render`` is taken at test time."""
    try:
        _decoder_width_checkpoint(tmp_path)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _decoder_width_checkpoint(tmp_path):
    photos = str(tmp_path / "photos")
    write_photos(photos, 2)
    rgb, mask = (os.path.join(photos, f"*_{k}.png")
                 for k in ("rgb", "silhouette"))
    logdir = str(tmp_path / "logs")
    sizes = [f"--{k}={v}" for k, v in DIMS.items()]
    assert port_train.main([
        "--net", "genre_full_model", "--dataset", "synthetic",
        "--decoder_width", "0.5", "--batch_size", "2",
        "--synthetic_length", "2", "--epoch", "1", "--epoch_batches", "1",
        "--eval_batches", "0", "--workers", "2", "--vis_batches_vali", "0",
        "--save_net", "0", "--logdir", logdir, "--device", "cpu",
        "--manual_seed", "3"]
        + sizes) == 0
    ckpt = glob.glob(os.path.join(logdir, "*", "0", "checkpoint.pt"))[0]
    jax_out = str(tmp_path / "jax_out")
    jax_test_outputs("genre_full_model", jax_opt(
        batch_size=2, vis_workers=0, workers=2, net_file=ckpt,
        input_rgb=rgb, input_mask=mask, decoder_width=0.5,
        padding_margin=16, **DIMS), jax_out)
    common = ["--net", "genre_full_model", "--net_file", ckpt,
              "--input_rgb", rgb, "--input_mask", mask, "--batch_size", "2",
              "--workers", "2", "--vis_workers", "0", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_cli.main(common + sizes + ["--output_dir",
                                        str(tmp_path / "default")])
    port_out = str(tmp_path / "port_out")
    assert port_cli.main(common + sizes + ["--output_dir", port_out,
                                           "--decoder_width", "0.5"]) == 0
    ref = np.load(os.path.join(jax_out, "batch0000.npz"))
    got = np.load(os.path.join(port_out, "batch0000.npz"))
    for k in ("pred_voxel", "pred_proj_depth", "pred_proj_sph_full"):
        g, r = got[k], ref[k]
        assert g.shape == r.shape and np.isfinite(g).all(), k
        d = np.abs(g - r)
        scale = max(float(np.abs(r).max()), 1.0)
        assert (d <= 1e-3 * scale).mean() >= 0.999, (k, d.max())
        assert d.mean() <= 1e-3 * scale, (k, d.mean())
    exact = str(tmp_path / "exact_out")
    assert port_cli.main(common + sizes + [
        "--output_dir", exact, "--decoder_width", "0.5",
        "--exact_render"]) == 0
    assert os.path.isfile(os.path.join(exact, "batch0000.npz"))
    opt = options.parse_test(common + sizes + [
        "--output_dir", exact, "--decoder_width", "0.5", "--exact_render"])
    model = get_model("genre_full_model", test=True)(opt)
    assert model.net.depth_and_inpaint.exact_render
