"""PyTorch port, the reference release's checkpoints: the port's converter
(``genre_shapehd_tpu_torch/core/reference.py``,
``tools/convert_reference_checkpoint_torch.py``) against the JAX tool
(``tools/convert_reference_checkpoint.py`` with
``tools/torch_layer_conversion.py``) on seeded reference-layout files.

The files are written from the port's nets through ``chip_smoke.py``'s
inverse of the port's tables (``reference_layout``), each net's keys
shuffled out of the port module's order, random values per key, seeded
Adam moments whose parameter ids follow the file's order.  Voxel nets are
at 128³, the only size the reference (and so the JAX tool) has, narrow
where the modules allow it.  Checked: the payloads bit for bit (nets,
moments, counts) for the 8 aliases, with every key of the file read by
the JAX tool; GenRe's and ShapeHD's forwards on the two payloads; one
resumed Adam step against the JAX ``Trainer``'s; the file formats;
negative controls.
"""

import os
import shutil
import sys

import numpy as np
import optax
import pytest
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_layer_conversion as jax_layers  # noqa: E402
from chip_smoke import reference_layout  # noqa: E402
from genre_shapehd_tpu.core.checkpoint import \
    load_checkpoint as jax_load  # noqa: E402
from genre_shapehd_tpu.core.registry import get_model as jax_model  # noqa
from genre_shapehd_tpu.models.base import default_opt as jax_opt  # noqa
from genre_shapehd_tpu.models.genre_full import \
    GenreNet as JaxGenreNet  # noqa: E402
from genre_shapehd_tpu.models.marrnet2 import \
    Marrnet2Net as JaxMarrnet2Net  # noqa: E402
from genre_shapehd_tpu.nn.voxel_nets import \
    VoxelDiscriminator as JaxCritic  # noqa: E402
from genre_shapehd_tpu.parallel import mesh as pmesh  # noqa: E402
from genre_shapehd_tpu.train.loop import Trainer as JaxTrainer  # noqa
from genre_shapehd_tpu.train.state import ModelState  # noqa: E402
from genre_shapehd_tpu_torch import nn as tnn  # noqa: E402
from genre_shapehd_tpu_torch.core.convert import (  # noqa: E402
    jax_to_torch, torch_to_jax)
from genre_shapehd_tpu_torch.core.reference import \
    convert_checkpoint  # noqa: E402
from genre_shapehd_tpu_torch.core.registry import get_model  # noqa: E402
from genre_shapehd_tpu_torch.models.base import default_opt  # noqa: E402
from genre_shapehd_tpu_torch.models.genre_full import GenreNet  # noqa
from genre_shapehd_tpu_torch.models.marrnet2 import Marrnet2Net  # noqa
from genre_shapehd_tpu_torch.train.loop import Trainer  # noqa: E402
from tools import convert_reference_checkpoint as jax_tool  # noqa: E402
from tools import convert_reference_checkpoint_torch as port_tool  # noqa

from _torch_port_util import (calibrate, release_memory,  # noqa: E402
                              scene_inputs, to_np)

torch.set_num_threads(4)
ALIASES = ["marrnet1", "marrnet2", "marrnet", "wgangp", "shapehd",
           "depth_pred_with_sph_inpaint", "genre_full_model", "resnet18"]
#: each optimizer of a model: (index of the file's net, the prefix of
#: the parameters it covers)
OPTIMIZERS = {"wgangp": [(0, ""), (1, "")], "shapehd": [(0, "marrnet2.")],
              "marrnet": [(0, "marrnet2.")], "resnet18": []}
LR = 1e-4


def param_names(sd):
    """A ``state_dict``'s parameters in its order (buffers left out): the
    order of its module's ``parameters()``, which torch's optimizer ids
    follow."""
    return [k for k in sd if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]


@pytest.fixture(autouse=True, scope="module")
def _release():
    yield
    release_memory()


@pytest.fixture(autouse=True)
def _delete_files(tmp_path):
    """Each test's checkpoints go when it ends (up to 1.5 GB a test; the
    whole suite shares one disk)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _marrnet1():
    return tnn.UResNet(3, (3, 1, 1), ("normal", "depth", "silhou"),
                       pred_depth_minmax=True, im_size=64,
                       decoder_width=0.25)


def _inpaint():
    return tnn.UResNet(1, (1,), ("spherical",), inpainting=True,
                       decoder_width=0.25)


def _marrnet2():
    return Marrnet2Net(encode_dims=8, nf=32, vox_res=128)


def _port_nets(alias):
    """The port's nets of ``alias`` (its net names), narrow: decoders at a
    quarter width, voxel nets at 128³ with few channels."""
    md = nn.ModuleDict
    return {
        "marrnet1": lambda: {"net": _marrnet1()},
        "marrnet2": lambda: {"net": _marrnet2()},
        "marrnet": lambda: {"net": md({"marrnet1": _marrnet1(),
                                       "marrnet2": _marrnet2()})},
        "wgangp": lambda: {"net_g": tnn.VoxelGenerator(8, 4, 128),
                           "net_d": tnn.VoxelDiscriminator(4, 128)},
        "shapehd": lambda: {"net": _marrnet2(), "net_noft": _marrnet2(),
                            "net_d": tnn.VoxelDiscriminator(4, 128)},
        "depth_pred_with_sph_inpaint": lambda: {"net": md({
            "net1": _marrnet1(), "net2": _inpaint()})},
        "genre_full_model": lambda: {"net": md({
            "depth_and_inpaint": md({"net1": _marrnet1(),
                                     "net2": _inpaint()}),
            "refine_net": tnn.UNet3D(2, 128)})},
        "resnet18": lambda: {"net": tnn.ResNet18Features(3)},
    }[alias]()


def _random_values(sd, rng):
    """``sd`` with every entry drawn anew: N(0, 1) floats (variances
    |N(0, 1)|), counters as integers."""
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            a = rng.standard_normal(v.shape).astype(np.float32)
            out[k] = torch.from_numpy(np.abs(a) if "running_var" in k else a)
        else:
            out[k] = torch.tensor(int(rng.integers(1, 100)), dtype=v.dtype)
    return out


def _shuffled(sd, rng):
    keys = list(sd)
    order = [keys[i] for i in rng.permutation(len(keys))]
    assert param_names(dict.fromkeys(order)) != param_names(sd)
    return {k: sd[k] for k in order}


def _adam(net, prefix, rng, step=2, str_ids=False, skip=5):
    """A torch Adam ``state_dict`` over ``net``'s parameters under
    ``prefix`` in the file's order: seeded moments (every ``skip``-th
    parameter never stepped) and ``step``."""
    names = [k for k in param_names(net) if k.startswith(prefix)]
    state = {}
    for i, k in enumerate(names):
        if skip and i % skip == skip - 1:
            continue
        shape = net[k].shape
        state[str(i) if str_ids else i] = {
            "step": step,
            "exp_avg": torch.from_numpy(
                1e-3 * rng.standard_normal(shape).astype(np.float32)),
            "exp_avg_sq": torch.from_numpy(
                1e-6 * rng.random(shape).astype(np.float32))}
    return {"state": state, "param_groups": [{
        "lr": LR, "betas": (0.5, 0.9), "eps": 1e-8, "weight_decay": 0,
        "amsgrad": False, "params": list(range(len(names)))}]}


def reference_file(alias, seed, nets=None, random=True,
                   batches_tracked=True, step=2, str_ids=False):
    """A reference-layout checkpoint of ``alias``: the port's ``nets``
    ({name: state_dict}; narrow seeded ones by default) inverted, each
    file net shuffled, values drawn anew unless not ``random``, Adam
    states as the reference's optimizers hold them; a bare
    ``state_dict`` for ``resnet18``."""
    rng = np.random.default_rng(seed)
    if nets is None:
        nets = {n: m.state_dict() for n, m in _port_nets(alias).items()}
    if random:
        nets = {n: _random_values(sd, rng) for n, sd in nets.items()}
    files = [_shuffled(sd, rng) for sd in reference_layout(
        alias, nets, batches_tracked=batches_tracked)]
    if alias == "resnet18":
        return files[0]
    opts = [_adam(files[i], prefix, rng, step, str_ids)
            for i, prefix in OPTIMIZERS.get(alias, [(0, "")])]
    return {"nets": files, "optimizers": opts, "epoch": 3,
            "loss_eval": 0.25}


class _Read:
    """A value the JAX tool reads through ``np.asarray``: records its
    key."""

    def __init__(self, key, arr, reads):
        self.key, self.arr, self.reads = key, arr, reads

    def __array__(self, dtype=None, copy=None):
        self.reads.add(self.key)
        return self.arr if dtype is None else self.arr.astype(dtype)


def jax_convert(alias, path):
    """The JAX tool on the file at ``path``: (nets, net names, optimizer
    states, optimizer names) as its ``main`` computes them, and whether it
    read every key (``num_batches_tracked`` aside, which neither tool
    reads)."""
    payload = torch.load(path, map_location="cpu")
    reads = set()
    if alias == "resnet18":
        sd = {k: np.asarray(v) for k, v in payload.items()
              if not k.endswith("num_batches_tracked")}
        params, stats = jax_layers.convert_torchvision_resnet18(
            {k: _Read((0, k), v, reads) for k, v in sd.items()})
        keys = {(0, k) for k in sd}
        out = ([{"params": params, "batch_stats": stats}], None, [], None)
    else:
        nets = [jax_tool.convert_state_dict(sd) for sd in payload["nets"]]
        wrapped = [{k: _Read((i, k), v, reads) for k, v in sd.items()}
                   for i, sd in enumerate(nets)]
        out = (*jax_tool.convert_model_nets(alias, wrapped),
               *jax_tool.convert_model_optimizers(alias, payload, nets))
        keys = {(i, k) for i, sd in enumerate(nets) for k in sd
                if not k.endswith("num_batches_tracked")}
    return out, sorted(keys - reads)


def port_convert(alias, path, tmp_path, capsys):
    """The port's tool as a user runs it; its file read as the JAX
    package reads one (optax's classes for Adam's state) and its stderr."""
    dst = str(tmp_path / f"{alias}_port.pt")
    capsys.readouterr()
    assert port_tool.main(["--src", str(path), "--net", alias,
                           "--dst", dst]) == 0
    err = capsys.readouterr().err
    return jax_load(dst), err


def assert_same(got, want, path="."):
    """Trees equal key for key, leaves bit for bit in dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                       w.dtype, g.shape,
                                                       w.shape)
    assert np.array_equal(g, w), path


def assert_same_payload(got, want):
    nets, net_names, opts, opt_names = want
    assert len(got["nets"]) == len(nets)
    for g, w in zip(got["nets"], nets):
        assert_same(g, w)
    if net_names is None:                     # resnet18: the net alone
        assert got["optimizers"] == [] and "net_names" not in got
        return
    assert got["net_names"] == net_names and got["opt_names"] == opt_names
    assert len(got["optimizers"]) == len(opts)
    for g, w in zip(got["optimizers"], opts):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        assert type(g[0]) is optax.ScaleByAdamState
        assert type(g[1]) is optax.EmptyState
        assert_same(g[0].count, w[0].count)
        assert_same(g[0].mu, w[0].mu)
        assert_same(g[0].nu, w[0].nu)


@pytest.mark.parametrize("alias", ALIASES)
def test_payload_matches_the_jax_tool(alias, tmp_path, capsys):
    """Bit for bit: every net's params and batch statistics, the net and
    optimizer names, each Adam state's count and moments (the parameter
    ids paired in the file's order, a shuffled one; moments of the
    parameters an optimizer leaves out or never stepped zero), epoch and
    loss; the JAX tool read every key of the file, the port's tool
    reported none unread."""
    path = tmp_path / f"{alias}.pt"
    torch.save(reference_file(alias, seed=ALIASES.index(alias)), path,
               _use_new_zipfile_serialization=False)
    want, unread = jax_convert(alias, path)
    assert unread == []
    got, err = port_convert(alias, path, tmp_path, capsys)
    assert "unread" not in err, err
    assert_same_payload(got, want)
    if alias != "resnet18":
        assert (got["epoch"], got["loss_eval"]) == (3, 0.25)
        counts = [int(o[0].count) for o in got["optimizers"]]
        assert counts == [2] * len(OPTIMIZERS.get(alias, [0])), counts
        for o in got["optimizers"]:               # never-stepped ones: 0
            assert any(not np.asarray(v).any()
                       for v in jax.tree.leaves(o[0].mu))


@pytest.mark.parametrize("fmt", [
    dict(legacy=False, step="tensor", str_ids=True, batches_tracked=False),
    dict(legacy=True, step="tensor", str_ids=False, batches_tracked=False),
    dict(legacy=False, step="int", str_ids=False, batches_tracked=True),
    dict(legacy=True, step="int", str_ids=True, batches_tracked=True)])
def test_file_formats(fmt, tmp_path, capsys):
    """The legacy (PyTorch 0.4.1) and zip formats, ``step`` as an int and
    as a float tensor (PyTorch >= 1.12), state ids as ints and strings,
    BatchNorms with and without ``num_batches_tracked``: WGAN-GP's payload
    (two nets, two optimizers) bit for bit as the JAX tool's."""
    step = 2 if fmt["step"] == "int" else torch.tensor(2.0)
    payload = reference_file("wgangp", seed=11, step=step,
                             str_ids=fmt["str_ids"],
                             batches_tracked=fmt["batches_tracked"])
    nbt = [k for k in payload["nets"][0] if "num_batches" in k]
    assert bool(nbt) == fmt["batches_tracked"]
    path = tmp_path / "wgangp.pt"
    torch.save(payload, path,
               _use_new_zipfile_serialization=not fmt["legacy"])
    with open(path, "rb") as f:
        assert (f.read(2) == b"PK") != fmt["legacy"]
    want, unread = jax_convert("wgangp", path)
    assert unread == []
    got, err = port_convert("wgangp", path, tmp_path, capsys)
    assert "unread" not in err, err
    assert_same_payload(got, want)
    assert [int(o[0].count) for o in got["optimizers"]] == [2, 2]


def test_negative_controls(tmp_path, capsys):
    """A missing key raises and names it (the JAX tool raises too); an
    optimizer covering one parameter fewer than the file holds raises (the
    JAX tool asserts); two BatchNorms of one shape swapped in the file
    change the payload at exactly those two modules, as the JAX tool's;
    keys no table reads are listed on stderr and change nothing."""
    payload = reference_file("marrnet1", seed=12)
    sd = payload["nets"][0]
    base, _ = convert_checkpoint("marrnet1", payload)

    key = "decoder_depth.2.1.bn2.running_var"
    broken = dict(payload, nets=[{k: v for k, v in sd.items() if k != key}])
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        convert_checkpoint("marrnet1", broken)
    nets = [jax_tool.convert_state_dict(broken["nets"][0])]
    with pytest.raises(KeyError):
        jax_tool.convert_model_nets("marrnet1", nets)

    opt = payload["optimizers"][0]
    short = dict(opt, param_groups=[dict(opt["param_groups"][0],
                                         params=list(range(
                                             len(param_names(sd)) - 1)))])
    with pytest.raises(ValueError, match="optimizer covers"):
        convert_checkpoint("marrnet1", dict(payload, optimizers=[short]))
    with pytest.raises(AssertionError):
        jax_tool.convert_model_optimizers(
            "marrnet1", dict(payload, optimizers=[short]),
            [jax_tool.convert_state_dict(sd)])

    # encoder.0.1 is the stem's bn1, encoder.1.0.bn1 the first block's:
    # both of 64 channels
    a, b = "encoder.0.1", "encoder.1.0.bn1"
    swapped = dict(sd)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        swapped[f"{a}.{leaf}"], swapped[f"{b}.{leaf}"] = (
            sd[f"{b}.{leaf}"], sd[f"{a}.{leaf}"])
    path = tmp_path / "swapped.pt"
    torch.save(dict(payload, nets=[swapped]), path)
    got, _ = port_convert("marrnet1", path, tmp_path, capsys)
    assert_same_payload(got, jax_convert("marrnet1", path)[0])
    enc = "ResNet18Features_0"
    for tree in ("params", "batch_stats"):
        g, w = got["nets"][0][tree][enc], base["nets"][0][tree][enc]
        for mod in ("BatchNorm_0",):
            for leaf in g[mod]:
                assert not np.array_equal(g[mod][leaf], w[mod][leaf])
        for leaf in g["BasicBlock_0"]["ConvBN_0"]["BatchNorm_0"]:
            assert not np.array_equal(
                g["BasicBlock_0"]["ConvBN_0"]["BatchNorm_0"][leaf],
                w["BasicBlock_0"]["ConvBN_0"]["BatchNorm_0"][leaf])
        g["BatchNorm_0"] = w["BatchNorm_0"]
        g["BasicBlock_0"]["ConvBN_0"]["BatchNorm_0"] = \
            w["BasicBlock_0"]["ConvBN_0"]["BatchNorm_0"]
    assert_same(got["nets"][0], base["nets"][0])

    extra = dict(sd, **{"fc.weight": torch.zeros(2, 3),
                        "decoder_depth.4.2.weight": torch.zeros(1)})
    path = tmp_path / "extra.pt"
    torch.save(dict(payload, nets=[extra],
                    optimizers=[]), path)
    got, err = port_convert("marrnet1", path, tmp_path, capsys)
    assert sorted(line for line in err.splitlines()
                  if line.startswith("unread")) == [
        "unread: nets[0].decoder_depth.4.2.weight",
        "unread: nets[0].fc.weight"], err
    assert_same(got["nets"][0], base["nets"][0])


# ------------------------------------------------------------ forwards

GENRE = dict(im_size=64, vox_res=128, sph_res=32, z_res=32,
             padding_margin=16, refine_nf=4)


def test_genre_forward_on_both_payloads(tmp_path, capsys):
    """GenRe at 64² -> 128³ (the reference's U-Net is 128³; ``refine_nf``
    4), calibrated seeded weights as a reference file: the JAX
    ``GenreNet`` on the JAX tool's payload against the port's on its own,
    float32, within tests/test_torch_port_genre.py's tolerances."""
    rgb, sil = scene_inputs(1, 64, seed=3)
    net = GenreNet(**GENRE).eval()
    tnn.init_weights(net, torch.Generator().manual_seed(3))
    params, stats = calibrate(*torch_to_jax(net.state_dict()), rgb, sil,
                              cfg=GENRE)
    path = tmp_path / "genre.pt"
    torch.save(reference_file("genre_full_model", seed=3, random=False,
                              nets={"net": jax_to_torch(params, stats)}),
               path, _use_new_zipfile_serialization=False)
    want, unread = jax_convert("genre_full_model", path)
    assert unread == []
    got, _ = port_convert("genre_full_model", path, tmp_path, capsys)
    assert_same_payload(got, want)

    jnet = JaxGenreNet(**GENRE)
    ref = jax.jit(lambda v, r, m: jnet.apply(v, r, m, train=False))(
        want[0][0], rgb, sil)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    net.load_state_dict(jax_to_torch(got["nets"][0]["params"],
                                     got["nets"][0]["batch_stats"]))
    with torch.no_grad():
        out = {k: v.numpy() for k, v in
               net(torch.from_numpy(rgb), torch.from_numpy(sil)).items()}
    assert (ref["proj_depth"] > ref["proj_depth"].min()).sum() > 500
    for k in ("depth", "normal", "silhou", "depth_minmax"):
        d, scale = np.abs(out[k] - ref[k]), float(np.abs(ref[k]).max())
        assert d.max() <= 2e-5 * scale, (k, d.max(), scale)
    for k in ("proj_depth", "pred_sph_partial", "pred_sph_full",
              "pred_proj_sph_full", "pred_voxel"):
        assert out[k].shape == ref[k].shape, k
        d, scale = np.abs(out[k] - ref[k]), max(float(np.abs(
            ref[k]).max()), 1.0)
        assert (d <= 1e-3 * scale).mean() >= 0.999, (k, d.max(), scale)
        assert d.mean() <= 1e-3 * scale, (k, d.mean(), scale)


def test_shapehd_forward_on_both_payloads(tmp_path, capsys):
    """ShapeHD's three nets (MarrNet-2 at ``nf`` 32, its frozen copy and
    the critic at ``nf`` 4, 128³) from one reference file: the finetuned
    and frozen voxels and the critic's scores of their sigmoids, JAX on
    the JAX tool's payload against the port on its own, float32, within
    1e-4 of their scale (tests/test_torch_port_marrnet.py's forward
    bound)."""
    nets = _port_nets("shapehd")
    for i, m in enumerate(nets.values()):
        tnn.init_weights(m, torch.Generator().manual_seed(4 + i))
    path = tmp_path / "shapehd.pt"
    torch.save(reference_file("shapehd", seed=4, random=False, nets={
        n: m.state_dict() for n, m in nets.items()}), path,
        _use_new_zipfile_serialization=False)
    want, _ = jax_convert("shapehd", path)
    got, _ = port_convert("shapehd", path, tmp_path, capsys)
    assert_same_payload(got, want)
    rng = np.random.default_rng(4)
    depth = rng.standard_normal((1, 64, 64, 1)).astype(np.float32)
    normal = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    silhou = (rng.random((1, 64, 64, 1)) > 0.3).astype(np.float32)
    m2 = JaxMarrnet2Net(encode_dims=8, nf=32, vox_res=128)
    critic = JaxCritic(nf=4, res=128)

    @jax.jit
    def jax_forward(net, d):
        vox = m2.apply(net, depth, normal, silhou, train=False)
        return vox, critic.apply(d, jax.nn.sigmoid(vox))

    d = tnn.VoxelDiscriminator(4, 128).eval()
    d.load_state_dict(jax_to_torch(got["nets"][2]["params"], {}))
    for i, name in enumerate(("net", "net_noft")):
        vox, score = map(np.asarray, jax_forward(want[0][i], want[0][2]))
        net = nets[name].eval()
        net.load_state_dict(jax_to_torch(got["nets"][i]["params"],
                                         got["nets"][i]["batch_stats"]))
        with torch.no_grad():
            tvox = net(*map(torch.from_numpy, (depth, normal, silhou)))
            tscore = d(torch.sigmoid(tvox))
        for what, g, r in (("voxel", tvox.numpy(), vox),
                           ("score", tscore.numpy(), score)):
            assert g.shape == r.shape, (name, what)
            scale = max(float(np.abs(r).max()), 1e-6)
            err = float(np.abs(g - r).max())
            assert err <= 1e-4 * scale, (name, what, err, scale)


# ------------------------------------------------------------ resume

RESUME = {"marrnet1": dict(pred_depth_minmax=True, decoder_width=0.25),
          "wgangp": dict(canon_voxel=True),
          "shapehd": dict(canon_sup=True)}


@pytest.mark.parametrize("alias", sorted(RESUME))
def test_resumed_adam_step_matches_the_jax_trainer(alias, tmp_path,
                                                   capsys, monkeypatch):
    """A reference file of the model's own nets (64² images, 128³ voxels)
    with seeded Adam moments at step 2, converted by each package's tool:
    the port's ``Trainer`` resumes it, the JAX ``Trainer`` loads the JAX
    tool's file; given the same gradients (0.01 sin(1000 p) of each
    parameter), each package's Adam takes its step: within 1e-3 lr plus
    one ulp of the parameter (Adam's arithmetic in float32 in both), from
    the same weights bit for bit, counts 2 -> 3."""
    dims = dict(im_size=64, vox_res=128, lr=LR, **RESUME[alias])
    model = get_model(alias)(default_opt(device="cpu", **dims))
    trainer = Trainer(model, model.opt)
    trainer.initialize(0)
    src = tmp_path / f"{alias}.pt"
    torch.save(reference_file(alias, seed=5, random=False, nets={
        n: m.state_dict() for n, m in model.net_modules().items()}), src,
        _use_new_zipfile_serialization=False)
    jax_dst, port_dst = tmp_path / "jax.pt", tmp_path / "port.pt"
    monkeypatch.setattr(sys, "argv", ["convert", "--src", str(src), "--net",
                                      alias, "--dst", str(jax_dst)])
    jax_tool.main()
    assert port_tool.main(["--src", str(src), "--net", alias,
                           "--dst", str(port_dst)]) == 0
    os.remove(src)
    trainer.load(str(port_dst))

    jm = jax_model(alias)(jax_opt(**dims))
    jt = JaxTrainer(jm, jm.opt, mesh=pmesh.make_mesh(jax.devices()[:1]))
    jt.state = ModelState(params={}, batch_stats={}, opt_state={},
                          step=jnp.zeros((), jnp.int32))
    jt.load(str(jax_dst))
    assert jt.start_epoch == trainer.start_epoch == 3
    txs = {"net": getattr(jm, "tx", None), "net_g": getattr(jm, "tx_g", None),
           "net_d": getattr(jm, "tx_d", None)}
    for name, (optimizer, net) in model.optimizer_entries().items():
        params, opt_state = jt.state.params[name], jt.state.opt_state[name]
        assert int(opt_state[0].count) == 2
        before = {k: v.detach().clone() for k, v in
                  net.named_parameters()}
        for k, v in jax_to_torch(to_np(params), {}).items():
            assert torch.equal(v, before[k]), (name, k)
        grads = {k: torch.from_numpy((0.01 * np.sin(
            1000.0 * v.numpy().astype(np.float64))).astype(np.float32))
            for k, v in before.items()}
        for k, p in net.named_parameters():
            p.grad = grads[k].clone()
        optimizer.step()
        updates, new_state = jax.jit(txs[name].update)(
            torch_to_jax(grads)[0], opt_state, params)
        assert int(new_state[0].count) == 3
        after = jax_to_torch(to_np(optax.apply_updates(params, updates)), {})
        for k, p in net.named_parameters():
            assert int(optimizer.state[p]["step"]) == 3
            p0 = before[k].numpy()
            d = np.abs((p.detach() - before[k]).numpy()
                       - (after[k].numpy() - p0))
            assert (d <= 1e-3 * LR + np.spacing(np.abs(p0))).all(), (
                name, k, d.max())
