"""The reference release's checkpoints -> this package's checkpoint payload
(counterpart of ``tools/convert_reference_checkpoint.py`` and
``tools/torch_layer_conversion.py``), without JAX.

The reference saves ``{'nets': [state_dict, ...], 'optimizers': [Adam
state_dict, ...], 'epoch': N}``; a torchvision ResNet-18 (``--net
resnet18``, for ``--backbone_init``) is a bare ``state_dict``.  Its nets
are torch modules, as this package's are, so every weight here is the
reference's weight under another name: a transposed convolution's
``(I, O, k...)`` stays as it is.  The tables below map each reference
module onto the port's module of the same layer, and
``core/convert.py::torch_to_jax`` turns the renamed ``state_dict`` into
the payload's trees, which flips the transposed convolutions' taps for
the JAX package's layout once, as the JAX tool does.

Adam's moments follow the same tables (Adam is elementwise).  The
optimizer's parameter ids follow the order of the file's own
``state_dict`` with the buffers left out, which is the reference net's
``parameters()`` order; its state becomes optax's ``(ScaleByAdamState,
EmptyState)``, which either package resumes.  A net's keys that no table
reads are returned (the JAX tool ignores them too); ``num_batches_tracked``
is dropped on the way in.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..train.state import EmptyState, ScaleByAdamState
from .convert import torch_to_jax

#: (reference module, port module, the leaves both hold)
Table = List[Tuple[str, str, Tuple[str, ...]]]

W = ("weight",)
WB = ("weight", "bias")
BN = ("weight", "bias", "running_mean", "running_var")
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
MARRNET1_MAPS = ("normal", "depth", "silhou")
ALIASES = ("marrnet1", "marrnet2", "marrnet", "wgangp", "shapehd",
           "depth_pred_with_sph_inpaint", "depth_inpaint",
           "genre_full_model", "genre", "resnet18")


def _j(*parts: str) -> str:
    return ".".join(p for p in parts if p)


# ------------------------------------------------------------------ tables

def resnet18(sd: Dict, ref: Callable[[str], str], port: str) -> Table:
    """torchvision ResNet-18 (``conv1``, ``bn1``, ``layer{1..4}.{0,1}``,
    ``downsample`` on the first block of layers 2-4) -> ``ResNet18Features``;
    ``ref`` gives the reference module of a torchvision name."""
    t = [(ref("conv1"), _j(port, "Conv_0"), W),
         (ref("bn1"), _j(port, "BatchNorm_0"), BN)]
    for i in range(8):
        src, dst = ref(f"layer{i // 2 + 1}.{i % 2}"), _j(port,
                                                         f"BasicBlock_{i}")
        t += [(src + ".conv1", dst + ".ConvBN_0.Conv_0", W),
              (src + ".bn1", dst + ".ConvBN_0.BatchNorm_0", BN),
              (src + ".conv2", dst + ".Conv_0", W),
              (src + ".bn2", dst + ".BatchNorm_0", BN)]
        if src + ".downsample.0.weight" in sd:
            t += [(src + ".downsample.0", dst + ".Conv_1", W),
                  (src + ".downsample.1", dst + ".BatchNorm_1", BN)]
    return t


def rev_block(sd: Dict, ref: str, port: str) -> Table:
    """``RevBasicBlock``: deconv1 / bn1 / deconv2 / bn2 [+ upsample]."""
    t = [(ref + ".deconv1", port + ".Deconv_0.ConvTranspose_0", W),
         (ref + ".bn1", port + ".BatchNorm_0", BN),
         (ref + ".deconv2", port + ".Deconv_1.ConvTranspose_0", W),
         (ref + ".bn2", port + ".BatchNorm_1", BN)]
    if ref + ".upsample.0.weight" in sd:
        t += [(ref + ".upsample.0", port + ".Deconv_2.ConvTranspose_0", W),
              (ref + ".upsample.1", port + ".BatchNorm_2", BN)]
    return t


def urdecoder(sd: Dict, ref: str, port: str) -> Table:
    """A U-ResNet decoder head, ``[layer1..4, Sequential(deconv1, bn1,
    relu, deconv2)]`` -> ``URDecoder``; the first deconv of the tail has a
    bias.  ``Net_inpaint``'s shared final deconv is read under each head's
    ``4.3``."""
    t: Table = []
    for i in range(4):
        for b in range(2):
            t += rev_block(sd, f"{ref}.{i}.{b}",
                           f"{port}.RevLayer_{i}.RevBasicBlock_{b}")
    return t + [(ref + ".4.0", port + ".Deconv_0.ConvTranspose_0", WB),
                (ref + ".4.1", port + ".BatchNorm_0", BN),
                (ref + ".4.3", port + ".Deconv_1.ConvTranspose_0", W)]


def minmax_head(ref: str, port: str) -> Table:
    """MarrNet-1's ``decoder_minmax`` Sequential -> ``MinmaxHead``."""
    return [(f"{ref}.{i}", f"{port}.{name}", leaves) for i, name, leaves in (
        (0, "Conv_0", WB), (1, "Conv_1", WB), (3, "Dense_0", WB),
        (4, "BatchNorm_0", BN), (6, "Dense_1", WB), (7, "BatchNorm_1", BN),
        (9, "Dense_2", WB))]


def uresnet(sd: Dict, ref: str, port: str, names: Sequence[str],
            minmax: bool) -> Table:
    """``uresnet.Net`` / ``Net_inpaint`` / MarrNet-1 -> ``UResNet``: the
    ResNet-18 pyramid as ``encoder.0.0`` (conv1), ``encoder.0.1`` (bn1),
    ``encoder.{1..4}`` (layers), a decoder per map, the min/max head."""
    def enc(name):
        stem = {"conv1": "0.0", "bn1": "0.1"}.get(name)
        return _j(ref, "encoder." + (stem or name[len("layer"):]))
    t = resnet18(sd, enc, _j(port, "ResNet18Features_0"))
    for name in names:
        t += urdecoder(sd, _j(ref, f"decoder_{name}"),
                       _j(port, f"decoder_{name}"))
    if minmax:
        t += minmax_head(_j(ref, "decoder_minmax"),
                         _j(port, "MinmaxHead_0"))
    return t


def image_encoder(sd: Dict, ref: str, port: str) -> Table:
    """``networks.ImageEncoder``: a ResNet-18 and ``fc`` ->
    ``ResNet18Encoder``."""
    return resnet18(sd, lambda n: _j(ref, n),
                    _j(port, "ResNet18Features_0")) + [
        (_j(ref, "fc"), _j(port, "Dense_0"), WB)]


def _seq(ref: str, port: str, module: str, inner: str,
         indices: Sequence[int], leaves) -> Table:
    """Layer k of kind ``module`` at ``<ref>.<indices[k]>``."""
    return [(f"{ref}.{i}", _j(port, f"{module}_{k}", inner), leaves)
            for k, i in enumerate(indices)]


def voxel_decoder(ref: str, port: str) -> Table:
    """``networks.VoxelDecoder`` at 128³ (deconvs at ``main.0, 3, 8, 11,
    14, 17``, BatchNorms after all but the last) -> ``VoxelDecoder``."""
    return (_seq(ref, port, "Deconv3D", "ConvTranspose_0",
                 (0, 3, 8, 11, 14, 17), WB)
            + _seq(ref, port, "BatchNorm", "", (1, 4, 9, 12, 15), BN))


def voxel_generator(ref: str, port: str) -> Table:
    """``networks.VoxelGenerator`` at 128³, no biases -> ``VoxelGenerator``."""
    return (_seq(ref, port, "Deconv3D", "ConvTranspose_0",
                 (0, 3, 6, 9, 12, 15), W)
            + _seq(ref, port, "BatchNorm", "", (1, 4, 7, 10, 13), BN))


def voxel_discriminator(ref: str, port: str) -> Table:
    """``networks.VoxelDiscriminator`` at 128³: six bias-free convs at
    ``main.0, 2, ..., 10`` -> ``VoxelDiscriminator``."""
    return _seq(ref, port, "Conv3D", "Conv_0", range(0, 12, 2), W)


def unet3d(ref: str, port: str) -> Table:
    """``networks.Unet_3D``: ``enc1..6`` conv blocks, the
    ``full_conv_block`` Linear, ``dec1..6`` -> ``UNet3D`` (encoder
    BatchNorms 0-5, decoder 6-10)."""
    t: Table = []
    for i in range(6):
        t += [(_j(ref, f"enc{i + 1}.net.0"), _j(port, f"Conv3D_{i}.Conv_0"),
               WB),
              (_j(ref, f"enc{i + 1}.net.1"), _j(port, f"BatchNorm_{i}"), BN)]
    t.append((_j(ref, "full_conv_block.0"), _j(port, "Dense_0"), WB))
    for i in range(5):
        t += [(_j(ref, f"dec{i + 1}.net.0"),
               _j(port, f"Deconv3D_{i}.ConvTranspose_0"), WB),
              (_j(ref, f"dec{i + 1}.net.1"), _j(port, f"BatchNorm_{6 + i}"),
               BN)]
    return t + [(_j(ref, "dec6.net"), _j(port, "Deconv3D_5.ConvTranspose_0"),
                 WB)]


def marrnet2(sd: Dict, ref: str, port: str) -> Table:
    """``marrnet2.Net``: ``encoder.main.0`` and ``decoder.main`` ->
    ``Marrnet2Net``."""
    return (image_encoder(sd, _j(ref, "encoder.main.0"),
                          _j(port, "ResNet18Encoder_0"))
            + voxel_decoder(_j(ref, "decoder.main"),
                            _j(port, "VoxelDecoder_0")))


def depth_inpaint(sd: Dict, ref: str, port: str) -> Table:
    """GenRe's stage-2 pair: ``net1`` (MarrNet-1 with the min/max head)
    and ``net2`` (``Net_inpaint`` of the spherical map) ->
    ``DepthInpaintNet``."""
    return (uresnet(sd, _j(ref, "net1"), _j(port, "net1"), MARRNET1_MAPS,
                    True)
            + uresnet(sd, _j(ref, "net2"), _j(port, "net2"), ("spherical",),
                      False))


def net_tables(alias: str, nets: List[Dict]) -> List[Tuple[int, str, Table]]:
    """(index of the file's net, the port's net name, its table) for each
    net of model ``alias``; the names are those of the JAX tool's
    ``convert_model_nets``."""
    sd = nets[0]
    if alias == "marrnet1":
        return [(0, "net", uresnet(sd, "", "", MARRNET1_MAPS, True))]
    if alias == "marrnet2":
        return [(0, "net", marrnet2(sd, "", ""))]
    if alias == "marrnet":
        return [(0, "net", uresnet(sd, "marrnet1", "marrnet1", MARRNET1_MAPS,
                                   True) + marrnet2(sd, "marrnet2",
                                                    "marrnet2"))]
    if alias == "wgangp":
        return [(0, "net_g", voxel_generator("main", "")),
                (1, "net_d", voxel_discriminator("main", ""))]
    if alias == "shapehd":
        return [(0, "net", marrnet2(sd, "marrnet2", "")),
                (0, "net_noft", marrnet2(sd, "marrnet2_noft", "")),
                (0, "net_d", voxel_discriminator("d.main", ""))]
    if alias in ("depth_pred_with_sph_inpaint", "depth_inpaint"):
        return [(0, "net", depth_inpaint(sd, "", ""))]
    if alias in ("genre_full_model", "genre"):
        return [(0, "net", depth_inpaint(sd, "depth_and_inpaint",
                                         "depth_and_inpaint")
                 + unet3d("refine_net", "refine_net"))]
    if alias == "resnet18":
        return [(0, "net", resnet18(sd, lambda n: n, ""))]
    raise ValueError(f"no conversion table for model alias {alias!r}; "
                     f"known: {', '.join(ALIASES)}")


# ------------------------------------------------------------ conversion

def rename(sd: Dict, table: Table, read: Optional[set] = None
           ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of ``table``'s modules, from the
    reference's ``sd``; a key the table needs and ``sd`` lacks raises a
    KeyError naming it.  ``read`` collects the keys read."""
    out = {}
    for src, dst, leaves in table:
        for leaf in leaves:
            key = f"{src}.{leaf}"
            if key not in sd:
                raise KeyError(f"the reference checkpoint has no {key!r} "
                               f"(for the port's {dst}.{leaf})")
            out[f"{dst}.{leaf}"] = sd[key]
            if read is not None:
                read.add(key)
    return out


def convert_nets(alias: str, nets: List[Dict]
                 ) -> Tuple[List[Dict], List[str], List[str]]:
    """The file's ``nets`` -> (payload entries ``{params, batch_stats}``,
    net names, the keys no table read, as ``nets[i].<key>``)."""
    entries, names = [], []
    read: List[set] = [set() for _ in nets]
    for i, name, table in net_tables(alias, nets):
        params, stats = torch_to_jax(rename(nets[i], table, read[i]))
        entries.append({"params": params, "batch_stats": stats})
        names.append(name)
    unread = [f"nets[{i}].{k}" for i, sd in enumerate(nets) for k in sd
              if k not in read[i] and not k.endswith("num_batches_tracked")]
    return entries, names, unread


def param_names(sd: Dict) -> List[str]:
    """The optimisable entries of a ``state_dict``, in its order: its
    module's ``parameters()`` order."""
    return [k for k in sd if not k.endswith(BUFFERS)]


def _moments(net: Dict, opt: Dict, keep: Optional[Callable[[str], bool]]
             ) -> Tuple[Dict, Dict, int]:
    """``state_dict`` twins of ``net`` holding Adam's ``exp_avg`` and
    ``exp_avg_sq`` (zeros where the optimizer holds none: buffers,
    parameters it leaves out or never stepped) and the largest step."""
    names = [k for k in param_names(net) if keep is None or keep(k)]
    ids = [pid for g in opt.get("param_groups", []) for pid in g["params"]]
    if len(ids) != len(names):
        raise ValueError(f"the optimizer covers {len(ids)} parameters, the "
                         f"net's state_dict has {len(names)} it optimises")
    mu = {k: torch.zeros_like(v) for k, v in net.items()}
    nu = dict(mu)
    count = 0
    state = opt.get("state", {})
    for name, pid in zip(names, ids):
        st = state.get(pid) or state.get(str(pid))
        if not st:                       # never stepped (torch's lazy state)
            continue
        mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        count = max(count, int(st["step"]))
    return mu, nu, count


def convert_optimizers(alias: str, payload: Dict, nets: List[Dict]
                       ) -> Tuple[List[Tuple], List[str]]:
    """The file's Adam states -> optax ``(ScaleByAdamState, EmptyState)``
    per optimizer, and their names.  WGAN-GP has one for each net;
    ShapeHD's and MarrNet's cover ``marrnet2.*`` alone (the rest of
    MarrNet keeps zero moments); the others the whole net."""
    opts = payload.get("optimizers") or []
    if not opts:
        return [], []
    tables = net_tables(alias, nets)

    def adam(i, table, keep=None):
        mu, nu, count = _moments(nets[i], opts[i], keep)
        return (ScaleByAdamState(np.asarray(count, np.int32),
                                 torch_to_jax(rename(mu, table))[0],
                                 torch_to_jax(rename(nu, table))[0]),
                EmptyState())

    if alias == "wgangp":
        return [adam(i, table) for i, _, table in tables], ["net_g", "net_d"]
    keep = (lambda k: k.startswith("marrnet2.")) \
        if alias in ("shapehd", "marrnet") else None
    return [adam(0, tables[0][2], keep)], ["net"]


def convert_checkpoint(alias: str, payload: Any
                       ) -> Tuple[Dict[str, Any], List[str]]:
    """A loaded reference file -> (this package's checkpoint payload, the
    keys no table read).  ``resnet18``: a torchvision ``state_dict``, whose
    payload is the ``ResNet18Features`` net alone (``--backbone_init``)."""
    if alias == "resnet18":
        entries, _, unread = convert_nets(alias, [payload])
        return {"nets": entries, "optimizers": [], "epoch": 0,
                "loss_eval": 0.0}, unread
    nets = list(payload.get("nets", [payload]))
    entries, net_names, unread = convert_nets(alias, nets)
    opts, opt_names = convert_optimizers(alias, payload, nets)
    return {"nets": entries, "optimizers": opts, "net_names": net_names,
            "opt_names": opt_names, "epoch": payload.get("epoch", 0),
            "loss_eval": float(payload.get("loss_eval", 0.0))}, unread
