"""ShapeNet status-file dataset (counterpart of
``genre_shapehd_tpu/data/shapenet.py``).

A line-aligned set of status files under ``<data_root>/status`` lists
every item (``items_all.txt``), whether it is a training item
(``is_train.txt``) and which modalities exist for it (one file per
modality of :data:`STATUS_AND_SUFFIX`); a sample keeps only the items of
the chosen classes whose required modalities are all present.
Modalities load by suffix: PNGs divided by their dtype's maximum (8- or
16-bit), ``.npy`` depth min/max, ``_128.npz`` voxels, ``_spherical.npz``
object and depth spherical maps (each with a leading 1-channel), ``.mat``
canonical voxels shared by every view of an item.  Images stay
channel-last; voxels are (X, Y, Z).

Train-time augmentation draws from a generator seeded by
``(--manual_seed, pass, index, train)``, the pass being the loader's
(``set_epoch``), as in ``data/procedural.py``: each pass over the views
draws anew, as the JAX loader's unseeded generator does.
"""

from __future__ import annotations

import random
from os.path import join
from typing import Dict, List

import numpy as np
from scipy.io import loadmat

from . import preprocess as pp

STATUS_AND_SUFFIX = {
    "rgb": {"status": "rgb.txt", "suffix": "_rgb.png"},
    "depth": {"status": "depth.txt", "suffix": "_depth.png"},
    "depth_minmax": {"status": "depth_minmax.txt", "suffix": ".npy"},
    "silhou": {"status": "silhou.txt", "suffix": "_silhouette.png"},
    "normal": {"status": "normal.txt", "suffix": "_normal.png"},
    "voxel": {"status": "vox_rot.txt",
              "suffix": "_gt_rotvox_samescale_128.npz"},
    "spherical": {"status": "spherical.txt", "suffix": "_spherical.npz"},
    "voxel_canon": {"status": "vox_canon.txt",
                    "suffix": "_voxel_normalized_128.mat"},
}

_ALL_SYNSETS = (
    "02691156+02747177+02773838+02801938+02808440+02818832+02828884"
    "+02843684+02871439+02876657+02880940+02924116+02933112+02942699"
    "+02946921+02954340+02958343+02992529+03001627+03046257+03085013"
    "+03207941+03211117+03261776+03325088+03337140+03467517+03513137"
    "+03593526+03624134+03636649+03642806+03691459+03710193+03759954"
    "+03761084+03790512+03797390+03928116+03938244+03948459+03991062"
    "+04004475+04074963+04090263+04099429+04225987+04256520+04330267"
    "+04379243+04401088+04460130+04468005+04530566+04554684"
)


def _all_but(synset: str) -> str:
    return "+".join(s for s in _ALL_SYNSETS.split("+") if s != synset)


CLASS_ALIASES = {
    "drc": "03001627+02691156+02958343",
    "chair": "03001627", "table": "04379243", "sofa": "04256520",
    "couch": "04256520", "cabinet": "03337140", "bed": "02818832",
    "plane": "02691156", "car": "02958343", "bench": "02828884",
    "monitor": "03211117", "lamp": "03636649", "speaker": "03691459",
    "firearm": "03948459+04090263", "cellphone": "02992529+04401088",
    "watercraft": "04530566", "hat": "02954340", "pot": "03991062",
    "rocket": "04099429", "train": "04468005", "bus": "02924116",
    "pistol": "03948459", "faucet": "03325088", "helmet": "03513137",
    "clock": "03046257", "phone": "04401088", "display": "03211117",
    "vessel": "04530566", "rifle": "04090263",
    "small": ("03001627+04379243+02933112+04256520+02958343+03636649"
              "+02691156+04530566"),
    "all": _ALL_SYNSETS,
    "all-but-table": _all_but("04379243"),
    "all-but-chair": _all_but("03001627"),
}

CLASS_LIST = _ALL_SYNSETS.split("+")


def expand_classes(classes: str) -> List[str]:
    """``--classes`` ('+'-joined aliases or synset ids) -> sorted synsets."""
    out: List[str] = []
    for c in str(classes).split("+"):
        out += CLASS_ALIASES[c].split("+") if c in CLASS_ALIASES else [c]
    return sorted(set(out))


class Dataset:
    @classmethod
    def add_arguments(cls, parser):
        parser.add_argument(
            "--data_root", type=str,
            default="./downloads/data/shapenet",
            help="ShapeNet render root containing the status/ directory")
        return parser, set()

    def __init__(self, opt, mode: str = "train", model=None):
        assert mode in ("train", "vali")
        self.mode = mode
        self.data_root = getattr(opt, "data_root",
                                 "./downloads/data/shapenet")
        self.list_root = join(self.data_root, "status")
        self.seed = getattr(opt, "manual_seed", None) or 0
        self.epoch = 0
        if model is None:
            required: List[str] = ["rgb"]
            self.preprocess = None
        else:
            required = list(model.requires)
            self.preprocess = model.preprocess
        classes = expand_classes(getattr(opt, "classes", "chair"))

        item_list = self._read_lines("items_all.txt")
        is_train = self._read_bool("is_train.txt")
        assert len(item_list) == len(is_train)
        has: Dict[str, List[bool]] = {}
        for data_type in required:
            assert data_type in STATUS_AND_SUFFIX, \
                f"{data_type} required but unknown"
            has[data_type] = self._read_bool(
                STATUS_AND_SUFFIX[data_type]["status"])
            assert len(has[data_type]) == len(item_list)

        samples = []
        for i, item in enumerate(item_list):
            class_id = item.split("/")[0]
            if ((mode == "train") == is_train[i]) and class_id in classes:
                sample = {"item": join(self.data_root, item)}
                for data_type in required:
                    suffix = STATUS_AND_SUFFIX[data_type]["suffix"]
                    # canonical voxels belong to the model, not the view
                    base = (item.split("_view")[0]
                            if data_type == "voxel_canon" else item)
                    sample[data_type + "_path"] = (
                        join(self.data_root, base + suffix)
                        if has[data_type][i] else None)
                if None not in sample.values():
                    samples.append(sample)
        if mode == "vali":
            # a fixed shuffle puts a bit of every class in each eval batch
            random.Random(self.seed).shuffle(samples)
        self.samples = samples

    def _read_lines(self, name: str) -> List[str]:
        """The lines of a status file; the text after its last newline
        is dropped."""
        with open(join(self.list_root, name)) as f:
            return f.read().split("\n")[:-1]

    def _read_bool(self, name: str) -> List[bool]:
        return [x == "True" for x in self._read_lines(name)]

    def __len__(self):
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        """The loader's pass number, which seeds the augmentation."""
        self.epoch = epoch

    def __getitem__(self, i: int) -> Dict:
        out: Dict = {}
        for k, v in self.samples[i].items():
            out[k] = v
            if not k.endswith("_path") or v is None:
                continue
            if v.endswith(".png"):
                out[k[:-5]] = pp.imread_rgb(v)
            elif v.endswith(".npy"):
                out["depth_minmax"] = np.load(v)
            elif v.endswith("_128.npz"):
                with np.load(v) as z:
                    out["voxel"] = z["voxel"].astype(np.float64)
            elif v.endswith("_spherical.npz"):
                with np.load(v) as z:
                    out["spherical_object"] = z["obj_spherical"][None, ...]
                    out["spherical_depth"] = z["depth_spherical"][None, ...]
            elif v.endswith(".mat"):
                out["voxel_canon"] = loadmat(v)["voxel"].astype(np.float64)
            else:
                raise NotImplementedError(v)
        if self.preprocess is not None:
            aug = np.random.default_rng(
                [self.seed, self.epoch, i, int(self.mode == "train")])
            out = self.preprocess(out, mode=self.mode, rng=aug)
        for k, v in out.items():
            if isinstance(v, np.ndarray) and v.dtype != np.float32:
                out[k] = v.astype(np.float32)
        return out
