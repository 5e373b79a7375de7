"""Model / dataset registries (counterpart of
``genre_shapehd_tpu/core/registry.py``): the same aliases."""

from __future__ import annotations

import importlib
from typing import Dict, Type

_MODEL_MODULES: Dict[str, str] = {
    "marrnet1": "genre_shapehd_tpu_torch.models.marrnet1",
    "depth_pred_with_sph_inpaint":
        "genre_shapehd_tpu_torch.models.depth_inpaint",
    "genre_full_model": "genre_shapehd_tpu_torch.models.genre_full",
    "marrnet2": "genre_shapehd_tpu_torch.models.marrnet2",
    "marrnet": "genre_shapehd_tpu_torch.models.marrnet",
    "wgangp": "genre_shapehd_tpu_torch.models.wgangp",
    "shapehd": "genre_shapehd_tpu_torch.models.shapehd",
}

_DATASET_MODULES: Dict[str, str] = {
    "test": "genre_shapehd_tpu_torch.data.testset",
    "synthetic": "genre_shapehd_tpu_torch.data.synthetic",
    "procedural": "genre_shapehd_tpu_torch.data.procedural",
    "shapenet": "genre_shapehd_tpu_torch.data.shapenet",
}


def get_model(alias: str, test: bool = False) -> Type:
    """The Model (or ModelTest) class registered under ``alias``."""
    if alias not in _MODEL_MODULES:
        raise KeyError(f"unknown or unported model '{alias}'; available: "
                       f"{sorted(_MODEL_MODULES)}")
    mod = importlib.import_module(_MODEL_MODULES[alias])
    return getattr(mod, "ModelTest" if test else "Model")


def get_dataset(alias: str) -> Type:
    if alias not in _DATASET_MODULES:
        raise KeyError(f"unknown or unported dataset '{alias}'; available: "
                       f"{sorted(_DATASET_MODULES)}")
    return getattr(importlib.import_module(_DATASET_MODULES[alias]),
                   "Dataset")


def model_aliases():
    return sorted(_MODEL_MODULES)


def dataset_aliases():
    return sorted(_DATASET_MODULES)
