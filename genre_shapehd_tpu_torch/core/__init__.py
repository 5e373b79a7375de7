"""Registries, checkpoints in the JAX package's format, weight
conversion, device selection."""

from .registry import get_model, get_dataset, model_aliases, dataset_aliases
from .checkpoint import save_checkpoint, load_checkpoint, resume_path

__all__ = ["get_model", "get_dataset", "model_aliases", "dataset_aliases",
           "save_checkpoint", "load_checkpoint", "resume_path"]
