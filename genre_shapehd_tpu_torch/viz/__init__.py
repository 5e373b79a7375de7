"""Visualization: iso-surface meshes and images of a prediction
(counterpart of ``genre_shapehd_tpu/viz``)."""

from .mcubes import marching_cubes
from .visualizer import Visualizer, save_iso_obj, write_obj

__all__ = ["marching_cubes", "Visualizer", "save_iso_obj", "write_obj"]
