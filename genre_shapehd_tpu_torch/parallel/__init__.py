"""Data parallelism across processes (counterpart of
``genre_shapehd_tpu/parallel/``): see :mod:`.mesh`."""

from . import mesh

__all__ = ["mesh"]
