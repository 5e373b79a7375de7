"""Host-side data: PNG I/O, test-time preprocessing, the glob test
dataset, the synthetic, procedural and ShapeNet datasets and the batched
loader."""

from . import preprocess
from .loader import DataLoader, InfiniteLoader, collate

__all__ = ["preprocess", "DataLoader", "InfiniteLoader", "collate"]
