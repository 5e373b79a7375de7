"""Training: the model state in checkpoints, the loop and its loggers
(counterpart of ``genre_shapehd_tpu/train``).  The JAX package's
``ModelState`` pytree has no counterpart: the port keeps the state in the
model's ``nn.Module``s and ``torch.optim`` optimizers."""

from .loop import Trainer
from . import loggers

__all__ = ["Trainer", "loggers"]
