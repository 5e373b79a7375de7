"""Device ms per training step of Adam's update and of the gradients'
zeroing before the step (``genre.optimizer``, ``genre.zero_grad``)."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.optimizer", "genre.zero_grad"))
