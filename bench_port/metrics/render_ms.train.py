"""Device ms per training step of the spherical renderer, forward (K1,
K2) and backward (K1 again, K5) (``genre.render``,
``genre.render.backward``)."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.render", "genre.render.backward"))
