"""Device ms per training step of GenRe's 3D U-Net, forward and backward
(``genre.refine``, ``genre.refine.backward``), K3 included."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.refine", "genre.refine.backward"))
