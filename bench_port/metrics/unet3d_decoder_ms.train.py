"""Device ms per training step of the 3D U-Net's decoder, forward and
backward (``genre.refine.decoder``, ``genre.refine.decoder.backward``),
K3 included."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.refine.decoder",
                             "genre.refine.decoder.backward"))
