"""Device ms per training step of MarrNet-2, forward and backward
(``marrnet.marrnet2``, ``marrnet.marrnet2.backward``), K3 included."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("marrnet.marrnet2", "marrnet.marrnet2.backward"))
