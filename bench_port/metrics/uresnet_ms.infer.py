"""Device ms per batch of the 2D nets: GenRe's net1 and net2, MarrNet-1
(``nn/uresnet.py``, ``nn/resnet.py``), by the spans the models open."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.net1", "genre.net2",
                             "marrnet.marrnet1"))
