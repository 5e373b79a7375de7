"""Device ms per training step of GenRe's two U-ResNets, forward and
backward (``genre.net1``, ``genre.net2`` and their ``.backward`` spans;
``nn/uresnet.py``, ``nn/resnet.py``, ``nn/revresnet.py``)."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.net1", "genre.net2",
                             "genre.net1.backward", "genre.net2.backward"))
