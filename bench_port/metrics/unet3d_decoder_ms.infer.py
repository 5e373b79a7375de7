"""Device ms per batch of the 3D U-Net's decoder: the transposed
convolutions from the bottleneck to the logits, K3 included
(``genre.refine.decoder``, ``nn/unet3d.py``)."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.refine.decoder",))
