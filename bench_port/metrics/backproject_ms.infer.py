"""Device ms per batch of GenRe's camera and spherical backprojections
(``ops/camera_bp.py``, ``ops/spherical_bp.py``)."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.camera_bp", "genre.spherical_bp"))
