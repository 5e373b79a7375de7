"""Device ms per training step of GenRe's camera and spherical
backprojections, forward and backward (``genre.camera_bp``,
``genre.spherical_bp`` and their ``.backward`` spans)."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.camera_bp", "genre.spherical_bp",
                             "genre.camera_bp.backward",
                             "genre.spherical_bp.backward"))
