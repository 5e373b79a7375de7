"""Device ms per batch of the upload of an inference batch's photos from
the host (``genre.upload``, ``marrnet.upload``, ``shapehd.upload``: the
conversions at the top of each ``predict_step``)."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.upload", "marrnet.upload",
                             "shapehd.upload"))
