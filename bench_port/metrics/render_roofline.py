"""The spherical renderer: the function's least time on the H100
(``cost/render.py``: volume and grid in, depth map out, each byte once)
over the ``genre.render`` span's length on the device."""

from metrics._read import render_roofline


def read(summary):
    return render_roofline(summary)
