"""K3 (``deconv_final``): the function's least time on the H100 at each
call's shape (``cost/deconv_final.py``) over the kernels' device time."""

from metrics._read import deconv_final_roofline


def read(summary):
    return deconv_final_roofline(summary)
