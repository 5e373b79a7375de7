"""The critic's stem, ``leaky_relu(conv3d(v, W, stride 2, padding 1),
0.2)`` from one channel to 64 (k4, no bias), the function that K6
(``critic_stem``) computes, and its input gradient, for their roofline:
v (B, 1, R, R, R) float32 in and y (B, 64, R/2, R/2, R/2) out in the
compute dtype; backward, y's gradient g and y (for the activation's
slope) in and v's float32 gradient out; the weight (64, 1, 4, 4, 4)
float32 in, once each way.  Each byte counted once.  Every output of
the convolution takes 64 products and sums (128 operations), and so does
every output of its transpose, counted by the 64-channel side."""

from cost.peaks import FLOPS, HBM_BYTES_PER_S

ELT = {"bfloat16": 2, "float32": 4}
COUT = 64


def cost(b: int, r: int, dtype: str = "bfloat16"):
    """((bytes, operations) of the forward, of the backward) of one
    call at a batch of ``b`` and a grid of ``r``."""
    v = b * r ** 3 * 4
    y = b * COUT * (r // 2) ** 3 * ELT[dtype]
    w = COUT * 64 * 4
    ops = 128 * b * COUT * (r // 2) ** 3
    return (v + w + y, ops), (2 * y + w + v, ops)


def bound_s(b: int, r: int, dtype: str = "bfloat16") -> float:
    """The least seconds the H100 could take for the forward and the
    backward of one call."""
    return sum(max(nbytes / HBM_BYTES_PER_S, ops / FLOPS[dtype])
               for nbytes, ops in cost(b, r, dtype))
