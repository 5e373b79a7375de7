"""The spherical renderer as a function, for its roofline: the (B, V,
V, V) float32 volume and the sampling grid in, the (B, R, R) float32
expected-depth map out, each byte counted once.  The intermediate of
its two stages (c, (B, R, M, V)) is no input or output of the function,
so a renderer that never writes it reads as a gain and never above
100 %.

The grid is the four tables of taps the renderer reads: for each of the
R x M (theta, rho) columns the first x and y rows and their two weights,
for each of the R x S (phi, sample) columns the first z and rho rows and
their two weights, an int32 and two float32 each.

Operations: every value of c takes four products and sums (8 operations),
every ray sample four more (8) and its share of the first-hit epilogue
(clip, 1 - p, the running product, the weighted sum: 6)."""

from cost.peaks import FLOPS, HBM_BYTES_PER_S

RHO_RES = 192


def cost(b: int, v: int, r: int, z: int, m: int = RHO_RES):
    """(bytes, operations) of one call on a batch of ``b``."""
    grid = (2 * r * m + 2 * r * z) * (4 + 8)
    nbytes = b * v ** 3 * 4 + grid + b * r * r * 4
    ops = 8 * b * r * m * v + 14 * b * r * r * z
    return nbytes, ops


def bound_s(b: int, v: int, r: int, z: int, m: int = RHO_RES,
            dtype: str = "bfloat16") -> float:
    """The least seconds the H100 could take for the call."""
    nbytes, ops = cost(b, v, r, z, m)
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS[dtype])
