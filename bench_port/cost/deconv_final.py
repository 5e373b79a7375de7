"""``ConvTranspose3d(Cin -> 1, k=4, s=2, p=1)`` plus bias, the function
that K3 (``deconv_final``) computes, for its roofline: x (B, Cin, S, S, S)
and the output (B, 1, 2S, 2S, 2S) in the compute dtype, the weight
(Cin, 1, 4, 4, 4) and the bias in float32, each byte counted once.
Every output takes 8 taps of each input channel: 16 Cin operations."""

from cost.peaks import FLOPS, HBM_BYTES_PER_S

ELT = {"bfloat16": 2, "float32": 4}


def cost(b: int, cin: int, s: int, dtype: str = "bfloat16"):
    """(bytes, operations) of one call."""
    e = ELT[dtype]
    nbytes = b * cin * s ** 3 * e + cin * 64 * 4 + 4 + b * (2 * s) ** 3 * e
    return nbytes, 16 * cin * b * (2 * s) ** 3


def bound_s(b: int, cin: int, s: int, dtype: str = "bfloat16") -> float:
    """The least seconds the H100 could take for the call."""
    nbytes, ops = cost(b, cin, s, dtype)
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS[dtype])
