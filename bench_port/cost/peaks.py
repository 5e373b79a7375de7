"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense,
at the card's full 700 W): the rates every roofline and ``mfu`` of the
benchmark divides by."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float32": 67e12}
