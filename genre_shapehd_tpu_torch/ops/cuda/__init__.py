"""Hand-written CUDA kernels (sources in ``genre_shapehd_tpu_torch/csrc``)
and their Python wrappers.  Nothing here compiles or loads a kernel at
import time."""
