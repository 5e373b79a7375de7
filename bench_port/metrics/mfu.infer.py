"""Model operations per iteration (the reference's, counted by
``torch.utils.flop_counter``, plus the hand-written kernels' by their
roofline formulas; no recomputation) over the iteration's unprofiled
time, as a share of the H100's dense peak for the compute type."""

from metrics._read import mfu


def read(summary):
    return mfu(summary)
