"""The bounds ``chip_smoke.py`` holds a bf16 K3 result to at the shapes
the tensor-core tiling refuses: within 1e-2 of the scale of the plain
version at most and 1e-3 on average, and within half a bf16 step at the
largest magnitude, u = 2^-8 of it, of the float32 result.  The 1e-2
bound is waived only where the plain version itself lies more than 1.5 u
from the float32 result."""

import pytest

from chip_smoke import k3_bf16_within

SCALE = EXACT = 4.0
U = 2.0 ** -8 * EXACT


@pytest.mark.parametrize("d_max,d_mean,e,e_plain,ok,waived", [
    # kernel and plain version both near the float32 result
    (0.5e-2 * SCALE, 1e-4, 0.4 * U, 0.6 * U, True, False),
    # far from the plain version while that lies within 1.5 u of the
    # float32 result: the 1e-2 bound holds and fails
    (2e-2 * SCALE, 1e-4, 0.4 * U, 1.4 * U, False, False),
    # the plain version 3 u off: the 1e-2 bound is waived, the kernel is
    # within 1 u
    (2e-2 * SCALE, 1e-4, 1.0 * U, 3.0 * U, True, True),
    # waived, but the kernel itself is more than 1 u off
    (2e-2 * SCALE, 1e-4, 1.2 * U, 3.0 * U, False, True),
    # the mean bound is never waived
    (2e-2 * SCALE, 2e-3 * SCALE, 0.4 * U, 3.0 * U, False, True),
])
def test_k3_bf16_bounds(d_max, d_mean, e, e_plain, ok, waived):
    assert k3_bf16_within(d_max, d_mean, e, e_plain, SCALE, EXACT) == (
        ok, waived)
