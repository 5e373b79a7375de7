"""The roofline formulas pinned at each cell's shapes (``PERF.md``
prints these values)."""

import pytest

from cost import deconv_final, render


def test_renderer_at_genres_shapes():
    assert render.cost(128, 128, 128, 256) == (1083506688, 10737418240)
    assert render.bound_s(128, 128, 128, 256) == pytest.approx(
        323.435e-6, rel=1e-4)
    # the volume, the four tap tables, the map
    assert render.cost(1, 128, 128, 256) == (
        128 ** 3 * 4 + (2 * 128 * 192 + 2 * 128 * 256) * 12 + 128 ** 2 * 4,
        8 * 128 * 192 * 128 + 14 * 128 * 128 * 256)


@pytest.mark.parametrize("shape, nbytes, us", [
    ((128, 40, 64), 3221235716, 961.563),     # GenRe's dec6, inference
    ((96, 40, 64), 2415929348, 721.173),      # GenRe's dec6, training
    ((128, 32, 64), 2684362756, 801.302),     # MarrNet-2's last layer
])
def test_k3_at_the_cells_shapes(shape, nbytes, us):
    got_bytes, ops = deconv_final.cost(*shape)
    assert got_bytes == nbytes
    assert ops == 16 * shape[1] * shape[0] * (2 * shape[2]) ** 3
    assert deconv_final.bound_s(*shape) == pytest.approx(us * 1e-6,
                                                         rel=1e-4)


def test_float32_k3_is_bound_by_its_operations():
    nbytes, ops = deconv_final.cost(8, 40, 64, "float32")
    assert deconv_final.bound_s(8, 40, 64, "float32") == pytest.approx(
        ops / 67e12)
