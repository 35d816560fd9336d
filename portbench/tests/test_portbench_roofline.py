"""The frozen stencil bound reproduces the bounds of the port's kernel
table (PERF.md): 1.333 ms (256³, 63 symmetric planes), 0.3332 ms (128³,
125 full planes), 2.604 ms (256³, 125 full planes), all float32."""

import pytest

from portbench.roofline import stencil_bound_s


@pytest.mark.parametrize("nel, nplanes, sym, ms", [
    (256, 63, True, 1.333), (128, 125, False, 0.3332), (256, 125, False, 2.604)])
def test_bound(nel, nplanes, sym, ms):
    got = 1e3 * stencil_bound_s(nplanes, (nel + 2) ** 3, 1, 4, sym)
    assert abs(got - ms) <= 0.0005 * ms, got
