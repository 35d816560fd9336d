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


def test_block_bound_of_the_four_card_cell():
    """One rank's 514 x 257 x 257 block of 125 full planes: 5.147 ms."""
    got = 1e3 * stencil_bound_s(125, 514 * 257 * 257, 1, 4, False)
    assert abs(got - 5.147) <= 0.0005 * 5.147, got


def test_full_roofline_counts_one_plus_iterations_products():
    """Two solves of 9 and 4 iterations make 15 products; the kernel's
    device seconds over them against the bound."""
    from pathlib import Path
    from types import SimpleNamespace

    from portbench.harness import Spec

    spec = Spec(Path(__file__).resolve().parents[2])
    read = spec.reader("stencil_spmv_full_roofline.dist_solve")
    run = SimpleNamespace(
        info={"kernel": "stencil_spmv_full", "bound_s": 2e-3},
        counters={"krylov_iters": [9, 4]},
        trace={"ops": {"void stencil_spmv_full<float, 1>(...)": [0.06, 105],
                       "void stencil_spmv_sym<float, 1>(...)": [9.0, 1]}})
    assert abs(read(run) - 100 * 2e-3 * 15 / 0.06) < 1e-9
    run.trace = None
    assert read(run) is None
