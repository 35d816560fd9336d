"""Port stencil operator (petiga_tpu_torch.sparse.spmv) against the JAX
package's PallasStencilOperator (interpret mode on the CPU), on the same
seeded data carried across by petiga_tpu_torch.interop.  Tolerance:
rel <= 1e-12 in f64 (the two sum the same products in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petiga_tpu.sparse.pallas_spmv import PallasStencilOperator
from petiga_tpu.sparse.stencil import Stencil as JStencil
from petiga_tpu.sparse.stencil import StencilMatrix, SymmetricStencilMatrix
from petiga_tpu_torch import interop
from petiga_tpu_torch.interop import random_stencil_data
from petiga_tpu_torch.sparse import spmv
from petiga_tpu_torch.sparse.stencil import halo_pad, stencil_apply

RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


# (name, node_shape, widths, periodic, dof, sym, force_kind)
CASES = [
    ("3d-open", (6, 5, 4), (1, 2, 1), (False,) * 3, 1, False, None),
    ("2d-periodic", (7, 6), (1, 2), (True, True), 1, False, None),
    ("2d-mixed-dof2", (7, 6), (1, 1), (True, False), 2, False, None),
    ("2d-dof3", (5, 4), (1, 1), (False, False), 3, False, None),
    ("3d-sym-dof1", (5, 4, 6), (1, 1, 1), (False,) * 3, 1, True, None),
    ("2d-sym-dof2", (6, 5), (1, 1), (False, False), 2, True, None),
    ("2d-periodic-dof4", (6, 5), (1, 1), (True, False), 4, False, None),
    ("2d-sym-dof4", (5, 6), (1, 1), (False, False), 4, True, None),
    ("3d-sym-dof3", (4, 5, 4), (1, 1, 1), (False,) * 3, 3, True, None),
    ("2d-multichunk", (132, 130), (1, 1), (False, False), 1, False, None),
    ("3d-hbm", (6, 6, 6), (1, 1, 1), (False,) * 3, 1, False, "hbm"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_operator_matches_pallas(case):
    name, shape, widths, per, dof, sym, force = case
    jst = JStencil(node_shape=shape, widths=widths, periodic=per, dof=dof)
    data = random_stencil_data(jst, len(name), symmetric=sym)
    if sym:
        jop = PallasStencilOperator.from_symmetric(
            SymmetricStencilMatrix(jst, jnp.asarray(data)), interpret=True)
    else:
        jop = PallasStencilOperator(StencilMatrix(jst, jnp.asarray(data)),
                                    interpret=True, force_kind=force)
    assert jop.kind == ("sym" if sym else force or "vmem")
    op = interop.operator_from_jax_planes(jst, np.asarray(jop.DT), align=jop.align,
                                          symmetric=sym, device="cpu")
    op2 = interop.operator_from_stencil_data(jst, data, symmetric=sym, device="cpu")
    assert op.kind == ("sym" if sym else "full")
    assert torch.equal(op.DT, op2.DT)

    rng = np.random.default_rng(7)
    x = rng.normal(size=(jst.nnodes, dof))
    xt = torch.as_tensor(x)
    y_ref = np.asarray(jop.matvec(jnp.asarray(x)))
    assert _rel(op.matvec(xt).numpy(), y_ref) <= RTOL
    # packed in, packed out: the interior and the re-wrapped periodic
    # halos are those of the packed reference product; guards stay zero
    ybt = op.matvec_xb(op.DT, op.pack_vec(xt))
    assert _rel(ybt.numpy(), op.pack_vec(torch.tensor(y_ref)).numpy()) <= RTOL
    assert _rel(op.diagonal().numpy(), jop.diagonal()) <= RTOL
    assert _rel(op.scalar_diagonal().numpy(), jop.scalar_diagonal()) <= RTOL
    dinv = jop.unpack_vec(jop.packed_diag_inv())
    assert _rel(op.unpack_vec(op.packed_diag_inv()).numpy(), dinv) <= RTOL

    if not sym:  # the port's own slot-loop reference
        N_rev = tuple(shape[::-1])
        xg = halo_pad(xt.reshape(N_rev + (dof,)), widths, per)
        y_own = stencil_apply(torch.as_tensor(data).reshape(N_rev + (jst.K, dof, dof)),
                              xg, widths, jst.slot_offsets())
        assert _rel(y_own.reshape(-1, dof).numpy(), y_ref) <= RTOL


def test_plain_path_does_not_count_launches():
    st = JStencil(node_shape=(5, 4), widths=(1, 1), periodic=(False, False), dof=1)
    op = interop.operator_from_stencil_data(st, random_stencil_data(st, 0), device="cpu")
    before = dict(spmv.LAUNCHES)
    op.matvec(torch.ones(st.nnodes, 1, dtype=torch.float64))
    assert spmv.LAUNCHES == before


def test_wrapper_rejects_bad_arguments():
    st = JStencil(node_shape=(5, 4), widths=(1, 1), periodic=(False, False), dof=1)
    op = interop.operator_from_stencil_data(st, random_stencil_data(st, 0), device="cpu")
    xb = op.pack_vec(torch.ones(st.nnodes, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        spmv.stencil_spmv_full(op.DT, xb[:, 1:], op._shift_t, op.G)
    with pytest.raises(TypeError):
        spmv.stencil_spmv_full(op.DT, xb.float(), op._shift_t, op.G)
    with pytest.raises(ValueError):
        spmv.stencil_spmv_full(op.DT[:-1], xb, op._shift_t, op.G)


@pytest.mark.parametrize("dof", [1, 2])
def test_ext_pads_block_matches_pallas(dof):
    """A rank's halo-extended block (``ext_pads``, the distributed
    layer's layout): planes, ``pack_ext``, the product and
    ``packed_mask`` against ``PallasStencilOperator(ext_pads=)``."""
    shape, widths = (5, 4), (1, 2)
    pads = tuple((p, p) for p in widths)
    jst = JStencil(node_shape=shape, widths=widths, periodic=(False, False), dof=dof)
    tst = interop.as_stencil(jst)
    data = random_stencil_data(jst, 7 + dof)  # (nnodes, K, dof, dof)
    grid = data.reshape(shape[::-1] + (-1,))
    ext = tuple(n + 2 * p for n, p in zip(shape, widths))
    x_ext = np.random.default_rng(dof).normal(size=ext[::-1] + (dof,))
    jop = PallasStencilOperator(stencil=jst, dtype=jnp.float64, interpret=True, ext_pads=pads)
    y_ref = jop._unpack_y(jop._kernel(jop.pack_planes(jnp.asarray(grid)),
                                      jop.pack_ext(jnp.asarray(x_ext))))
    op = spmv.StencilOperator(tst, dtype=torch.float64, device="cpu", ext_pads=pads)
    assert op.Ne == ext and op.next == int(np.prod(ext))
    DT = op.pack_planes(torch.as_tensor(grid))
    y = op.unpack_vec(op._kernel(DT, op.pack_ext(torch.as_tensor(x_ext))))
    assert _rel(y.numpy(), y_ref) <= RTOL
    # the kernel's plain version on this layout, called directly
    yb = torch.zeros_like(op.pack_ext(torch.as_tensor(x_ext)))
    spmv._spmv_full_plain(DT, op.pack_ext(torch.as_tensor(x_ext)), op.shifts, op.G, yb)
    assert _rel(op.unpack_vec(yb).numpy(), y_ref) <= RTOL
    jm = np.asarray(jop.packed_mask()).reshape(dof, -1)[:, jop.G * 128: jop.G * 128 + jop.next]
    tm = op.packed_mask()
    np.testing.assert_array_equal(tm[:, op.G:op.G + op.next].numpy(), jm)
    assert float(tm[:, :op.G].abs().sum() + tm[:, op.G + op.next:].abs().sum()) == 0.0
