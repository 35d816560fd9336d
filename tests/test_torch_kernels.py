"""The port's CUDA stencil kernels against their plain PyTorch versions,
and the build/launch plumbing around them.  This file imports neither jax
nor petiga_tpu, so the card-only tests also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Kernel tolerances: f64 rel 1e-12, f32 rel 1e-5 (same products, another
summation order)."""

import numpy as np
import pytest
import torch

from petiga_tpu_torch import interop
from petiga_tpu_torch.interop import random_stencil_data
from petiga_tpu_torch.sparse import _build, spmv
from petiga_tpu_torch.sparse.stencil import Stencil


# (node_shape, widths, periodic, dof, sym)
KERNEL_CASES = [
    ((8, 8, 8), (2, 2, 2), (False,) * 3, 1, False),
    ((7, 7), (2, 2), (True, False), 2, False),
    ((5, 6), (1, 1), (False, True), 3, False),
    ((23,), (3,), (False,), 1, False),
    ((8, 7, 9), (2, 2, 2), (False,) * 3, 1, True),
    ((7, 6), (2, 2), (False, False), 2, True),
    ((6, 7, 5), (2, 2, 2), (False,) * 3, 3, False),
    ((6, 7, 5), (2, 2, 2), (False,) * 3, 3, True),
    ((6, 7, 5), (2, 2, 2), (False,) * 3, 4, False),
    ((6, 7, 5), (2, 2, 2), (False,) * 3, 4, True),
    ((7, 6), (2, 2), (True, False), 4, False),
    ((7, 7), (2, 2), (True, True), 3, False),  # nsk, shallow water
    ((7, 7), (2, 2), (True, True), 2, False),  # pattern formation, PFC
    ((17,), (1,), (False,), 2, False),  # two-phase flow
    ((11, 11), (3, 3), (False, False), 1, False),  # the Kirchhoff plate
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_matches_plain(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stencil kernels have no CPU mode")
    shape, widths, per, dof, sym = case
    st = Stencil(node_shape=shape, widths=widths, periodic=per, dof=dof)
    data = random_stencil_data(st, 3, symmetric=sym)
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(st.nnodes, dof)), dtype=dtype)
    kind = "sym" if sym else "full"
    outs = []
    for dev in ("cpu", "cuda"):
        op = interop.operator_from_stencil_data(st, data, symmetric=sym, device=dev,
                                                dtype=dtype)
        before = spmv.LAUNCHES[kind]
        y = op.matvec_xb(op.DT, op.pack_vec(x.to(dev)))
        assert spmv.LAUNCHES[kind] == before + (dev == "cuda")
        outs.append(op.unpack_vec(y).cpu())
    torch.cuda.synchronize()
    err = (outs[1] - outs[0]).abs().max() / outs[0].abs().max()
    assert float(err) <= tol


def test_library_name_follows_sources(tmp_path, monkeypatch):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert _build.library_path() == path
    src = tmp_path / "k.cu"
    src.write_text("// one kernel\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    src.write_text("// another kernel\n")
    assert _build.library_path() != first != path


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_wrapper_refuses_other_devices():
    st = Stencil(node_shape=(5, 4), widths=(1, 1), periodic=(False, False), dof=1)
    op = interop.operator_from_stencil_data(st, random_stencil_data(st, 0), device="meta")
    xb = torch.empty(1, op.next + 2 * op.G, dtype=op.DT.dtype, device="meta")
    with pytest.raises(ValueError, match="meta"):
        spmv.stencil_spmv_full(op.DT, xb, op._shift_t, op.G)
