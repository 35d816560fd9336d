"""petiga_tpu_torch — the PyTorch/CUDA port of petiga_tpu (isogeometric
analysis), for NVIDIA Hopper GPUs.

The JAX package ``petiga_tpu`` is the reference; this package mirrors its
layout (``core/``, ``sparse/``, ``assembly/``, ``solve/``, ``models/``) and
imports neither ``jax`` nor ``petiga_tpu``.  Tensors live on the device a
``Space`` is given (``Space(..., device=...)``).  Every entry point takes
``device=None``, meaning :func:`default_device`: the CUDA device, or an
error when there is none.  The CPU is used only when the caller asks for
it (``device="cpu"``), as the tests do.

The stencil SpMV — full and symmetric storage — runs through hand-written
CUDA kernels (``csrc/stencil_spmv.cu``) built with ``nvcc`` at first use;
CPU tensors take their plain PyTorch versions.

Quickstart (the reference's own, ``petiga_tpu/__init__.py:9-22``; the
space lives on the card unless ``device="cpu"`` is passed)::

    import torch
    from petiga_tpu_torch import Axis, Space, assemble_system, cg

    sp = Space([Axis.uniform(p=2, nel=32)] * 2, dtype=torch.float32)
    sp.set_boundary_value(0, 0, 0, 0.0)   # x-min face, field 0

    def laplace(pt, ctx):
        return pt.shape1 @ pt.shape1.T, pt.shape0

    A, b = assemble_system(sp, laplace)
    x, iters, res = cg(A.fast_operator(), b)

Every name of the reference's flat API is here under the same name, but
``PallasStencilOperator`` is :class:`~.sparse.spmv.StencilOperator` and
``pallas_matvec`` is :func:`~.sparse.spmv.stencil_matvec`
(``_RENAMES``).  The six example programs are
``python -m petiga_tpu_torch.examples.<name>``.

Precision policy: importing the package turns TF32 off for CUDA matmuls
and cuDNN convolutions (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so f32 assembly, load
vectors and functionals stay f32-grade — TF32 keeps about three decimal
digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The flat API of the reference (petiga_tpu/__init__.py:24-131): every name
# of its __all__, imported on first use from the port module that mirrors
# the reference's, so `import petiga_tpu_torch` stays light.  Two names
# differ; the reference's name -> the port's:
_RENAMES = {"PallasStencilOperator": "StencilOperator", "pallas_matvec": "stencil_matvec"}

_LAZY = {
    name: module
    for module, names in (
        ("core.axis", ("Axis",)),
        ("core.quadrature", ("Rule", "gauss_legendre", "gauss_lobatto")),
        ("core.space", ("Space", "BoundaryCondition")),
        ("config", ("Options", "bind_cli", "print_info")),
        ("assembly.assemble", (
            "assemble_system", "assemble_system_planes", "assemble_separable_planes",
            "assemble_matrix", "assemble_vector", "assemble_function", "assemble_jacobian",
            "compute_scalar", "compute_error_norm", "dirichlet_post_fix", "stencil_of")),
        ("assembly.collocation", (
            "assemble_collocation", "assemble_collocation_function",
            "assemble_collocation_jacobian")),
        ("assembly.point", ("Point",)),
        ("assembly.tabulation", ("validate_geometry",)),
        ("sparse.stencil", (
            "Stencil", "StencilMatrix", "SymmetricStencilMatrix", "stencil_apply")),
        ("sparse.spmv", ("StencilOperator", "stencil_matvec")),
        ("sparse.matfree", ("MatFreeOperator", "JacobianFreeOperator")),
        ("solve.krylov", (
            "cg", "bicgstab", "gmres", "jacobi_preconditioner",
            "block_jacobi_preconditioner")),
        ("solve.newton", ("newton", "NewtonResult")),
        ("solve.ts", (
            "ThetaStepper", "AlphaStepper", "Alpha2Stepper", "ExplicitStepper", "integrate",
            "integrate_adaptive")),
        ("solve.blockpc", ("ebe_preconditioner", "bbb_preconditioner")),
        ("solve.schwarz", ("schwarz_preconditioner", "schwarz_local_preconditioner")),
        ("solve.multigrid", ("MGHierarchy", "mg_preconditioner", "mg_local_preconditioner")),
        ("solve.fieldsplit", (
            "field_split", "fieldsplit_preconditioner", "fieldsplit_local_preconditioner")),
        ("parallel.dist", ("DistSpace", "DistThetaStepper", "DistAlphaStepper")),
        ("parallel.partition", ("factor_grid",)),
        ("io.checkpoint", ("write_space", "read_space", "write_vec", "read_vec")),
        ("io.sharded", ("save_sharded", "load_sharded")),
        ("post.probe", ("Probe",)),
        ("post.sample", ("sample_grid", "write_vts")),
        ("utils.profiling", ("profiling",)),
    )
    for name in names
}

__all__ = ["core", "sparse", "assembly", "solve", "models", "parallel", "io", "post",
           "utils", "config", "native", "interop", "entry", "examples",
           "default_device", "resolve_device", *_LAZY]

__version__ = "0.2.0"


def __getattr__(name):
    if name in _LAZY:
        import importlib

        path = _LAZY[name]
        mod = importlib.import_module(f".{path}", __name__)
        value = mod if path.rsplit(".", 1)[-1] == name else getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def default_device() -> torch.device:
    """The device of every entry point called without ``device``: the
    CUDA device.  Raises when none is present; never returns the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "petiga_tpu_torch runs on a CUDA device unless told otherwise, and "
            "none is present; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means
    :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
