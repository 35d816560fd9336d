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

Precision policy: importing the package turns TF32 off for CUDA matmuls
and cuDNN convolutions (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so f32 assembly, load
vectors and functionals stay f32-grade — TF32 keeps about three decimal
digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["core", "sparse", "assembly", "solve", "models", "interop", "entry",
           "default_device", "resolve_device",
           "DistSpace", "DistThetaStepper", "DistAlphaStepper", "save_sharded", "load_sharded",
           "schwarz_local_preconditioner", "mg_local_preconditioner",
           "fieldsplit_local_preconditioner"]

# the distributed layer's names, imported on first use (the reference's
# flat API imports them eagerly, petiga_tpu/__init__.py:78-95)
_LAZY = {
    "DistSpace": "parallel.dist",
    "DistThetaStepper": "parallel.dist",
    "DistAlphaStepper": "parallel.dist",
    "save_sharded": "io.sharded",
    "load_sharded": "io.sharded",
    "schwarz_local_preconditioner": "solve.schwarz",
    "mg_local_preconditioner": "solve.multigrid",
    "fieldsplit_local_preconditioner": "solve.fieldsplit",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
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
