"""petiga_tpu_torch — the PyTorch/CUDA port of petiga_tpu (isogeometric
analysis), for NVIDIA Hopper GPUs.

The JAX package ``petiga_tpu`` is the reference; this package mirrors its
layout (``core/``, ``sparse/``, ``assembly/``, ``solve/``, ``models/``) and
imports neither ``jax`` nor ``petiga_tpu``.  Tensors live on the device a
``Space`` is given (``Space(..., device=...)``); there is no global device.

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

__all__ = ["core", "sparse", "assembly", "solve", "models", "interop"]
