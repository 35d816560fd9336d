"""How the conv engine's element-tap correlation rounds on a CUDA card,
beside PyTorch's convolutions of the same product.  Card only; this file
imports neither jax nor petiga_tpu:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_conv_rounding.py

The inputs are the ones the engine hands its correlation
(``convform._conv``) when it assembles the Cahn–Hilliard α-step Jacobian
at 16³ periodic C¹ p=2 (28 order-2 channels, a value/gradient/Hessian
state field), recorded once in f64 and once in f32.  Each route's f32
node window is compared with the engine's f64 window, relative to its
largest entry, and printed as one JSON line:

  engine        ``convform._conv``: one GEMM per tap into the tap's
                shifted window (cuBLAS, TF32 off)
  cudnn_det     ``conv3d`` through cuDNN, deterministic, TF32 off
  cudnn_nondet  the same under cuDNN's unrestricted heuristics
  native        ``conv3d`` with cuDNN disabled (vol2col + GEMM)

Only the engine's figure is held: within 2e-6 (the CPU reads 6.6e-7;
``chip_smoke.py`` holds the assembled planes to the AD Jacobian at
1e-5)."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from petiga_tpu_torch.assembly import convform
from petiga_tpu_torch.models import cahnhilliard as ch

ENGINE = convform._conv
CTX = {"theta": 1.5, "alpha": 3000.0, "shift": 7.3, "scale": 0.75}


def _conv3d(cudnn, deterministic=True):
    def route(W, ker, p):
        with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                        deterministic=deterministic, allow_tf32=False):
            return F.conv3d(W[None], ker, padding=tuple(p[::-1]))[0]
    return route


ROUTES = {"engine": ENGINE, "cudnn_det": _conv3d(True), "cudnn_nondet": _conv3d(True, False),
          "native": _conv3d(False)}


def _recorded_inputs(monkeypatch, dtype):
    """The (W, ker, p) of every correlation of one Jacobian assembly; the
    engine's own correlation computes them meanwhile."""
    calls = []

    def record(W, ker, p):
        calls.append((W, ker, p))
        return ENGINE(W, ker, p)

    monkeypatch.setattr(convform, "_conv", record)
    sp = ch.make_space(3, nel=16, dtype=dtype, device="cuda")
    rng = np.random.default_rng(12)
    C = torch.as_tensor(0.5 + 0.2 * np.sin(2 * np.pi * rng.random((sp.nnodes, 1))),
                        dtype=dtype, device="cuda")
    convform.assemble_coefficient_planes(sp, ch.jacobian_coefficients, CTX,
                                         fields={"c": (C, 2)}, apply_fix=False)
    monkeypatch.undo()
    return calls


@pytest.mark.cuda
def test_engine_correlation_rounds_like_a_direct_sum(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card's convolution routes")
    ref_calls = _recorded_inputs(monkeypatch, torch.float64)
    f32_calls = _recorded_inputs(monkeypatch, torch.float32)
    assert len(ref_calls) == len(f32_calls) > 0
    rel = dict.fromkeys(ROUTES, 0.0)
    for (W64, k64, p), (W, k, _) in zip(ref_calls, f32_calls):
        ref = ENGINE(W64, k64, p)
        for name, route in ROUTES.items():
            err = (route(W, k, p).double() - ref).abs().max() / ref.abs().max()
            rel[name] = max(rel[name], float(err))
    print(json.dumps({"mesh": "16^3", "device": torch.cuda.get_device_name(0),
                      "f32_rel_to_f64": rel}))
    assert rel["engine"] <= 2e-6, rel
