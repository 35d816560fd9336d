"""ctypes bindings for the native host setup library
(``csrc/host/native_core.cpp``; port of :mod:`petiga_tpu.native`).

The setup paths ask :func:`available` before taking the native route and
fall back to their vectorized numpy versions when it is False:
``core/bspline.bspline_ders`` at 4096 points or more, ``Space.mapping``
at 4096 elements or more, as the reference's do.

The library is host C++, not GPU code.  At first use the host C++
compiler (``$CXX``, else ``c++`` or ``g++``) builds it with the
reference's flags into ``build/petiga_tpu_torch/`` at the root of the
checkout, named by a hash of the source and the flags, through the same
build step as the CUDA kernels (``sparse/_build.compile_library``).  A
failed build leaves :func:`available` False and its output in
:func:`build_error`; :func:`load` then raises with it.  ``CALLS`` counts
the native calls by function.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np

from .sparse import _build

__all__ = ["CALLS", "available", "build_error", "bspline_ders", "build_mapping",
           "byteswap_f64", "load"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "native_core.cpp"
BUILD_DIR = _build.BUILD_DIR
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

# native calls by function, for runs that show the route was taken
CALLS = {"bspline_ders": 0, "build_mapping": 0, "byteswap_f64": 0}

_LIB = None
_ERROR = None


def _compiler() -> str:
    for exe in (os.environ.get("CXX"), "c++", "g++"):
        if exe and shutil.which(exe):
            return shutil.which(exe)
    raise RuntimeError("no host C++ compiler found ($CXX, c++, g++)")


def _library() -> Path:
    return _build.compile_library(_compiler(), CXXFLAGS, [SOURCE], "petiga_native", BUILD_DIR)


def load() -> ctypes.CDLL:
    """The loaded library, built at first use; raises with the
    compiler's output when it cannot be built or loaded."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is not None:
        raise RuntimeError(f"native setup library unavailable: {_ERROR}")
    try:
        lib = ctypes.CDLL(str(_library()))
    except (RuntimeError, OSError) as e:
        _ERROR = str(e)
        raise RuntimeError(f"native setup library unavailable: {_ERROR}") from e
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.bspline_ders.argtypes = [f64p, ctypes.c_int64, i64p, f64p, ctypes.c_int64,
                                 ctypes.c_int64, f64p]
    lib.bspline_ders.restype = None
    lib.build_mapping.argtypes = [ctypes.c_int64, i64p, i64p, i64p,
                                  ctypes.POINTER(i64p), ctypes.POINTER(ctypes.c_int32)]
    lib.build_mapping.restype = None
    lib.byteswap_f64.argtypes = [f64p, ctypes.c_int64, f64p]
    lib.byteswap_f64.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it at first
    use); False when the build failed (see :func:`build_error`)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def build_error():
    """The compiler's (or loader's) output of the failed build, or None."""
    return _ERROR


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def bspline_ders(U, p, spans, u, nder):
    """Native Cox-de Boor; same contract as
    :func:`petiga_tpu_torch.core.bspline.bspline_ders`: ``(B, nder+1,
    p+1)`` float64."""
    lib = load()
    if not 0 <= p <= 11:  # the C++ tables hold p + 1 <= 12 entries
        raise ValueError(f"native bspline_ders takes degree 0..11, got {p}")
    U = np.ascontiguousarray(U, dtype=np.float64)
    spans = np.ascontiguousarray(spans, dtype=np.int64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    if spans.shape != u.shape or u.ndim != 1:
        raise ValueError(f"spans {spans.shape} and u {u.shape} must be equal 1-D shapes")
    if len(u) and (spans.min() < p - 1 or spans.max() + p >= len(U)):
        raise ValueError("span indices out of range of the knot vector")
    out = np.zeros((len(u), nder + 1, p + 1), dtype=np.float64)
    lib.bspline_ders(_dp(U), p, _ip64(spans), _dp(u), len(u), nder, _dp(out))
    CALLS["bspline_ders"] += 1
    return out


def build_mapping(dim, nel, nen, nnp, offsets):
    """Native closure-map builder: ``(prod nel, prod nen)`` int32 flat
    control-point indices, local basis axis-0 fastest, periodic wrap."""
    lib = load()
    if not 1 <= dim <= 3 or not len(nel) == len(nen) == len(nnp) == len(offsets) == dim:
        raise ValueError(f"build_mapping: {dim}-D wants per-axis sizes of length {dim}")
    nel3 = np.asarray(list(nel) + [1] * (3 - dim), dtype=np.int64)
    nen3 = np.asarray(list(nen) + [1] * (3 - dim), dtype=np.int64)
    nnp3 = np.asarray(list(nnp) + [1] * (3 - dim), dtype=np.int64)
    offs = [np.ascontiguousarray(o, dtype=np.int64) for o in offsets]
    if any(o.shape != (n,) for o, n in zip(offs, nel)):
        raise ValueError("build_mapping: one offset per element on each axis")
    offs += [np.zeros(1, dtype=np.int64)] * (3 - dim)
    arr = (ctypes.POINTER(ctypes.c_int64) * 3)(*[_ip64(o) for o in offs])
    out = np.zeros((int(np.prod(nel)), int(np.prod(nen))), dtype=np.int32)
    lib.build_mapping(dim, _ip64(nel3), _ip64(nen3), _ip64(nnp3), arr,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    CALLS["build_mapping"] += 1
    return out


def byteswap_f64(a):
    """Big-endian <-> native float64 byte swap of ``a`` (any shape)."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float64)
    out = np.empty_like(a)
    lib.byteswap_f64(_dp(a), a.size, _dp(out.reshape(-1)))
    CALLS["byteswap_f64"] += 1
    return out
