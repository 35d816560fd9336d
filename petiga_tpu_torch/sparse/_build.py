"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``petiga_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface for ``sm_90a`` (Hopper), and ctypes
loads it.  The library goes to ``build/petiga_tpu_torch/`` at the root
of the checkout, named by a hash of the sources and flags: an unchanged
source loads at once, an edited one rebuilds.  :func:`compile_library`
is that build step for any compiler; the host setup library
(:mod:`petiga_tpu_torch.native`) is built through it too.  A missing ``nvcc`` or a
failed build raises with the compiler's output — nothing runs without
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "petiga_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build the stencil "
        "SpMV kernels (petiga_tpu_torch/csrc)"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_file(stem: str, flags, sources, build_dir: Path = BUILD_DIR) -> Path:
    """``lib<stem>_<hash>.so`` in ``build_dir``, the hash taken over the
    flags and the sources' names and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir / f"lib{stem}_{h.hexdigest()[:16]}.so"


def compile_library(compiler: str, flags, sources, stem: str,
                    build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``sources`` into one shared library unless the library for
    these sources and flags exists; returns its path.  A failed build
    raises with the compiler's output; ``<library>.log`` keeps the output
    of one that succeeded."""
    out = library_file(stem, flags, sources, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(compiler).name} failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    return library_file("petiga_tpu_torch", NVCC_FLAGS, _sources())


def build() -> Path:
    """Compile the kernels unless the library for these sources exists;
    returns its path.  ``<library>.log`` keeps ptxas's register and
    shared-memory report."""
    return compile_library(_nvcc(), NVCC_FLAGS, _sources(), "petiga_tpu_torch")


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        args = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        for kind in ("full", "sym"):
            for t in ("f32", "f64"):
                fn = getattr(lib, f"ptt_spmv_{kind}_{t}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
