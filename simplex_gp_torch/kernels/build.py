"""Build the Hopper kernels from ``simplex_gp_torch/csrc`` and bind them with ctypes.

The first call compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, under
``simplex_gp_torch/build/``, named by a hash of the sources and flags, so an
edited source builds anew and an unchanged one loads at once.  Each C entry
point takes device pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.

Nothing here runs at import time: the CPU tests import every module, and
only a wrapper called on a CUDA tensor builds the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

__all__ = ["library", "check", "require", "stream", "build_seconds"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream last).
_SIGNATURES = {
    "sgp_lattice_geometry": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "sgp_dedup_insert": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    "sgp_dedup_finish": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "sgp_lattice_splat": [_P, _P, _P, _I, _I, _I, _P, _P],
    "sgp_lattice_blur": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    "sgp_lattice_slice": [_P, _P, _P, _I, _I, _I, _F, _P, _P],
    "sgp_pivot_column": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lib = None
build_seconds = None  # wall time of this process's build (None: loaded or not built)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build simplex_gp_torch kernels")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def _library_path() -> tuple[pathlib.Path, list[pathlib.Path]]:
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    return _BUILD / f"libsgp_kernels_{digest.hexdigest()[:16]}.so", sources


def library() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if the build fails."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, sources = _library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True,
        )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sgp_error_string.argtypes = [ctypes.c_int]
    lib.sgp_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = _lib.sgp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def require(what: str, *tensors_and_dtypes) -> None:
    """Raise unless every (tensor, dtype) pair is a contiguous CUDA tensor of that dtype."""
    for t, dtype in tensors_and_dtypes:
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous CUDA {dtype} tensor, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def stream() -> int:
    """Raw handle of PyTorch's current CUDA stream, for a ctypes call."""
    import torch

    return torch.cuda.current_stream().cuda_stream
