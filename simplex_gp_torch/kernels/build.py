"""Build the Hopper kernels from ``simplex_gp_torch/csrc`` and bind them with ctypes.

The first call compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and links the objects into one
shared library with a plain C interface, under ``simplex_gp_torch/build/``,
named by a hash of the sources and flags, so an edited source builds anew
and an unchanged one loads at once.  Each C entry
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
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points and their argument types (pointers and the stream last).
_SIGNATURES = {
    "sgp_lattice_geometry": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    "sgp_dedup_insert": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    "sgp_dedup_finish": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "sgp_dedup_first": [_P, _I, _P, _I, _P, _P],
    "sgp_dedup_remap": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "sgp_dedup_workspace": [_I, _I, _I, _P],
    "sgp_dedup": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _LL, _P],
    "sgp_lattice_splat": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _P],
    "sgp_lattice_blur": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    "sgp_lattice_slice": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _I, _P],
    "sgp_lattice_splat_blocks": [*[_P] * 11, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "sgp_lattice_blur_live": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "sgp_lattice_slice_blocks": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P],
    "sgp_rows_sizes": [_I, _I, _P, _P],
    "sgp_rows_build": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _LL, _P],
    "sgp_plan_rows_workspace": [_I, _I, _I, _P],
    "sgp_plan_rows": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, *[_P] * 8, _LL, _P],
    "sgp_lattice_apply_cols": [*[_P] * 11, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F,
                               _P, _P, _P, _P, _P, _I, _P],
    "sgp_pivot_column": [_P, _LL, _LL, _P, _LL, _LL, *[_P] * 12, _I, _I, _I, _I, _F, _P],
    "sgp_pivot_factor": [_P, _LL, _LL, _P, _LL, _LL, *[_P] * 8, _I, _I, _I, _F, _P],
    "sgp_lattice_filter_grad": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    "sgp_once_insert": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "sgp_once_workspace": [_I, _I, _I, _I, _I, _P],
    "sgp_once_apply": [_P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _P, _I, _P, _F, _P, _LL, _P, _P],
    "sgp_lattice_count": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "sgp_deriv_grad": [*[_P] * 11, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _F, _F,
                       _P, _P, _P, _P, _P],
    "sgp_mixture_apply": [*[_P] * 11, _I, _I, _I, _I, *[_P] * 6, _I, _I, _I, _I, _I, _P, _I, _P, _F, *[_P] * 4,
                          _I, _P],
    "sgp_ski_interp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "sgp_ski_interp_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "sgp_ski_kr_matmul": [_P, _P, _P, _I, _I, _I, _P, _P],
    "sgp_ski_kr_resident": [_P],
    "sgp_ski_kr_gram": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "sgp_ski_kr_adjoint": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "sgp_chain_dedup": [_P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    "sgp_chain_rank": [_P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    "sgp_chain_place": [_P, _P, _I, _I, _P, _P, _P],
    "sgp_chain_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "sgp_chain_finish": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    "sgp_run_lists": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "sgp_chain_splat": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P],
    "sgp_chain_axis": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sgp_chain_slice": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P],
    "sgp_chain_axes": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "sgp_chain_maps": [_P, _I, _I, _P, _P],
    "sgp_chain_axes_transpose": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P],
    "sgp_chain_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                        _P, _I, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P],
    "sgp_chain_splat_blocks": [*[_P] * 11, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P],
    "sgp_chain_unblock": [_P, _I, _I, _I, _P, _P],
    "sgp_cg_dot": [*[_P] * 5, _I, _I, _I, _I, _P, _P],
    "sgp_cg_step_x": [_P, _I, _LL, *[_P] * 4, _I, _I, _I, _I, *[_P] * 4],
    "sgp_cg_utr": [_P, _P, *[_I] * 9, _P, _P],
    "sgp_cg_fold": [_P, _I, _LL, _I, _I, _I, _P, _P, _P],
    "sgp_cg_precond": [*[_P] * 5, *[_I] * 8, _P, _P],
    "sgp_cg_step_p": [_P, _P, _I, _LL, _LL, _I, *[_P] * 4, _I, _I, _I, _I, *[_P] * 5, _I, _F, _I, _I, _I, _I, _P],
    "sgp_cg_init": [_P, _P, _I, _LL, _LL, _I, _I, _I, _P, _P, _I, _P],
    "sgp_slq_quadrature": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _I, _I, _P, _P],
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
        objs = [so.with_name(f"{so.stem}_{src.stem}.{os.getpid()}.o") for src in sources]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([_nvcc(), *_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append((src.name, out, proc.returncode))
        if all(rc == 0 for *_, rc in logs):
            link = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(("link", link.stdout + link.stderr, link.returncode))
        for obj in objs:
            obj.unlink(missing_ok=True)
        text = "".join(f"== {name} (rc {rc})\n{out}" for name, out, rc in logs)
        so.with_suffix(".log").write_text(text)
        if any(rc != 0 for *_, rc in logs):
            failed = "".join(f"== {name} (rc {rc})\n{out}" for name, out, rc in logs if rc != 0)
            raise RuntimeError(f"nvcc failed:\n{failed[-4000:]}")
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
