"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` into one shared
library with a plain C interface, cached under ``_build/<hash>/`` by a
hash of the sources and flags, and loaded with ``ctypes``. A build
through ``torch.utils.cpp_extension`` (PyTorch's headers) takes minutes;
this one takes seconds, which a fresh machine can afford at every start.

Every launch goes through :func:`launch`: it runs the C entry point on
PyTorch's current stream, raises if the launch returned a CUDA error,
and adds one to the kernel's launch count (:func:`launch_counts`), so a
run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["check_inputs", "launch", "launch_counts", "library",
           "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_LIB_NAME = "libdeltaconv_kernels.so"

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# kernel name -> (C entry point, argument types before the trailing
# device index and stream).
_KERNELS = {
    "gather_rows": ("dc_gather_rows", [_P, _P, _P, _I, _I, _I, _I]),
    "wls": ("dc_wls", [_P, _P, _P, _I, _I, _I, _F, _F]),
    "densify": ("dc_densify", [_P, _P, _P, _P, _P, _I, _I, _I]),
    "gather_max": ("dc_gather_max", [_P, _P, _P, _P, _I, _I, _I, _I]),
}

_launches = {name: 0 for name in _KERNELS}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME as home
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "of deltaconv_tpu_torch need the CUDA toolkit")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _build_key() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the kernel library."""
    out = _BUILD / _build_key() / _LIB_NAME
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in _KERNELS.values():
        fn = getattr(lib, fn_name)
        fn.argtypes = [*argtypes, _I, _P]
        fn.restype = ctypes.c_int
    lib.dc_error_string.argtypes = [_I]
    lib.dc_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(name: str, specs) -> torch.device:
    """Validates the CUDA inputs of one kernel call. ``specs`` is a
    sequence of ``(arg_name, tensor, dtype, shape)``; ``shape`` entries
    of ``None`` are free. Returns the common device."""
    device = specs[0][1].device
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors (plain "
                         f"version on CPU ones), got {device}")
    for arg, t, dtype, shape in specs:
        where = f"{name}({arg})"
        if t.device != device:
            raise ValueError(f"{where}: on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{where}: dtype {t.dtype}, expected {dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{where}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: not contiguous")
        if t.requires_grad:
            raise ValueError(f"{where}: the kernel is forward only and "
                             "has no backward yet")
    return device


def launch(name: str, device: torch.device, *args) -> None:
    """Runs kernel ``name`` on ``device``'s current stream; raises on a
    CUDA error and counts the launch."""
    fn_name = _KERNELS[name][0]
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} "
                           f"({lib.dc_error_string(err).decode()})")
    _launches[name] += 1
