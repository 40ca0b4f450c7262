"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` (one process per
source, in parallel) and linked into one shared library with a plain C
interface, cached under ``_build/<hash>/`` by a hash of the sources and
flags, and loaded with ``ctypes``. A build
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
           "no_grad_reason", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_LIB_NAME = "libdeltaconv_kernels.so"

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# kernel name -> (C entry point, argument types before the trailing
# device index and stream).
_KERNELS = {
    "gather_rows": ("dc_gather_rows", [_P, _P, _P, _I, _I, _I, _I, _I]),
    "wls": ("dc_wls", [_P, _P, _P, _I, _I, _I, _I, _F, _F]),
    "wls_direct": ("dc_wls_direct", [_P, _P, _P, _I, _I, _I, _F, _F]),
    "wls_bwd": ("dc_wls_bwd", [_P] * 4 + [_I] * 4 + [_F] * 2),
    "wls_bwd_direct": ("dc_wls_bwd_direct", [_P] * 4 + [_I] * 3 + [_F] * 2),
    "fused_gather_wls": ("dc_fused_gather_wls",
                         [_P] * 10 + [_I] * 4 + [_F] * 2),
    "fused_gather_wls_direct": ("dc_fused_gather_wls_direct",
                                [_P] * 10 + [_I] * 3 + [_F] * 2),
    "densify": ("dc_densify", [_P] * 5 + [_I] * 4),
    "densify_bf16": ("dc_densify_bf16", [_P] * 5 + [_I] * 4),
    "densify_bwd": ("dc_densify_bwd", [_P] * 5 + [_I] * 3),
    "gather_max": ("dc_gather_max", [_P] * 4 + [_I] * 6),
    "gather_max_win": ("dc_gather_max_win", [_P] * 5 + [_I] * 6),
    "gather_max_direct": ("dc_gather_max_direct", [_P] * 4 + [_I] * 4),
    "gather_max_win_direct": ("dc_gather_max_win_direct",
                              [_P] * 5 + [_I] * 4),
    "gather_max_bwd": ("dc_gather_max_bwd", [_P] * 4 + [_I] * 7),
    "gather_max_bwd_direct": ("dc_gather_max_bwd_direct",
                              [_P] * 5 + [_I] * 5),
    "gather_max_bf16": ("dc_gather_max_bf16", [_P] * 4 + [_I] * 6),
    "gather_max_win_bf16": ("dc_gather_max_win_bf16", [_P] * 5 + [_I] * 6),
    "gather_max_bf16_direct": ("dc_gather_max_bf16_direct",
                               [_P] * 4 + [_I] * 4),
    "gather_max_win_bf16_direct": ("dc_gather_max_win_bf16_direct",
                                   [_P] * 5 + [_I] * 4),
    "gather_max_bwd_bf16": ("dc_gather_max_bwd_bf16", [_P] * 4 + [_I] * 7),
    "gather_max_bwd_bf16_direct": ("dc_gather_max_bwd_bf16_direct",
                                   [_P] * 5 + [_I] * 5),
    "adjacency": ("dc_adjacency", [_P, _P, _P, _I, _I, _I]),
    "gather_sum": ("dc_gather_sum", [_P] * 4 + [_I] * 6),
    "gather_sum_direct": ("dc_gather_sum_direct", [_P] * 4 + [_I] * 4),
    "gather_sum_bwd": ("dc_gather_sum_bwd", [_P] * 5 + [_I] * 4),
    "knn_topk": ("dc_knn_topk", [_P, _P, _I, _I, _I, _I]),
    "knn_topk_mean_dist": ("dc_knn_topk_mean_dist", [_P] * 3 + [_I] * 4),
    "knn_topk_rounds": ("dc_knn_topk_rounds", [_P] * 3 + [_I] * 4),
    "gather_max_affine": ("dc_gather_max_affine", [_P] * 5 + [_I] * 7),
    "gather_max_affine_direct": ("dc_gather_max_affine_direct",
                                 [_P] * 5 + [_I] * 5),
    "gather_matmul_max": ("dc_gather_matmul_max", [_P] * 6 + [_I] * 6),
    "gather_matmul_max_kfold": ("dc_gather_matmul_max_kfold",
                                [_P] * 6 + [_I] * 5),
    "gather_matmul_max_win": ("dc_gather_matmul_max_win",
                              [_P] * 6 + [_I] * 6),
    "gather_matmul_max_win_kfold": ("dc_gather_matmul_max_win_kfold",
                                    [_P] * 6 + [_I] * 5),
    "gather_mlp_max": ("dc_gather_mlp_max", [_P] * 9 + [_I] * 6),
    "mlp_rows": ("dc_mlp_rows", [_P] * 5 + [_I, _L]),
    "gather_max_merge": ("dc_gather_max_merge", [_P] * 6 + [_I] * 6),
    "densify_int8": ("dc_densify_int8", [_P] * 8 + [_I] * 5),
    "absmax": ("dc_absmax", [_P] * 2 + [_I] * 4),
    "gather_max_int8": ("dc_gather_max_int8", [_P] * 5 + [_I] * 7),
    "gather_max_int8_direct": ("dc_gather_max_int8_direct",
                               [_P] * 5 + [_I] * 5),
    "gather_matmul_max_int8": ("dc_gather_matmul_max_int8",
                               [_P] * 5 + [_I] * 6),
    "gather_matmul_max_int8_kfold": ("dc_gather_matmul_max_int8_kfold",
                                     [_P] * 5 + [_I] * 5),
    "inverse_adjacency": ("dc_inverse_adjacency", [_P] * 4 + [_I] * 5),
    "scatter_rows": ("dc_scatter_rows", [_P] * 4 + [_I] * 5 + [_L] * 4),
    "coef_apply_grad": ("dc_coef_apply_grad", [_P] * 4 + [_I] * 5),
    "coef_apply_div": ("dc_coef_apply_div", [_P] * 4 + [_I] * 5),
    "coef_apply_grad_plan": ("dc_coef_apply_grad_plan", [_P] * 7 + [_I] * 7),
    "coef_apply_div_plan": ("dc_coef_apply_div_plan", [_P] * 7 + [_I] * 7),
    "coef_plan_order": ("dc_coef_plan_order", [_P] * 4 + [_I] * 2),
    "coef_plan_runs": ("dc_coef_plan_runs", [_P] * 5 + [_I] * 4),
    "coef_cotangent": ("dc_coef_cotangent", [_P] * 5 + [_I] * 5 + [_L] * 3),
    "knn_topk_table": ("dc_knn_topk_table", [_P] * 7 + [_I] * 4),
    "knn_topk_table_q": ("dc_knn_topk_table_q", [_P] * 7 + [_I] * 4),
    "knn_topk_bucketed": ("dc_knn_topk_bucketed", [_P] * 9 + [_I] * 7),
    "knn_topk_bucketed_q": ("dc_knn_topk_bucketed_q", [_P] * 9 + [_I] * 7),
    "edge_delta_mlp": ("dc_edge_mlp_fwd", [_P] * 6 + [_I] * 5),
    "edge_delta_mlp_bwd": ("dc_edge_mlp_bwd_edges", [_P] * 9 + [_I] * 6),
    "edge_delta_mlp_bwd_sum": ("dc_edge_mlp_bwd_sum", [_P] * 5 + [_I] * 4),
    "gather_minmax": ("dc_gather_minmax", [_P] * 5 + [_I] * 6),
    "gather_minmax_bf16": ("dc_gather_minmax_bf16", [_P] * 5 + [_I] * 6),
    "gather_minmax_win": ("dc_gather_minmax_win", [_P] * 7 + [_I] * 6),
    "gather_minmax_win_bf16": ("dc_gather_minmax_win_bf16",
                               [_P] * 7 + [_I] * 6),
    "gather_minmax_direct": ("dc_gather_minmax_direct", [_P] * 5 + [_I] * 4),
    "gather_minmax_bf16_direct": ("dc_gather_minmax_bf16_direct",
                                  [_P] * 5 + [_I] * 4),
    "gather_minmax_win_direct": ("dc_gather_minmax_win_direct",
                                 [_P] * 7 + [_I] * 4),
    "gather_minmax_win_bf16_direct": ("dc_gather_minmax_win_bf16_direct",
                                      [_P] * 7 + [_I] * 4),
    "gather_minmax_bwd": ("dc_gather_minmax_bwd", [_P] * 6 + [_I] * 7),
    "gather_minmax_bwd_bf16": ("dc_gather_minmax_bwd_bf16",
                               [_P] * 6 + [_I] * 7),
    "gather_minmax_bwd_direct": ("dc_gather_minmax_bwd_direct",
                                 [_P] * 7 + [_I] * 5),
    "gather_minmax_bwd_bf16_direct": ("dc_gather_minmax_bwd_bf16_direct",
                                      [_P] * 7 + [_I] * 5),
    "gather_matmul_minmax": ("dc_gather_matmul_minmax", [_P] * 6 + [_I] * 6),
    "gather_matmul_minmax_kfold": ("dc_gather_matmul_minmax_kfold",
                                   [_P] * 6 + [_I] * 5),
}

# Why a raw kernel takes no tensor that requires grad: the differentiable
# gather, WLS solve, assembly, applies, maxes and sum are the autograd
# Functions around their kernels, the fused build and the bf16 maxes with
# the epilogue are eval forms, and kNN indices carry no gradient.
_BF16_EVAL = ("it is the eval form (running statistics in the "
              "epilogue); in training the layers take ops.gather_max or "
              "ops.gather_matmul_max_train, whose backward is a kernel")
_MLP_EVAL = ("it is the eval form (forward only, as the JAX kernel); "
             "DeepMaxMLP in training takes ops.edge_delta_mlp or the "
             "per-point and edge-tensor routes")
_NO_GRAD = {
    "fused_gather_wls": "the fused eval build is forward only, as the JAX "
                        "kernel; differentiate through the unfused build "
                        "(ops.gather_rows, ops.wls, ops.densify_coefs)",
    "knn_topk": "kNN indices carry no gradient",
    "knn_topk_mean_dist": "kNN indices carry no gradient",
    "knn_topk_rounds": "kNN indices carry no gradient",
    "knn_topk_table": "kNN indices carry no gradient",
    "knn_topk_table_q": "kNN indices carry no gradient",
    "knn_topk_bucketed": "kNN indices carry no gradient",
    "knn_topk_bucketed_q": "kNN indices carry no gradient",
    "coef_plan_order": "the gather plan orders points and carries no "
                       "gradient",
    "coef_plan_runs": "the gather plan orders points and carries no "
                      "gradient",
    "gather_max_affine": _BF16_EVAL,
    "gather_max_affine_direct": _BF16_EVAL,
    "gather_matmul_max": _BF16_EVAL,
    "gather_matmul_max_kfold": _BF16_EVAL,
    "gather_mlp_max": _MLP_EVAL,
    "mlp_rows": _MLP_EVAL,
    "gather_max_merge": _MLP_EVAL,
}
_NO_GRAD.update(dict.fromkeys(
    ("gather_matmul_minmax", "gather_matmul_minmax_kfold"),
    "it is forward only, as the JAX function (no VJP); differentiate "
    "through ops.gather_minmax of x @ w"))
_NO_GRAD.update(dict.fromkeys(
    ("densify_int8", "absmax", "gather_max_int8", "gather_max_int8_direct",
     "gather_matmul_max_int8", "gather_matmul_max_int8_kfold"),
    "int8 operators serve only, as the JAX package's (forward only: the "
    "rounding has no gradient)"))

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


def _run_all(cmds) -> None:
    """Runs the commands in parallel; raises with the output of the
    first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [proc.communicate()[0] for _, proc in procs]
    for (cmd, proc), out in zip(procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


@functools.cache
def library() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the kernel library: one
    ``nvcc -c`` per source, all at once, then one link."""
    out = _BUILD / _build_key() / _LIB_NAME
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs, compiles = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = out.with_name(f"{src.stem}.{tag}.o")
            objs.append(str(obj))
            compiles.append([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj),
                             str(src)])
        _run_all(compiles)
        tmp = out.with_name(f"{_LIB_NAME}.{tag}")
        _run_all([[nvcc, "-shared", "-o", str(tmp), *objs]])
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in _KERNELS.values():
        fn = getattr(lib, fn_name)
        fn.argtypes = [*argtypes, _I, _P]
        fn.restype = ctypes.c_int
    lib.dc_error_string.argtypes = [_I]
    lib.dc_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(name: str, specs, strided=()) -> torch.device:
    """Validates the CUDA inputs of one kernel call. ``specs`` is a
    sequence of ``(arg_name, tensor, dtype, shape)``; ``shape`` entries
    of ``None`` are free. Every tensor must be contiguous except those
    named in ``strided``, which the kernel reads through their strides.
    Returns the common device."""
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
        if arg not in strided and not t.is_contiguous():
            raise ValueError(f"{where}: not contiguous")
        if t.requires_grad:
            raise ValueError(f"{where}: the raw kernel takes no tensor "
                             f"that requires grad; {no_grad_reason(name)}")
    return device


def no_grad_reason(name: str) -> str:
    """Why kernel ``name`` takes no tensor that requires grad, and what to
    differentiate through instead."""
    return _NO_GRAD.get(
        name, "differentiate through ops.gather_rows, ops.wls, "
        "ops.densify_coefs, ops.coef_apply_grad, ops.coef_apply_div "
        "(whose coefficients' cotangent is ops.coef_cotangent), "
        "ops.gather_max, ops.gather_minmax, "
        "ops.gather_sum, ops.gather_matmul_max_train or "
        "ops.edge_delta_mlp, whose backward is a kernel")


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
