"""Design variants of the streaming neighbour sum's route S (the sum mode
of the staged kernel in ``deltaconv_tpu_torch/csrc/gather_max.cu``,
launched by ``gather_sum.cu``'s ``dc_gather_sum``), built and timed side
by side on one CUDA card.

Each variant is the checkout's ``gather_max.cu``, ``gather_sum.cu`` and
``gather_matmul_max_rows.cuh`` with a few text substitutions, compiled by
``nvcc`` into a library of its own under
``deltaconv_tpu_torch/_build/variants/`` and called through
``dc_gather_sum`` on the same inputs: ellipsoid clouds' kNN graphs (K=20)
at the shapes where the sum runs, B=4, N=8192 (the large-cloud step: 4
channels a slice, 16-byte rows) and B=32, N=1024 (32 channels, 128-byte
rows), C=128, each on the slice and splits that ``sum_slice`` picks. For
each it prints the device time of one call (``chip_smoke.device_ms``) and
whether the output equals ``gather_sum_fwd_plain`` bit for bit (the
``stage-only`` and ``no-stage`` variants compute no sum: their time is a
part of the kernel's).

Variants:
  this        the sources as they are;
  stage-only  each block stages its slice and sums no point: the copy's
              share of the time;
  no-stage    each block copies nothing (two constant rows only) and sums
              every point out of shared memory: the sum phase's share;
  warps-32, warps-8  32 or 8 warps a block in place of 16 (every staged
              kernel of the file; only the sum is timed).

    python3 tools/sum_kernel_variants.py [variant ...]

Run on a machine with an H100 and the CUDA toolkit, from the checkout's
root or anywhere (the script finds the checkout from its own path).
"""

from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deltaconv_tpu_torch import ops  # noqa: E402

CSRC = ROOT / "deltaconv_tpu_torch" / "csrc"
OUT = ROOT / "deltaconv_tpu_torch" / "_build" / "variants"
NVCC = "/usr/local/cuda/bin/nvcc"
SOURCES = ("gather_max.cu", "gather_sum.cu", "gather_matmul_max_rows.cuh")
HEADERS = ("common.cuh", "gather_matmul_max.cuh")
STAGE_LOOP = "  for (int e = tid; e < N * units; e += blockDim.x) {"
SUM_POINTS = ("        ys, idx, mask, nullptr, 0, out, nullptr, b, N, p0, "
              "p1, C, c0, nvalid,\n        vec_out != 0, K, neg, warp, "
              "lane);")
WARPS = "constexpr int kRowsWarps = 16;"

# name -> substitutions in one of SOURCES each
VARIANTS = {
    "this": [],
    "stage-only": [(SUM_POINTS, SUM_POINTS.replace("p0, p1,", "p0, p0,"))],
    "no-stage": [(STAGE_LOOP, STAGE_LOOP.replace("e < N * units",
                                                 "e < 0"))],
    "warps-32": [(WARPS, WARPS.replace("16", "32"))],
    "warps-8": [(WARPS, WARPS.replace("16", "8"))],
}
SHAPES = (("large step", 4, 8192), ("cls", 32, 1024))
C, K = 128, 20
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name: str):
    """The variant's library with ``dc_gather_sum``."""
    d = OUT / f"sum-{name}"
    d.mkdir(parents=True, exist_ok=True)
    srcs = {f: (CSRC / f).read_text() for f in SOURCES}
    for old, new in VARIANTS[name]:
        where = [f for f, text in srcs.items() if old in text]
        if len(where) != 1:
            raise ValueError(f"{name}: {old!r} in {where}, not in one source")
        srcs[where[0]] = srcs[where[0]].replace(old, new)
    for f, text in srcs.items():
        (d / f).write_text(text)
    for f in HEADERS:
        (d / f).write_text((CSRC / f).read_text())
    lib = d / "libsum.so"
    subprocess.run(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
         str(d / "gather_max.cu"), str(d / "gather_sum.cu")],
        capture_output=True, text=True, check=True)
    so = ctypes.CDLL(str(lib))
    so.dc_gather_sum.argtypes = [_P] * 4 + [_I] * 6 + [_I, _P]
    return so


def main(names):
    from deltaconv_tpu_torch.geometry import knn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    libs = {name: build(name) for name in names}
    gs = importlib.import_module("deltaconv_tpu_torch.ops.gather_sum")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    for label, b, n in SHAPES:
        clouds, _ = cs.ellipsoid_clouds(rng, [n] * b)
        idx, mask = knn(torch.from_numpy(np.stack(clouds)).to(dev), K)
        h = torch.randn((b, n, C), device=dev)
        want = ops.gather_sum_fwd_plain(h, idx, mask)
        out = torch.empty_like(h)
        cs_, splits = gs.sum_slice(b, n, C, K, sms)
        stream = torch.cuda.current_stream().cuda_stream
        parts = []
        for name, so in libs.items():
            def call(so=so):
                return so.dc_gather_sum(h.data_ptr(), idx.data_ptr(),
                                        mask.data_ptr(), out.data_ptr(), b, n,
                                        C, K, cs_, splits, 0, stream)

            out.fill_(float("nan"))
            if call():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            parts.append(f"{name} {cs.device_ms(call, 10):.4f} ms (bit-equal "
                         f"{torch.equal(out, want)})")
        print(f"[sum-variants] {label} B={b} N={n} K={K} C={C}, slice "
              f"{cs_} x {splits}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
