"""Design variants of the coefficients' cotangent kernel
(``deltaconv_tpu_torch/csrc/coef_cotangent.cu``, ``dc_coef_cotangent``),
built and timed side by side on one CUDA card.

Each variant is the checkout's ``coef_cotangent.cu`` with a few text
substitutions, compiled by ``nvcc`` into a library of its own under
``deltaconv_tpu_torch/_build/variants/`` and called through
``dc_coef_cotangent`` on the same inputs: an ellipsoid cloud's kNN graph
(K=20) at the dense path's shape (B=32, N=1024) and the coefficient
form's (B=4, N=8192), random rows and cotangents, at one forward's widths
of each mode. For each it prints the device time of one call
(``chip_smoke.device_ms``), with the points walked in index order and
(``+order``) in the Morton order of the cloud's gather plan
(``ops.coef_plan``), and whether the output equals the checkout's kernel
bit for bit (``this``, ``occ-1``, ``occ-3``, ``min-1`` and
``inflight-64`` compute the function in its order; ``g8``, ``g16`` and
``g-by-width`` in another f64 order where they change the group; the
others remove a part to time the rest).

Variants:
  this          the source as it is;
  no-convert    the gathered f32 values enter the f64 sums by a bit move
                in place of a conversion (wrong values): the conversions'
                share;
  no-gather     every slot reads the point's own row (from L1) in place of
                its neighbour's: the gathers' share from L2;
  local-sum     each lane adds its 16 partial sums of a chunk into one in
                place of the butterfly (wrong values, every product kept):
                the reduction's share;
  g8, g16       groups of 8 or 16 lanes a point at every width of
                16-byte vectors (more passes over the channels, the ct
                rows reloaded a pass);
  g-by-width    rows of 8-byte vectors grouped as 16-byte ones are, by
                their vectors (32 lanes at C=70, where 8 take them);
  occ-1         the 16-byte kernels uncapped (as the narrower ones);
  occ-3, min-1  the narrower vectors' kernels capped as the 16-byte ones
                (3 blocks an SM), or declared for 1 block an SM;
  inflight-64   twice as many gathered floats in flight a lane.

    python3 tools/cotangent_kernel_variants.py [variant ...]

Run on a machine with an H100 and the CUDA toolkit, from the checkout's
root or anywhere (the script finds the checkout from its own path).
"""

from __future__ import annotations

import ctypes
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
GRAD_X = "const double x = (double)raw[s][u][0][i];"
DIV_0 = "p0 = fma((double)raw[s][u][0][i], cta[u][i], p0);"
DIV_1 = "p1 = fma((double)raw[s][u][1][i], cta[u][i], p1);"
LOAD = "load_vec<V>(fb + (long long)j * row + d * C + c0[u],"
REDUCE = "butterfly<G / 2, 2 * kChunk>(part, lg);"
GROUP = ("    if (nv <= 8 * kVecs)\n      launch_wide<8, 4, kDiv>(a, st);\n"
         "    else if (nv <= 16 * kVecs)\n      launch_wide<16, 4, kDiv>(a, st);\n"
         "    else\n      launch_wide<32, 4, kDiv>(a, st);")
NARROW = "    launch_wide<8, 2, kDiv>(a, st);"
CAPPED = "__launch_bounds__(kThreads, 3)\n    cotangent_wide_vec4_kernel("
UNCAPPED = "__launch_bounds__(kThreads)\n    cotangent_wide_kernel("
IN_FLIGHT = "constexpr int kInFlight = 32;"


def _moved(expr):
    return f"__hiloint2double(__float_as_int({expr}), 0)"


VARIANTS = {
    "this": [],
    "no-convert": [
        (GRAD_X, f"const double x = {_moved('raw[s][u][0][i]')};"),
        (DIV_0, f"p0 = fma({_moved('raw[s][u][0][i]')}, cta[u][i], p0);"),
        (DIV_1, f"p1 = fma({_moved('raw[s][u][1][i]')}, cta[u][i], p1);")],
    "no-gather": [(LOAD, LOAD.replace("j * row", "n * row"))],
    "local-sum": [(REDUCE, "for (int i = 1; i < 2 * kChunk; ++i) "
                           "part[0] += part[i];")],
    "g8": [(GROUP, "    launch_wide<8, 4, kDiv>(a, st);")],
    "g16": [(GROUP, "    launch_wide<16, 4, kDiv>(a, st);")],
    "occ-1": [(CAPPED, CAPPED.replace("(kThreads, 3)", "(kThreads)"))],
    "occ-3": [(UNCAPPED, UNCAPPED.replace("(kThreads)", "(kThreads, 3)"))],
    "min-1": [(UNCAPPED, UNCAPPED.replace("(kThreads)", "(kThreads, 1)"))],
    "g-by-width": [(NARROW, GROUP.replace(", 4, kDiv>", ", 2, kDiv>"))],
    "inflight-64": [(IN_FLIGHT, IN_FLIGHT.replace("32", "64"))],
}
SHAPES = (("dense", 32, 1024), ("large", 4, 8192))
WIDTHS = {"grad": (3, 70, 256), "div": (6, 128, 256)}
K = 20
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(name: str):
    """The variant's library with ``dc_coef_cotangent``."""
    d = OUT / f"cotangent-{name}"
    d.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "coef_cotangent.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} found {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    (d / "coef_cotangent.cu").write_text(text)
    (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    lib = d / "libcotangent.so"
    subprocess.run(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
         str(d / "coef_cotangent.cu")],
        capture_output=True, text=True, check=True)
    so = ctypes.CDLL(str(lib))
    so.dc_coef_cotangent.argtypes = [_P] * 5 + [_I] * 5 + [_L] * 3 + [_I, _P]
    return so


def main(names):
    from deltaconv_tpu_torch.geometry import knn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    libs = {name: build(name) for name in names}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, b, n in SHAPES:
        clouds, _ = cs.ellipsoid_clouds(rng, [n] * b)
        pos = torch.from_numpy(np.stack(clouds)).to(dev)
        idx, _ = knn(pos, K)
        order = ops.coef_plan(pos, idx).order
        for mode, widths in WIDTHS.items():
            for c in widths:
                div = mode == "div"
                feat = torch.randn((b, n, 2, c) if div else (b, n, c),
                                   device=dev)
                ct = torch.randn((b, n, c) if div else (b, n, 2, c),
                                 device=dev)
                want = ops.coef_cotangent(feat, ct, idx)
                out = torch.empty_like(want)
                strides = ct.stride()
                se = 0 if div else strides[2]
                parts = []
                for (name, so), walk in ((lib, walk) for lib in libs.items()
                                         for walk in (None, order)):
                    def call(so=so, walk=walk):
                        return so.dc_coef_cotangent(
                            feat.data_ptr(), ct.data_ptr(), idx.data_ptr(),
                            0 if walk is None else walk.data_ptr(),
                            out.data_ptr(), b, n, c, K, int(div), strides[0],
                            strides[1], se, 0, stream)

                    out.fill_(float("nan"))
                    if call():
                        raise RuntimeError(f"{name}: launch failed")
                    torch.cuda.synchronize()
                    tag = name if walk is None else f"{name}+order"
                    parts.append(f"{tag} {cs.device_ms(call, 10):.4f} ms "
                                 f"(bit-equal {torch.equal(out, want)})")
                print(f"[cotangent-variants] {label} {mode} B={b} N={n} "
                      f"K={K} C={c}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
