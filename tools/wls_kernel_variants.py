"""Design variants of the WLS split kernels (``deltaconv_tpu_torch/csrc/
wls.cu``) and of the fused eval build's split kernel (``fused_build.cu``),
built and timed side by side on one CUDA card.

Each variant is the checkout's ``wls.cu``, ``fused_build.cu``,
``wls_split.cuh`` and ``wls_body.cuh`` with a few text substitutions,
compiled by ``nvcc`` into a library of its own under
``deltaconv_tpu_torch/_build/variants/`` and called through its C entry
points (``dc_wls``, ``dc_wls_bwd``, ``dc_fused_gather_wls``) on the same
inputs. For each it prints the registers and spills that ``ptxas -v``
reports for every instance of the split kernels and their SASS
instruction counts (``cuobjdump``), then, at the model shapes (B=32,
N=1024, K=20; B=16, N=2048, K=30; B=4, N=8192, K=20; ellipsoid clouds,
kNN graphs, cloud 0 40% padded), the device time of one call of each
kernel (``chip_smoke.device_ms``) on the split route's warps and the
deviation from the plain versions (forward: max abs error; VJP: the worst
plane's error over its max; fused build: the worst output's error over
its max, on the same clouds' packed kNN graph with every slot valid).

Variants:
  this          the sources as they are;
  sums-unrolled the slices' sums with their loop over a runtime S left
                to the compiler's unrolling (as first written);
  bwd-rolled    the backward's loops over its slots not unrolled (its
                per-slot arrays in local memory);
  bwd-168, bwd-128  the backward held to 168 or 128 registers;
  fwd-free      the forward's register limit lifted;
  fused-96      the fused build's split kernel held to the forward's 96
                registers;
  fused-direct-stores  the fused build's split kernel storing each
                coefficient straight to its place in device memory (a
                lane's K values contiguous, lanes K floats apart) in place
                of the block's shared-memory tile and its row writes.

    python3 tools/wls_kernel_variants.py [variant ...]

Run on a machine with an H100 and the CUDA toolkit, from the checkout's
root or anywhere (the script finds the checkout from its own path).
"""

from __future__ import annotations

import ctypes
import re
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
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
FWD = "__maxnreg__(kFwdRegs)\n    wls_split_kernel"
FUSED = "__launch_bounds__(kPoints * kMaxSlices)\n    fused_gather_wls_kernel("
BWD = "__launch_bounds__(kPoints * kMaxSlices)\n    wls_split_bwd_kernel"
# The slices' sums as first written: for each entry a loop over the
# slices, which the compiler unrolled over the runtime S.
SUMS = (
    "    const float* part = buf + lane;\n"
    "#pragma unroll\n"
    "    for (int i = 0; i < n; ++i) v[i] = part[i * kPoints];\n"
    "#pragma unroll 1\n"
    "    for (int q = 1; q < S; ++q) {\n"
    "      part += wls::NA * kPoints;\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < n; ++i) v[i] += part[i * kPoints];\n"
    "    }\n")
SUMS_FIRST = (
    "#pragma unroll\n"
    "    for (int i = 0; i < n; ++i) {\n"
    "      float t = buf[i * kPoints + lane];\n"
    "      for (int q = 1; q < S; ++q) t += buf[(q * wls::NA + i) * kPoints"
    " + lane];\n"
    "      v[i] = t;\n"
    "    }\n")
SLOT_LOOP = "#pragma unroll\n  for (int j = 0; j < E; ++j)"


def _bwd_rolled(body: str) -> str:
    start = body.index("WLS_FN void wls_split_bwd(")
    return body[:start] + body[start:].replace(
        SLOT_LOOP, SLOT_LOOP.replace("unroll", "unroll 1"))


# The fused split kernel's stores through its tile, and straight to memory.
TILE_STORES = (
    "      [&](int k, float g1, float g2, float d1, float d2) {\n"
    "        mine[k] = g1;\n"
    "        mine[tk + k] = g2;\n"
    "        mine[2 * tk + k] = d1;\n"
    "        mine[3 * tk + k] = d2;\n"
    "      });\n")
DIRECT_STORES = (
    "      [&](int k, float g1, float g2, float d1, float d2) {\n"
    "        const long long o = (b * 2 * N + n) * (long long)K + k;\n"
    "        grad_coef[o] = g1;\n"
    "        grad_coef[o + (long long)N * K] = g2;\n"
    "        div_coef[o] = d1;\n"
    "        div_coef[o + (long long)N * K] = d2;\n"
    "      });\n")
TILE_LOOP = "  for (int e = s * kPoints + lane; e < count; e += S * kPoints) {"
NO_LOOP = "  for (int e = count; e < count; ++e) {"

# name -> (substitutions in wls.cu, fused_build.cu or wls_split.cuh,
# transform of wls_body.cuh)
VARIANTS = {
    "this": ([], None),
    "sums-unrolled": ([(SUMS, SUMS_FIRST)], None),
    "bwd-rolled": ([], _bwd_rolled),
    "bwd-168": ([(BWD, "__maxnreg__(168)\n    wls_split_bwd_kernel")], None),
    "bwd-128": ([(BWD, "__maxnreg__(128)\n    wls_split_bwd_kernel")], None),
    "fwd-free": ([(FWD, "__launch_bounds__(kPoints * kMaxSlices)\n"
                        "    wls_split_kernel")], None),
    "fused-96": ([(FUSED, "__maxnreg__(kFwdRegs)\n"
                          "    fused_gather_wls_kernel(")], None),
    "fused-direct-stores": ([(TILE_STORES, DIRECT_STORES),
                             (TILE_LOOP, NO_LOOP)], None),
}
SOURCES = ("wls.cu", "fused_build.cu", "wls_split.cuh")
KERNELS = r"(wls_split(?:_bwd)?_kernel|fused_gather_wls_kernel)ILi(\d)"
SHAPES = (("cls", 32, 1024, 20), ("seg", 16, 2048, 30),
          ("large", 4, 8192, 20))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(name: str):
    """The variant's library, after printing its registers, spills and
    SASS instruction counts."""
    subs, body_fn = VARIANTS[name]
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    srcs = {f: (CSRC / f).read_text() for f in SOURCES}
    for old, new in subs:
        where = [f for f, text in srcs.items() if old in text]
        if len(where) != 1:
            raise ValueError(f"{name}: {old!r} in {where}, not in one source")
        srcs[where[0]] = srcs[where[0]].replace(old, new)
    body = (CSRC / "wls_body.cuh").read_text()
    for f, text in srcs.items():
        (d / f).write_text(text)
    (d / "wls_body.cuh").write_text(body_fn(body) if body_fn else body)
    (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    lib = d / "libwls.so"
    out = subprocess.run(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
         str(lib), str(d / "wls.cu"), str(d / "fused_build.cu")],
        capture_output=True, text=True, check=True)
    kernel, regs = None, []
    for line in out.stderr.splitlines():
        m = re.search(r"Compiling entry function '\S*?" + KERNELS, line)
        if m:
            kernel, spill = f"{m.group(1)}<{m.group(2)}>", 0
        elif "Compiling entry" in line:
            kernel = None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            regs.append(f"{kernel} {m.group(1)} registers, {spill} bytes "
                        f"spilled")
    sass = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    sizes, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?" + KERNELS, line)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}>"
            sizes[fn] = 0
        elif "Function :" in line:
            fn = None
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[fn] += 1
    print(f"[{name}] ptxas: " + "; ".join(regs), flush=True)
    print(f"[{name}] SASS instructions: " + "; ".join(
        f"{k} {v}" for k, v in sizes.items()), flush=True)
    so = ctypes.CDLL(str(lib))
    so.dc_wls.argtypes = [_P] * 3 + [_I] * 4 + [_F] * 2 + [_I, _P]
    so.dc_wls_bwd.argtypes = [_P] * 4 + [_I] * 4 + [_F] * 2 + [_I, _P]
    so.dc_fused_gather_wls.argtypes = [_P] * 10 + [_I] * 4 + [_F] * 2 + [
        _I, _P]
    return so


def fused_inputs(rng, b, n, k, dev):
    """The fused build's inputs on ``b`` ellipsoid clouds of ``n`` points:
    positions, normals, frames, the packed kNN graph (every slot valid)
    and the clouds' mean neighbour distances."""
    from deltaconv_tpu_torch.geometry import build_tangent_basis

    clouds, normals = cs.ellipsoid_clouds(rng, [n] * b)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    idx, md = ops.knn_topk(pos, k, True, return_mean_dist=True)
    mask = torch.ones(idx.shape, dtype=torch.uint8, device=dev)
    return (pos, nrm, *build_tangent_basis(nrm), idx, mask,
            md.mean(dim=1).contiguous())


def main(names):
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    libs = {name: build(name) for name in names}
    rng = np.random.default_rng(0)
    frng = np.random.default_rng(1)  # the fused build's clouds
    wf = ops.wls_fused
    for label, b, n, k in SHAPES:
        fused = fused_inputs(frng, b, n, k, dev)
        fused_want = ops.fused_gather_wls_plain(*fused)
        fused_out = tuple(torch.empty_like(t) for t in fused_want)
        edges = cs.wls_edges(rng, b, n, k, dev, masked=True)
        ctg = torch.randn((b, 2, k, n), device=dev)
        ctd = torch.randn((b, 2, k, n), device=dev)
        g0, d0 = ops.wls_plain(edges, 1.0, 1e-3)
        de0 = ops.wls_bwd_plain(edges, ctg, ctd, 1.0, 1e-3)
        g, d, de = torch.empty_like(g0), torch.empty_like(d0), \
            torch.empty_like(edges)
        stream = torch.cuda.current_stream().cuda_stream
        for name, so in libs.items():
            parts = []
            for bwd in (False, True):
                s = wf.wls_split(k)[0]
                if bwd:
                    def call(s=s):
                        return so.dc_wls_bwd(
                            edges.data_ptr(), ctg.data_ptr(), ctd.data_ptr(),
                            de.data_ptr(), b, k, n, s, 1.0, 1e-3, 0, stream)
                else:
                    def call(s=s):
                        return so.dc_wls(edges.data_ptr(), g.data_ptr(),
                                         d.data_ptr(), b, k, n, s, 1.0, 1e-3,
                                         0, stream)
                if call():
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                err = (cs._plane_rel(de, de0) if bwd else
                       max(cs.max_err(g, g0), cs.max_err(d, d0)))
                parts.append(f"{'wls_bwd' if bwd else 'wls'} (S={s}) "
                             f"{cs.device_ms(call, 10):.4f} ms (error "
                             f"{err:.2e})")

            def call(s=wf.wls_split(k)[0], so=so):
                return so.dc_fused_gather_wls(
                    *(t.data_ptr() for t in fused + fused_out), b, n, k, s,
                    1.0, 1e-3, 0, stream)

            if call():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = max(cs.max_err(a, w) / float(w.abs().max())
                      for a, w in zip(fused_out, fused_want))
            parts.append(f"fused_gather_wls {cs.device_ms(call, 10):.4f} ms "
                         f"(error {err:.2e} x max)")
            print(f"[{name}] {label} B={b} N={n} K={k}: " + "; ".join(parts),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
