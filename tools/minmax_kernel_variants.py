"""Design variants of the neighbour min/max's route S (the min/max mode of
the staged kernel in ``deltaconv_tpu_torch/csrc/gather_max.cu``) and of the
matmul min/max's one-product-a-row kernel (its min/max mode in
``gather_matmul_max_rows.cuh``), built and timed side by side on one CUDA
card, with the registers and spills that ``ptxas -v`` reports for each
min/max instantiation.

Each variant is the checkout's ``gather_max.cu``, ``gather_max_bf16.cu``
and ``gather_matmul_max_rows.cuh`` with a few text substitutions, compiled
by ``nvcc -Xptxas -v`` (one process a source, every variant at once) into
a library of its own under ``deltaconv_tpu_torch/_build/variants/`` and
called through its C entry points on the same inputs: ellipsoid clouds'
kNN graphs (K=20) at B=32, N=1024 (f32 C = 256 and 16, bf16 C = 128 and
16: 128-byte rows, and the 64- and 32-byte rows that the max runs at two
blocks an SM) and B=4, N=8192 (f32 C=256, 16-byte rows), each body with
and without winners on the slice and splits that ``max_slice`` picks;
``gather_matmul_minmax`` at 128 -> 256 on ``mm_slice``'s slice at both
shapes. For each it prints the device time of one call
(``chip_smoke.device_ms``) and whether the outputs equal the plain
versions bit for bit (the matmul form: whether they equal this tree's
kernel). As a control, each body's max alone (#8's route S,
``dc_gather_max`` and ``dc_gather_max_win``, whose max phase the min/max
mode shares) is timed the same way; with ``--other DIR`` also from the
sources of the checkout at DIR (another variant, ``other``, timed on the
max alone: its min/max entry points may take other arguments).

Variants:
  this       the sources as they are (the min/max at one block an SM);
  blocks-2   the min/max takes the max's rule: two blocks an SM (64
             registers) at 32- and 64-byte rows;
  flight-8   eight rows a lane in flight before the compares, in place of
             four (every mode of the max phase; only the min/max timed).

    python3 tools/minmax_kernel_variants.py [--other DIR] [variant ...]

Run on a machine with an H100 and the CUDA toolkit, from the checkout's
root or anywhere (the script finds the checkout from its own path).
"""

from __future__ import annotations

import ctypes
import importlib
import re
import subprocess
import sys
import time
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
FILT = "/usr/local/cuda/bin/cu++filt"
SOURCES = ("gather_max.cu", "gather_max_bf16.cu",
           "gather_matmul_max_rows.cuh")
HEADERS = ("common.cuh", "gather_matmul_max.cuh")
BLOCKS = "kEpi == kEpiMinMax ? kMinMaxBlocks\n                       : "
FLIGHT = "constexpr int kRowsInFlight = 4;"

# name -> substitutions in one of SOURCES each
VARIANTS = {
    "this": [],
    "blocks-2": [(BLOCKS, "")],
    "flight-8": [(FLIGHT, FLIGHT.replace("4", "8"))],
}
# (label, B, N, widths): f32 and bf16 widths of the min/max bodies.
SHAPES = (("cls", 32, 1024, ((torch.float32, (256, 16)),
                              (torch.bfloat16, (128, 16)))),
          ("large", 4, 8192, ((torch.float32, (256,)),)))
K, MM_IN, MM_OUT = 20, 128, 256
_P, _I = ctypes.c_void_p, ctypes.c_int


def ptxas_lines(log: str) -> list[str]:
    """The ptxas lines (registers, spills) of the min/max instantiations,
    matched on their mangled names: the staged kernel with kEpi 4 (its
    template arguments end in ``Li4EE``) and the rows kernel with kMinMax
    (``Lb1EE``); each under its demangled name."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            name = None
            if re.search(r"staged_kernelI\w+?ELi4EE|rows_kernelI\w*Lb1EE",
                         m.group(1)):
                name = subprocess.run([FILT, m.group(1)],
                                      capture_output=True,
                                      text=True).stdout.strip()
                name = re.match(r"(.*?>)\(", name + "(").group(1)
            continue
        if name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    return out


def sources(name: str, csrc: Path) -> Path:
    """The variant's sources (from ``csrc``), written under its own
    directory."""
    d = OUT / f"minmax-{name}"
    d.mkdir(parents=True, exist_ok=True)
    srcs = {f: (csrc / f).read_text() for f in SOURCES}
    for old, new in VARIANTS.get(name, []):
        where = [f for f, text in srcs.items() if old in text]
        if len(where) != 1:
            raise ValueError(f"{name}: {old!r} in {where}, not in one source")
        srcs[where[0]] = srcs[where[0]].replace(old, new)
    for f, text in srcs.items():
        (d / f).write_text(text)
    for f in HEADERS:
        (d / f).write_text((csrc / f).read_text())
    return d


def build(names, other=None):
    """Each variant's library and its ptxas lines: one ``nvcc -c`` per
    (variant, source), all at once, then one link a variant; ``other``:
    the csrc directory of the variant ``other``."""
    dirs = {name: sources(name, CSRC) for name in names}
    if other is not None:
        dirs["other"] = sources("other", other)
    procs = {(name, src): subprocess.Popen(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o",
         str(d / f"{src}.o"), str(d / src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, d in dirs.items() for src in SOURCES[:2]}
    logs = {key: proc.communicate()[0] for key, proc in procs.items()}
    for key, proc in procs.items():
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{logs[key][-4000:]}")
    libs = {}
    for name, d in dirs.items():
        lib = d / "libminmax.so"
        subprocess.run([NVCC, "-shared", "-o", str(lib),
                        *(str(d / f"{src}.o") for src in SOURCES[:2])],
                       check=True)
        so = ctypes.CDLL(str(lib))
        for fn, n_ptr in (("dc_gather_max", 4), ("dc_gather_max_bf16", 4),
                          ("dc_gather_max_win", 5),
                          ("dc_gather_max_win_bf16", 5),
                          ("dc_gather_minmax", 5),
                          ("dc_gather_minmax_bf16", 5),
                          ("dc_gather_minmax_win", 7),
                          ("dc_gather_minmax_win_bf16", 7)):
            getattr(so, fn).argtypes = [_P] * n_ptr + [_I] * 6 + [_I, _P]
        so.dc_gather_matmul_minmax.argtypes = [_P] * 6 + [_I] * 6 + [_I, _P]
        libs[name] = so, ptxas_lines("".join(logs[(name, src)]
                                             for src in SOURCES[:2]))
    return libs


def timed(label, kern, libs, call_of, used, want, extra=""):
    """One line: the device time of ``kern`` in each library of ``libs``
    (``call_of(so)`` a launch into ``used``), bit-equal to ``want``."""
    parts = []
    for name, (so, _) in libs.items():
        call = call_of(so)
        for o in used:
            o.fill_(7)
        if call():
            raise RuntimeError(f"{name} {kern}: launch failed")
        torch.cuda.synchronize()
        same = all(torch.equal(o, w) for o, w in zip(used, want))
        parts.append(f"{name} {cs.device_ms(call, 10):.4f} ms (bit-equal "
                     f"{same})")
    print(f"[minmax-variants] {label} {kern}{extra}: " + "; ".join(parts),
          flush=True)


def main(argv):
    from deltaconv_tpu_torch.geometry import knn

    other = None
    if argv[:1] == ["--other"]:
        other = Path(argv[1]).resolve() / "deltaconv_tpu_torch" / "csrc"
        argv = argv[2:]
    names = argv or list(VARIANTS)
    gm = importlib.import_module("deltaconv_tpu_torch.ops.gather_max")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = build(names, other)
    print(f"[minmax-ptxas] built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, lines) in libs.items():
        for line in lines if name != "other" else ():
            print(f"[minmax-ptxas] {name}: {line}", flush=True)
    own = {name: lib for name, lib in libs.items() if name != "other"}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    for label, b, n, bodies in SHAPES:
        clouds, _ = cs.ellipsoid_clouds(rng, [n] * b)
        idx, mask = knn(torch.from_numpy(np.stack(clouds)).to(dev), K)
        for dt, widths in bodies:
            sfx = "_bf16" if dt == torch.bfloat16 else ""
            for c in widths:
                h = torch.randn((b, n, c), device=dev).to(dt)
                want = ops.gather_minmax_win_plain(h, idx, mask)
                want_max = ops.gather_max_win_plain(h, idx, mask)
                outs = [torch.empty_like(h), torch.empty_like(h),
                        torch.empty((b, n, c), dtype=torch.int32, device=dev),
                        torch.empty((b, n, c), dtype=torch.int32, device=dev)]
                for winners in (False, True):
                    slc, splits = gm.max_slice(b, n, c, h.element_size(), K,
                                               sms, winners)
                    extra = f" B={b} N={n} K={K} C={c}, slice {slc} x {splits}"
                    win = "_win" if winners else ""
                    # The max alone (the control), into out and winner.
                    used = [outs[0], outs[2]] if winners else outs[:1]
                    timed(label, f"gather_max{win}{sfx}", libs,
                          lambda so, kern=f"dc_gather_max{win}{sfx}",
                          used=used, slc=slc, splits=splits: lambda: getattr(
                              so, kern)(h.data_ptr(), idx.data_ptr(),
                                        mask.data_ptr(),
                                        *(o.data_ptr() for o in used), b, n,
                                        c, K, slc, splits, 0, stream),
                          used, want_max if winners else want_max[:1], extra)
                    used = outs if winners else outs[:2]
                    timed(label, f"gather_minmax{win}{sfx}", own,
                          lambda so, kern=f"dc_gather_minmax{win}{sfx}",
                          used=used, slc=slc, splits=splits: lambda: getattr(
                              so, kern)(h.data_ptr(), idx.data_ptr(),
                                        mask.data_ptr(),
                                        *(o.data_ptr() for o in used), b, n,
                                        c, K, slc, splits, 0, stream),
                          used, want, extra)
        x = torch.randn((b, n, MM_IN), device=dev).to(torch.bfloat16)
        w = (torch.randn((MM_IN, MM_OUT), device=dev) / 8).to(torch.bfloat16)
        ref = ops.gather_matmul_minmax(x, w, idx, mask)
        slc = gm.mm_slice(b, n, MM_IN, MM_OUT, K, sms)
        outs = [torch.empty((b, n, MM_OUT), dtype=torch.bfloat16, device=dev)
                for _ in range(2)]
        timed(label, "gather_matmul_minmax", own,
              lambda so: lambda: so.dc_gather_matmul_minmax(
                  x.data_ptr(), w.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                  *(o.data_ptr() for o in outs), b, n, MM_IN, MM_OUT, K, slc,
                  0, stream), outs, ref,
              f" B={b} N={n} K={K} {MM_IN}->{MM_OUT}, slice {slc} (bit-equal: "
              f"to this tree's kernel)")


if __name__ == "__main__":
    main(sys.argv[1:])
