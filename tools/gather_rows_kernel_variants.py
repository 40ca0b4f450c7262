"""Design variants of the neighbour-row gather (``gather_rows`` in
``deltaconv_tpu_torch/csrc/gather_rows.cu``, ``dc_gather_rows``), built and
timed side by side on one CUDA card.

Each variant is the checkout's ``gather_rows.cu`` with a few text
substitutions, compiled by ``nvcc`` into a library of its own under
``deltaconv_tpu_torch/_build/variants/`` and called through
``dc_gather_rows`` on the inputs of ``chip_smoke.rows_inputs``: the
operator build's ``[B, 9, K, N]`` at B=32, N=1024; B=16, N=2048, K=30;
B=4, N=8192 (its 295 KB table on the direct route), seg
conv0's C=3, and a 4-rank shard's 16,384 rows against a 65,536-point
table. For each it prints the device time of one call
(``chip_smoke.device_ms``) and whether the output equals
``gather_rows_plain`` bit for bit.

Variants:
  this                 the source as it is;
  chans-8, chans-4     8 or 4 channels' loads before their stores (16);
  stage-max-0          no table staged in shared memory: every shape on the
                       direct route (the earlier kernel);
  other                ``--other DIR``: that checkout's ``gather_rows.cu``
                       as it is (e.g. the parent commit unpacked).

    python3 tools/gather_rows_kernel_variants.py [--other DIR] [variant ...]

Run on a machine with an H100 and the CUDA toolkit, from the checkout's
root or anywhere (the script finds the checkout from its own path).
"""

from __future__ import annotations

import argparse
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
CHANS = "constexpr int kRowsChans = 16;"
STAGE = "constexpr int kRowsStageMax = 96 * 1024;"
VARIANTS = {
    "this": [],
    "chans-8": [(CHANS, CHANS.replace("16", "8"))],
    "chans-4": [(CHANS, CHANS.replace("16", "4"))],
    "stage-max-0": [(STAGE, STAGE.replace("96 * 1024", "0"))],
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name: str, csrc: Path):
    """The variant's library with ``dc_gather_rows``."""
    d = OUT / f"rows-{name}"
    d.mkdir(parents=True, exist_ok=True)
    text = (csrc / "gather_rows.cu").read_text()
    for old, new in VARIANTS.get(name, []):
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} found {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    (d / "gather_rows.cu").write_text(text)
    (d / "common.cuh").write_text((csrc / "common.cuh").read_text())
    lib = d / "librows.so"
    subprocess.run(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
         str(d / "gather_rows.cu")],
        capture_output=True, text=True, check=True)
    so = ctypes.CDLL(str(lib))
    so.dc_gather_rows.argtypes = [_P] * 3 + [_I] * 5 + [_I, _P]
    return so


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", default=None,
                        help="root of another checkout whose gather_rows.cu "
                        "is timed as the variant 'other'")
    parser.add_argument("variants", nargs="*")
    args = parser.parse_args()
    names = args.variants or list(VARIANTS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    libs = {name: build(name, CSRC) for name in names}
    if args.other:
        libs["other"] = build(
            "other", Path(args.other).resolve() / "deltaconv_tpu_torch" /
            "csrc")
    stream = torch.cuda.current_stream().cuda_stream
    for label, table, idx in cs.rows_inputs(np.random.default_rng(0), dev):
        (b, n_t, c), (_, n, k) = table.shape, idx.shape
        want = ops.gather_rows_plain(table, idx)
        out = torch.empty_like(want)
        parts = []
        for name, so in libs.items():
            def call(so=so):
                return so.dc_gather_rows(table.data_ptr(), idx.data_ptr(),
                                         out.data_ptr(), b, n, n_t, c, k, 0,
                                         stream)

            out.fill_(float("nan"))
            if call():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            parts.append(f"{name} {cs.device_ms(call, 10):.4f} ms (bit-equal "
                         f"{torch.equal(out, want)})")
        print(f"[rows-variants] {label} B={b} N={n} Nt={n_t} K={k} C={c}: "
              + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
