"""Design variants of the edge MLP's kernels (``deltaconv_tpu_torch/csrc/
edge_mlp.cu``: the forward ``dc_edge_mlp_fwd``, the backward's phase 1
``dc_edge_mlp_bwd_edges`` and phase 2 ``dc_edge_mlp_bwd_sum``), built and
timed side by side on one CUDA card.

Each variant is the checkout's ``edge_mlp.cu`` with a few text
substitutions, compiled by ``nvcc`` into a library of its own under
``deltaconv_tpu_torch/_build/variants/`` (``-Xptxas -v``: the registers
and spills of the 64 -> 64 instantiations are printed) and called on the
same inputs: the segmentation train shape's first conv (B=16, N=2048,
K=30, C0 = C1 = 64) on an ellipsoid cloud's kNN graph, as ``chip_smoke.py``
makes them. For each it prints the device time of one call of each
kernel (``chip_smoke.device_ms``) and whether its outputs equal the
first variant's bit for bit (every variant but ``no-*`` computes the
same function in the same order). Phase 1 is also timed at several grid
sizes (``--blocks``; the wrapper's is 128), and the whole backward in
groups of G clouds (``--groups``): phase 1 and phase 2 of one group after
the other, the group's edge tensor (G x 7.9 MB) in one reused buffer, so
that phase 2 may read it from the 50 MB L2; the inverse adjacency once
for all clouds.

Variants:
  this            the source as it is;
  bwd-stages-4/6  phase 1's ring of 4 or 6 items (3);
  bwd-groups-2    phase 1 with 2 groups of warps a block (4 at 64 -> 64);
  bwd-no-self     no self sums (wrong values): their f64 share;
  fwd-stages-2/4  the forward warps' ring of 2 or 4 slots (3);
  sum-ahead-4/16  phase 2 with 4 or 16 rows' loads in flight (8);
  sum-ldg         phase 2 reads e through the read-only path (__ldg) in
                  place of evict-first loads (__ldcs);
  fwd-st          the forward's output rows stored as plain stores in
                  place of evict-first ones (__stcs).

    python3 tools/edge_mlp_kernel_variants.py [--blocks 264,396,512,...]
        [--groups 1,2,4,8] [variant ...]

Run on a machine with an H100 and the CUDA toolkit, from the checkout's
root or anywhere (the script finds the checkout from its own path).
"""

from __future__ import annotations

import argparse
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
from deltaconv_tpu_torch.ops import edge_mlp as em  # noqa: E402

CSRC = ROOT / "deltaconv_tpu_torch" / "csrc"
OUT = ROOT / "deltaconv_tpu_torch" / "_build" / "variants"
NVCC = "/usr/local/cuda/bin/nvcc"
BWD_STAGES = "constexpr int kBwdStages = 3;"
FWD_STAGES = "constexpr int kFwdStages = 3;"
AHEAD = "constexpr int kSumAhead = 8;"
GROUPS = "return T1 > 4 ? (T0 >= 8 ? 1 : 8 / T0) : (T0 == 1 ? 8 : 16 / T0);"
SELF = "self_acc[r][v] += (double)dy0[v];"
LOAD = "__ldcs(reinterpret_cast<const uint4*>(eb + at))"
FWD_STORE = """        __stcs(reinterpret_cast<uint4*>(dst + (long long)p * C1 + q * 8),
               *reinterpret_cast<const uint4*>(st + p * LD + q * 8));"""
VARIANTS = {
    "this": [],
    "bwd-stages-4": [(BWD_STAGES, BWD_STAGES.replace("3", "4"))],
    "bwd-stages-6": [(BWD_STAGES, BWD_STAGES.replace("3", "6"))],
    "bwd-groups-2": [(GROUPS, "return T0 == 4 && T1 == 4 ? 2 : "
                      + GROUPS[7:])],
    "bwd-no-self": [(SELF, "")],
    "fwd-stages-2": [(FWD_STAGES, FWD_STAGES.replace("3", "2"))],
    "fwd-stages-4": [(FWD_STAGES, FWD_STAGES.replace("3", "4"))],
    "sum-ahead-4": [(AHEAD, AHEAD.replace("8", "4"))],
    "sum-ahead-16": [(AHEAD, AHEAD.replace("8", "16"))],
    "sum-ldg": [(LOAD, LOAD.replace("__ldcs", "__ldg"))],
    "fwd-st": [(FWD_STORE, """        *reinterpret_cast<uint4*>(dst + (long long)p * C1 + q * 8) =
            *reinterpret_cast<const uint4*>(st + p * LD + q * 8);""")],
}
B, N, K, C = 16, 2048, 30, 64
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name: str):
    """The variant's library and ``ptxas``' lines for the 64 -> 64
    kernels (and phase 2's at C0 = 64)."""
    d = OUT / f"edge-{name}"
    d.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "edge_mlp.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} found {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    (d / "edge_mlp.cu").write_text(text)
    (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    lib = d / "libedge.so"
    out = subprocess.run(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
         str(lib), str(d / "edge_mlp.cu")],
        capture_output=True, text=True, check=True)
    info, entry = [], None
    for line in out.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("ILi4ELi4E" in entry or "ILi8EEv" in entry) and (
                "Used" in line or "spill" in line):
            kernel = re.search(r"edge_mlp_[a-z_]+kernel", entry).group(0)
            info.append(f"{kernel}: {line.split(':')[-1].strip()}")
    so = ctypes.CDLL(str(lib))
    so.dc_edge_mlp_fwd.argtypes = [_P] * 6 + [_I] * 5 + [_I, _P]
    so.dc_edge_mlp_bwd_edges.argtypes = [_P] * 9 + [_I] * 6 + [_I, _P]
    so.dc_edge_mlp_bwd_sum.argtypes = [_P] * 5 + [_I] * 4 + [_I, _P]
    return so, info


def inputs(dev):
    from deltaconv_tpu_torch.geometry import knn

    rng = np.random.default_rng(0)
    clouds, _ = cs.ellipsoid_clouds(rng, [N] * B)
    idx, _ = knn(torch.from_numpy(np.stack(clouds)).to(dev), K)
    y, a0, b0, w1, z0 = cs.edge_inputs(idx, dev)
    g = torch.randn((B, K, N, C), device=dev).to(torch.bfloat16)
    yp, ab, wp = em._operands(y, a0, b0, w1)
    return yp, ab, wp, z0.contiguous(), idx, g


class Calls:
    """The three kernels of one library on the shared inputs, with their
    outputs preallocated."""

    def __init__(self, so, yp, ab, wp, z0, idx, g):
        self.so, self.args = so, (yp, ab, wp, z0, idx, g)
        dev = yp.device
        self.out = torch.empty((B, K, N, C), dtype=torch.bfloat16,
                               device=dev)
        self.e = torch.empty((B, K, N, C), dtype=torch.bfloat16, device=dev)
        self.s = torch.empty((B, N, C), dtype=torch.float64, device=dev)
        self.dy = torch.empty((B, N, C), dtype=torch.float32, device=dev)
        self.inv = ops.inverse_adjacency(idx, N, clamp=True)
        self.stream = torch.cuda.current_stream().cuda_stream

    def fwd(self):
        yp, ab, wp, z0, idx, _ = self.args
        return self.so.dc_edge_mlp_fwd(
            yp.data_ptr(), idx.data_ptr(), ab.data_ptr(), wp.data_ptr(),
            z0.data_ptr(), self.out.data_ptr(), B, N, K, C, C, 0,
            self.stream)

    def edges(self, blocks, b0=0, nb=B, e=None, parts=None):
        yp, ab, wp, _, idx, g = self.args
        e = self.e if e is None else e
        if parts is None:
            parts = (torch.empty((blocks, C, C), device=yp.device),
                     torch.empty((blocks, 2, C), device=yp.device))
        return self.so.dc_edge_mlp_bwd_edges(
            yp[b0].data_ptr(), idx[b0].data_ptr(), ab.data_ptr(),
            wp.data_ptr(), g[b0].data_ptr(), e.data_ptr(),
            self.s[b0].data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
            nb, N, K, C, C, blocks, 0, self.stream)

    def sum(self, b0=0, nb=B, e=None):
        e = self.e if e is None else e
        off, lst = self.inv
        return self.so.dc_edge_mlp_bwd_sum(
            e.data_ptr(), self.s[b0].data_ptr(), off[b0].data_ptr(),
            lst[b0].data_ptr(), self.dy[b0].data_ptr(), nb, N, K, C, 0,
            self.stream)

    def grouped(self, size):
        """The whole backward in groups of ``size`` clouds, the groups'
        edge tensor in one buffer; the inverse adjacency once."""
        dev = self.e.device
        e = self.e[:size]
        self.inv = ops.inverse_adjacency(self.args[4], N, clamp=True)
        blocks = max(1, min(em._BWD_BLOCKS, size * (N // 16) // 4))
        parts = (torch.empty((B // size, blocks, C, C), device=dev),
                 torch.empty((B // size, blocks, 2, C), device=dev))
        for i, b0 in enumerate(range(0, B, size)):
            if self.edges(blocks, b0, size, e, (parts[0][i], parts[1][i])):
                raise RuntimeError("phase 1 launch failed")
            if self.sum(b0, size, e):
                raise RuntimeError("phase 2 launch failed")
        return parts[0].sum(dim=(0, 1)), parts[1].sum(dim=(0, 1))


def run(name, blocks, groups, first):
    """One variant in this process; the first one saves its outputs, the
    others compare theirs with them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    data = inputs(dev)
    so, info = build(name)
    calls = Calls(so, *data)
    for line in info:
        print(f"[edge-variants] {name} ptxas {line}", flush=True)
    for fn in (calls.fwd, lambda: calls.edges(em._BWD_BLOCKS), calls.sum):
        if fn():
            raise RuntimeError(f"{name}: launch failed")
    torch.cuda.synchronize()
    got = [calls.out, calls.e[:, 1:], calls.s, calls.dy]
    if first:
        torch.save([t.cpu() for t in got], OUT / "edge-first.pt")
    ref = torch.load(OUT / "edge-first.pt")
    same = [torch.equal(a.cpu(), b) for a, b in zip(got, ref)]
    parts = [f"fwd {cs.device_ms(calls.fwd, 10):.4f}",
             f"phase 1 "
             f"{cs.device_ms(lambda: calls.edges(em._BWD_BLOCKS), 10):.4f}",
             f"phase 2 {cs.device_ms(calls.sum, 10):.4f}"]
    print(f"[edge-variants] {name} B={B} N={N} K={K} {C}->{C}: "
          + "; ".join(parts) + f" ms of device time; bit-equal to the "
          f"first variant (out, e, self, dy): {same}", flush=True)
    if not first:
        return
    for nb in blocks:
        ms = cs.device_ms(lambda: calls.edges(nb), 10)
        print(f"[edge-variants] {name} phase 1 at {nb} blocks: {ms:.4f} ms "
              f"(bit-equal e {torch.equal(calls.e[:, 1:].cpu(), ref[1])})",
              flush=True)
    for size in groups:
        ms = cs.device_ms(lambda: calls.grouped(size), 10)
        print(f"[edge-variants] {name} backward in groups of {size} clouds: "
              f"{ms:.4f} ms (the partials' sums included; dy bit-equal "
              f"{torch.equal(calls.dy.cpu(), ref[3])})", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--blocks", default="64,128,132,256")
    parser.add_argument("--groups", default="1,2,4,8,16")
    parser.add_argument("--first", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("variants", nargs="*")
    args = parser.parse_args()
    names = args.variants or list(VARIANTS)
    if len(names) == 1:  # each variant's library in a process of its own
        run(names[0], [int(b) for b in args.blocks.split(",")],
            [int(g) for g in args.groups.split(",")], args.first)
        return
    print(f"card: {cs.card_line()}", flush=True)
    for i, name in enumerate(names):
        subprocess.run([sys.executable, __file__, name, "--blocks",
                        args.blocks, "--groups", args.groups]
                       + (["--first"] if i == 0 else []), check=True)


if __name__ == "__main__":
    main()
