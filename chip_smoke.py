#!/usr/bin/env python3
"""Smoke test of deltaconv_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed S]

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit. It

1. requires a card and prints its ``nvidia-smi`` name and power limit;
2. builds the four CUDA kernels from ``deltaconv_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card at
   the serving path's shapes (B=32, N=1024, K=20; C = 64, 128, 256 for
   the neighbour max), uniform and masked, and times both (CUDA events,
   median of 30 runs);
4. serves 64 uniform and 11 ragged clouds with normals through
   ``InferenceEngine`` on ``DeltaNetClassification(num_classes=40)`` at
   the reference width, weights drawn from a seeded generator with
   randomized BatchNorm statistics, counting each kernel's launches;
5. checks the logits: finite, of the right shape, equal (atol 1e-3, same
   argmax) to the same engine run through the plain versions on the
   card, and a full cloud's logits the same served ragged or uniform.

Any failed phase raises (non-zero exit). The last two lines are a JSON
record of the kernels and ``{"ok": true, "device": ...}``. Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

B, N, K = 32, 1024, 20
GATHER_MAX_WIDTHS = (64, 128, 256)
REPS = 30
LOGIT_ATOL = 1e-3
WLS_ATOL = 1e-5  # FMA contraction and K-sum order
DENSIFY_ATOL = 1e-6  # duplicate columns may sum in another order

KERNEL_META = {
    "gather_rows": ("deltaconv_tpu_torch/csrc/gather_rows.cu",
                    "deltaconv_tpu/ops/gather_rows.py:205"),
    "wls": ("deltaconv_tpu_torch/csrc/wls.cu",
            "deltaconv_tpu/ops/wls_fused.py:162"),
    "densify": ("deltaconv_tpu_torch/csrc/densify.cu",
                "deltaconv_tpu/ops/densify_op.py:249"),
    "gather_max": ("deltaconv_tpu_torch/csrc/gather_max.cu",
                   "deltaconv_tpu/ops/gather_max.py:230"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def ellipsoid_clouds(rng, sizes):
    """Clouds on random axis-aligned ellipsoids with analytic normals."""
    clouds, normals = [], []
    for n in sizes:
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        nrm = d / axes
        clouds.append(d * axes)
        normals.append(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    return clouds, normals


def median_ms(fn) -> float:
    """Median CUDA-event time of ``fn`` over REPS runs, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def check(name, ok, detail):
    print(f"  {name}: {detail} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def kernel_phase(rng, dev, card):
    """Each kernel against its plain version at the serving shapes."""
    from deltaconv_tpu_torch import ops
    from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
    from deltaconv_tpu_torch.ops.wls_fused import edge_planes

    clouds, normals = ellipsoid_clouds(rng, [N] * B)
    pos = torch.from_numpy(np.stack(clouds)).to(dev)
    nrm = torch.from_numpy(np.stack(normals)).to(dev)
    xb, yb = build_tangent_basis(nrm)
    # Masked case: the last 40% of the points of every other cloud are
    # padding, the serving path's ragged batch.
    pmask = torch.ones((B, N), dtype=torch.bool, device=dev)
    pmask[::2, int(0.6 * N):] = False
    cases = {}
    for label, mask in (("uniform", None), ("masked", pmask)):
        idx, nbr_mask = knn(pos, K, mask)
        if mask is not None:
            nbr_mask = nbr_mask & mask[:, :, None]
        cases[label] = (idx, nbr_mask)

    res = {name: {"max_abs_err": 0.0} for name in KERNEL_META}
    table = torch.cat([pos, xb, yb], dim=-1).contiguous()
    for label, (idx, nbr_mask) in cases.items():
        print(f"[kernels] {label}", flush=True)
        got = ops.gather_rows(table, idx)
        want = ops.gather_rows_plain(table, idx)
        err = max_err(got, want)
        res["gather_rows"]["max_abs_err"] = max(
            res["gather_rows"]["max_abs_err"], err)
        check("gather_rows", torch.equal(got, want), f"max_abs_err {err}")

        pm = nbr_mask.any(dim=2).to(torch.float32)
        edges = edge_planes(pos, nrm, xb, yb, idx, nbr_mask, pm,
                            ops.gather_rows_plain)
        g, d = ops.wls(edges, 1.0, 1e-3)
        gp, dp = ops.wls_plain(edges, 1.0, 1e-3)
        err = max(max_err(g, gp), max_err(d, dp))
        scale = float(max(gp.abs().max(), dp.abs().max()))
        res["wls"]["max_abs_err"] = max(res["wls"]["max_abs_err"], err)
        check("wls", err <= WLS_ATOL,
              f"max_abs_err {err} <= {WLS_ATOL} (max |coef| {scale})")
        gd_k = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
        gd_p = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask,
                                        gather_rows_fn=ops.gather_rows_plain,
                                        wls_fn=ops.wls_plain)
        err = max(max_err(gd_k.grad_coef, gd_p.grad_coef),
                  max_err(gd_k.div_coef, gd_p.div_coef))
        res["wls"]["max_abs_err"] = max(res["wls"]["max_abs_err"], err)
        check("wls (normalized operator)", err <= WLS_ATOL,
              f"max_abs_err {err} <= {WLS_ATOL}")

        gc, dc = gd_p.grad_coef, gd_p.div_coef
        wg, wd = ops.densify_coefs(idx, gc, dc)
        wgp, wdp = ops.densify_coefs_plain(idx, gc, dc)
        err = max(max_err(wg, wgp), max_err(wd, wdp))
        res["densify"]["max_abs_err"] = max(res["densify"]["max_abs_err"],
                                            err)
        check("densify", err <= DENSIFY_ATOL,
              f"max_abs_err {err} <= {DENSIFY_ATOL}")
        del wg, wd, wgp, wdp

        for c in GATHER_MAX_WIDTHS:
            h = torch.randn((B, N, c), device=dev)
            got = ops.gather_max(h, idx, nbr_mask)
            want = ops.gather_max_plain(h, idx, nbr_mask)
            err = max_err(got, want)
            res["gather_max"]["max_abs_err"] = max(
                res["gather_max"]["max_abs_err"], err)
            check(f"gather_max C={c}", torch.equal(got, want),
                  f"max_abs_err {err}")

    # Times at the uniform serving shapes.
    idx, nbr_mask = cases["uniform"]
    pm = nbr_mask.any(dim=2).to(torch.float32)
    edges = edge_planes(pos, nrm, xb, yb, idx, nbr_mask, pm,
                        ops.gather_rows_plain)
    gd = ops.build_grad_div_fused(pos, nrm, xb, yb, idx, nbr_mask)
    timed = {
        "gather_rows": (lambda: ops.gather_rows(table, idx),
                        lambda: ops.gather_rows_plain(table, idx)),
        "wls": (lambda: ops.wls(edges, 1.0, 1e-3),
                lambda: ops.wls_plain(edges, 1.0, 1e-3)),
        "densify": (lambda: ops.densify_coefs(idx, gd.grad_coef,
                                              gd.div_coef),
                    lambda: ops.densify_coefs_plain(idx, gd.grad_coef,
                                                    gd.div_coef)),
    }
    print(f"[times] median of {REPS} CUDA-event runs, B={B} N={N} K={K}, "
          f"card: {card}")
    for name, (fk, fp) in timed.items():
        res[name]["ms"] = median_ms(fk)
        res[name]["plain_ms"] = median_ms(fp)
        print(f"  {name}: kernel {res[name]['ms']:.4f} ms, "
              f"plain {res[name]['plain_ms']:.4f} ms")
    for c in GATHER_MAX_WIDTHS:
        h = torch.randn((B, N, c), device=dev)
        km = median_ms(lambda: ops.gather_max(h, idx, nbr_mask))
        pl = median_ms(lambda: ops.gather_max_plain(h, idx, nbr_mask))
        print(f"  gather_max C={c}: kernel {km:.4f} ms, plain {pl:.4f} ms")
        res["gather_max"]["ms"], res["gather_max"]["plain_ms"] = km, pl
    print("  (the JSON record gives gather_max at C=256)")
    return res


def random_model(seed, dev):
    """The reference-width classifier with seeded weights and randomized
    BatchNorm statistics, scales (both signs) and biases."""
    from deltaconv_tpu_torch import DeltaNetClassification
    from deltaconv_tpu_torch.nn import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    model = DeltaNetClassification(num_classes=40, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(-1.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    return model.to(dev)


def serve_phase(rng, seed, dev, card):
    from deltaconv_tpu_torch import (PLAIN_OPS, InferenceEngine,
                                     launch_counts, reset_launch_counts)

    model = random_model(seed, dev)
    engine = InferenceEngine(model, num_points=N, batch_size=B)
    plain = InferenceEngine(model, num_points=N, batch_size=B,
                            ops=PLAIN_OPS)
    uni, uni_n = ellipsoid_clouds(rng, [N] * 64)
    sizes = rng.integers(N * 600 // 1024, N, 10).tolist()  # 600..1023
    rag, rag_n = ellipsoid_clouds(rng, sizes)
    rag, rag_n = rag + uni[:1], rag_n + uni_n[:1]  # one full cloud too

    engine.predict(uni[:B], uni_n[:B])  # warm-up: library, cuBLAS
    torch.cuda.synchronize()

    reset_launch_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits_u = engine.predict(uni, uni_n)
        times.append(time.perf_counter() - t0)
    logits_r = engine.predict(rag, rag_n)
    counts = launch_counts()
    print(f"[serve] launches during serving: {counts}")

    print("[serve] checks")
    check("uniform logits", logits_u.shape == (64, 40)
          and bool(np.isfinite(logits_u).all()), f"shape {logits_u.shape}")
    check("ragged logits", logits_r.shape == (11, 40)
          and bool(np.isfinite(logits_r).all()), f"shape {logits_r.shape}")
    for name, n in counts.items():
        check(f"{name} launched", n > 0, f"{n} launches")
    ref_u = plain.predict(uni, uni_n)
    ref_r = plain.predict(rag, rag_n)
    for label, got, ref in (("uniform", logits_u, ref_u),
                            ("ragged", logits_r, ref_r)):
        err = float(np.abs(got - ref).max())
        same = bool((got.argmax(1) == ref.argmax(1)).all())
        check(f"{label} kernel vs plain", err <= LOGIT_ATOL and same,
              f"max_abs_err {err} <= {LOGIT_ATOL}, argmax equal {same}")
    err = float(np.abs(logits_r[-1] - logits_u[0]).max())
    check("full cloud ragged vs uniform", err <= LOGIT_ATOL,
          f"max_abs_err {err} <= {LOGIT_ATOL}")

    t = float(np.median(times))
    n_batches = 64 // B
    print(f"[serve] 64 uniform clouds (N={N}, batch {B}): median "
          f"{t * 1e3:.3f} ms per call of {n_batches} batches, "
          f"{t * 1e3 / n_batches:.3f} ms per batch, {64 / t:.1f} clouds/s "
          f"(host clock, synchronised), card: {card}")
    return counts


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA card")
    from deltaconv_tpu_torch import ops

    # Strict f32 everywhere: TF32 would reorder kNN neighbours and move
    # the logits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__},"
          f" CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    ops.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    res = kernel_phase(rng, dev, card)
    counts = serve_phase(rng, args.seed, dev, card)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name],
         "max_abs_err": res[name]["max_abs_err"],
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"]}
        for name, (src, rep) in KERNEL_META.items()]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
