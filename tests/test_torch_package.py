"""deltaconv_tpu_torch as a package: it imports without JAX, its kernel
wrappers dispatch on the device of their inputs, the serving and
training surfaces reject what the port does not have yet, and
chip_smoke.py finds the package from any working directory."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deltaconv_tpu_torch import (DeltaNetClassification, InferenceEngine,
                                 KERNEL_OPS, PLAIN_OPS, launch_counts,
                                 reset_launch_counts)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.models import build_operators

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_NO_JAX = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "deltaconv_tpu"):
    sys.modules[name] = None  # any import of them now fails
import deltaconv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deltaconv_tpu_torch.__path__, "deltaconv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("data.io", "data.modelnet", "data.shapenet", "data.shapeseg",
             "data.shrec", "utils.ply_export", "training.logging",
             "training.checkpoint", "training.loop", "experiments.common",
             "experiments.train_scanobjectnn", "experiments.train_modelnet",
             "experiments.train_shrec", "experiments.train_shapenet",
             "experiments.test_shapenet", "experiments.train_shapeseg",
             "geometry.connection"):
    assert "deltaconv_tpu_torch." + name in names, name
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "flax", "deltaconv_tpu")
               for m, mod in sys.modules.items() if mod is not None)
print(len(names))
"""


def test_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


def _inputs(rng, b=2, n=32, k=6, c=5):
    h = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(np.int32))
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.2)
    return h, idx, mask


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    h, idx, mask = _inputs(rng)
    reset_launch_counts()
    torch.testing.assert_close(ops.gather_max(h, idx, mask),
                               ops.gather_max_plain(h, idx, mask),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.gather_rows(h, idx),
                               ops.gather_rows_plain(h, idx), rtol=0, atol=0)
    out, win = ops.gather_max_win(h, idx, mask)
    torch.testing.assert_close(ops.gather_max_bwd(idx, win, h, 32),
                               ops.gather_max_bwd_plain(idx, win, h, 32),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.adjacency(idx, mask),
                               ops.adjacency_plain(idx, mask), rtol=0, atol=0)
    torch.testing.assert_close(ops.gather_sum(h, idx, mask),
                               ops.gather_sum_plain(h, idx, mask),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.gather_sum_bwd(idx, mask, h),
                               ops.gather_sum_bwd_plain(idx, mask, h),
                               rtol=0, atol=0)
    # Differentiated: the autograd Functions, still on the plain versions.
    hg = h.clone().requires_grad_()
    ops.gather_max(hg, idx, mask).sum().backward()
    ops.gather_sum(hg, idx, mask).sum().backward()
    pos = torch.from_numpy(rng.standard_normal((2, 32, 3)).astype(np.float32))
    torch.testing.assert_close(ops.knn_topk(pos, 6, True),
                               ops.knn_topk_plain(pos, 6, True),
                               rtol=0, atol=0)
    hb = h.to(torch.bfloat16)
    aff = tuple(torch.randn(5) for _ in range(4))
    torch.testing.assert_close(ops.gather_max_affine(hb, idx, mask, aff),
                               ops.gather_max_affine_plain(hb, idx, mask,
                                                           aff),
                               rtol=0, atol=0)
    w = torch.randn((5, 7)).to(torch.bfloat16)
    torch.testing.assert_close(ops.gather_matmul_max(hb, w, idx, mask),
                               ops.gather_matmul_max_plain(hb, w, idx, mask),
                               rtol=0, atol=0)
    for got, want in zip(ops.gather_max_win(hb, idx, mask),
                         ops.gather_max_win_plain(hb, idx, mask)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ops.gather_max(hb, idx, mask),
                               ops.gather_max_plain(hb, idx, mask),
                               rtol=0, atol=0)
    mlp = ([torch.randn((5, 8)), torch.randn((8, 7))],
           [(torch.randn(8), torch.randn(8))])
    z0, epi = torch.randn(7), tuple(torch.randn(7) for _ in range(4))
    torch.testing.assert_close(
        ops.gather_mlp_max(hb, *mlp, idx, mask, True, True, z0, epi),
        ops.gather_mlp_max_plain(hb, *mlp, idx, mask, True, True, z0, epi),
        rtol=0, atol=0)
    torch.testing.assert_close(ops.mlp_rows(hb, *mlp),
                               ops.mlp_rows_plain(hb, *mlp), rtol=0, atol=0)
    rows = torch.randn((2, 32, 7)).to(torch.bfloat16)
    torch.testing.assert_close(
        ops.gather_max_merge(rows, idx, mask, 1, rows, epi),
        ops.gather_max_merge_plain(rows, idx, mask, 1, rows, epi),
        rtol=0, atol=0)
    gb = torch.randn((2, 32, 7)).to(torch.bfloat16)
    out, win = ops.gather_matmul_max_win(hb, w, idx, mask)
    torch.testing.assert_close(
        (out, win), ops.gather_matmul_max_win_plain(hb, w, idx, mask),
        rtol=0, atol=0)
    torch.testing.assert_close(ops.gather_max_bwd(idx, win, gb, 32),
                               ops.gather_max_bwd_plain(idx, win, gb, 32),
                               rtol=0, atol=0)
    xg, wg = hb.clone().requires_grad_(), w.clone().requires_grad_()
    ops.gather_matmul_max_train(xg, wg, idx, mask).float().sum().backward()
    assert xg.grad.dtype == wg.grad.dtype == torch.bfloat16
    coef = torch.randn((2, 32, 6, 2))
    for got, want in zip(
            ops.densify_coefs(idx, coef, coef, torch.bfloat16),
            ops.densify_coefs_plain(idx, coef, coef, torch.bfloat16)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(ops.densify_coefs_int8(idx, coef, coef),
                         ops.densify_coefs_int8_plain(idx, coef, coef)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for t in (h, hb):
        torch.testing.assert_close(ops.gather_max_int8(t, idx, mask),
                                   ops.gather_max_int8_plain(t, idx, mask),
                                   rtol=0, atol=0)
    xq, _ = ops.int8_quantize(h)
    torch.testing.assert_close(ops.gather_matmul_max_int8(xq, w, idx, mask),
                               ops.gather_matmul_max_int8_plain(xq, w, idx,
                                                                mask),
                               rtol=0, atol=0)
    v = torch.randn((2, 32, 2, 5))
    torch.testing.assert_close(ops.coef_apply_grad(h, coef, idx),
                               ops.coef_apply_grad_plain(h, coef, idx),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.coef_apply_div(v, coef, idx),
                               ops.coef_apply_div_plain(v, coef, idx),
                               rtol=0, atol=0)
    plan = ops.coef_plan(h[..., :3], idx)
    for got, want in zip(plan, ops.coef_plan_plain(h[..., :3], idx)):
        assert got == want if isinstance(got, int) else torch.equal(got,
                                                                   want)
    torch.testing.assert_close(ops.coef_apply_grad(h, coef, idx, plan),
                               ops.coef_apply_grad_plain(h, coef, idx),
                               rtol=0, atol=0)
    g = torch.randn((2, 5, 6, 32))
    torch.testing.assert_close(ops.scatter_rows(g, idx, 32),
                               ops.scatter_rows_plain(g, idx, 32),
                               rtol=0, atol=0)
    vg = v.clone().requires_grad_()
    ops.coef_apply_div(vg, coef, idx).sum().backward()
    ops.gather_rows(hg, idx).sum().backward()
    pos = torch.randn((300, 3))
    for quantized in (False, True):
        torch.testing.assert_close(
            ops.knn_topk_table(pos[:40], pos, 6, quantized=quantized),
            ops.knn_topk_table_plain(pos[:40], pos, 6, quantized=quantized),
            rtol=0, atol=0)
        torch.testing.assert_close(
            ops.knn_topk_bucketed(pos, pos, 6, quantized=quantized,
                                  tile_c=128, m_tiles=1),
            ops.knn_topk_bucketed_plain(pos, pos, 6, quantized=quantized,
                                        tile_c=128, m_tiles=1),
            rtol=0, atol=0)
    ab = torch.randn((2, 5))
    for got, want in zip(
            ops.edge_mlp_fwd(hb, ab[0], ab[1], w, gb[0, 0].float(), idx),
            ops.edge_mlp_fwd_plain(hb, ab[0], ab[1], w, gb[0, 0].float(),
                                   idx)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    gk = torch.randn((2, 6, 32, 7)).to(torch.bfloat16)
    for got, want in zip(
            ops.edge_mlp_bwd(hb, ab[0], ab[1], w, idx, gk),
            ops.edge_mlp_bwd_plain(hb, ab[0], ab[1], w, idx, gk)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    yg, wg = hb.clone().requires_grad_(), w.float().requires_grad_()
    ops.edge_delta_mlp(yg, ab[0], ab[1], wg, gb[0, 0].float(),
                       idx).float().sum().backward()
    assert yg.grad.dtype == torch.bfloat16 and wg.grad.dtype == torch.float32
    pos = torch.randn((2, 32, 3))
    nrm = torch.nn.functional.normalize(torch.randn((2, 32, 3)), dim=-1)
    for quantized in (False, True):
        for got, want in zip(
                ops.knn_topk(pos, 6, quantized, return_mean_dist=True),
                ops.knn_topk_plain(pos, 6, quantized, True)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    knn_idx, md = ops.knn_topk(pos, 6, True, return_mean_dist=True)
    xb, yb = torch.randn((2, 2, 32, 3)).unbind(0)
    for got, want in zip(
            ops.fused_gather_wls(pos, nrm, xb, yb, knn_idx, mask, md[:, 0]),
            ops.fused_gather_wls_plain(pos, nrm, xb, yb, knn_idx, mask,
                                       md[:, 0])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    edges = torch.rand((2, 12, 6, 32))
    ct = torch.randn((2, 2, 2, 6, 32))
    torch.testing.assert_close(ops.wls_bwd(edges, ct[0], ct[1], 1.0, 1e-3),
                               ops.wls_bwd_plain(edges, ct[0], ct[1], 1.0,
                                                 1e-3), rtol=0, atol=0)
    dw = torch.randn((2, 2, 2, 32, 32))
    for got, want in zip(ops.densify_bwd(idx, dw[0], dw[1]),
                         ops.densify_bwd_plain(idx, dw[0], dw[1])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for feat, ct_rows in ((h, torch.randn((2, 32, 2, 5))),
                          (torch.randn((2, 32, 2, 5)), h)):
        torch.testing.assert_close(
            ops.coef_cotangent(feat, ct_rows, idx),
            ops.coef_cotangent_plain(feat, ct_rows, idx), rtol=0, atol=0)
    for t in (h, hb):
        for got, want in zip(ops.gather_minmax(t, idx, mask),
                             ops.gather_minmax_plain(t, idx, mask)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        got = ops.gather_minmax_win(t, idx, mask)
        torch.testing.assert_close(got, ops.gather_minmax_win_plain(
            t, idx, mask), rtol=0, atol=0)
        g = torch.randn(t.shape).to(t.dtype)
        torch.testing.assert_close(
            ops.gather_minmax_bwd(idx, got[2], g, got[3], g, 32),
            ops.gather_minmax_bwd_plain(idx, got[2], g, got[3], g, 32),
            rtol=0, atol=0)
        tg = t.clone().requires_grad_()
        sum(o.float().sum() for o in ops.gather_minmax(tg, idx,
                                                       mask)).backward()
        assert tg.grad.dtype == t.dtype
    for got, want in zip(ops.gather_matmul_minmax(hb, w, idx, mask),
                         ops.gather_matmul_minmax_plain(hb, w, idx, mask)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # Above 64 neighbours (the rounds kernel's route on the card).
    torch.testing.assert_close(ops.knn_topk(pos.repeat(1, 3, 1)[:, :70], 66),
                               ops.knn_topk_plain(pos.repeat(1, 3, 1)[:, :70],
                                                  66), rtol=0, atol=0)
    assert launch_counts() == {
        "gather_rows": 0, "wls": 0, "wls_direct": 0, "densify": 0,
        "densify_bf16": 0,
        "gather_max": 0, "gather_max_win": 0, "gather_max_bwd": 0,
        "gather_max_direct": 0, "gather_max_win_direct": 0,
        "gather_max_bf16_direct": 0, "gather_max_win_bf16_direct": 0,
        "adjacency": 0, "gather_sum": 0, "gather_sum_direct": 0,
        "gather_sum_bwd": 0, "knn_topk": 0, "gather_max_affine": 0,
        "gather_max_affine_direct": 0, "gather_matmul_max": 0,
        "gather_matmul_max_kfold": 0,
        "gather_max_win_bf16": 0, "gather_max_bwd_bf16": 0,
        "gather_matmul_max_win": 0, "gather_matmul_max_win_kfold": 0,
        "gather_max_bf16": 0,
        "gather_mlp_max": 0, "mlp_rows": 0, "gather_max_merge": 0,
        "densify_int8": 0, "absmax": 0, "gather_max_int8": 0,
        "gather_max_int8_direct": 0, "gather_max_bwd_direct": 0,
        "gather_max_bwd_bf16_direct": 0, "gather_minmax_bwd_direct": 0,
        "gather_minmax_bwd_bf16_direct": 0,
        "gather_matmul_max_int8": 0, "gather_matmul_max_int8_kfold": 0,
        "inverse_adjacency": 0,
        "scatter_rows": 0,
        "coef_apply_grad": 0, "coef_apply_div": 0,
        "coef_apply_grad_plan": 0, "coef_apply_div_plan": 0,
        "coef_plan_order": 0, "coef_plan_runs": 0, "knn_topk_table": 0,
        "knn_topk_table_q": 0, "knn_topk_bucketed": 0,
        "knn_topk_bucketed_q": 0, "edge_delta_mlp": 0,
        "edge_delta_mlp_bwd": 0, "edge_delta_mlp_bwd_sum": 0, "wls_bwd": 0, "wls_bwd_direct": 0,
        "densify_bwd": 0, "coef_cotangent": 0,
        "fused_gather_wls": 0, "fused_gather_wls_direct": 0,
        "knn_topk_mean_dist": 0,
            "knn_topk_rounds": 0, "gather_minmax": 0,
        "gather_minmax_bf16": 0, "gather_minmax_win": 0,
        "gather_minmax_win_bf16": 0, "gather_minmax_bwd": 0,
        "gather_minmax_bwd_bf16": 0, "gather_matmul_minmax": 0,
        "gather_minmax_direct": 0, "gather_minmax_bf16_direct": 0,
        "gather_minmax_win_direct": 0, "gather_minmax_win_bf16_direct": 0,
        "gather_matmul_minmax_kfold": 0}
    assert KERNEL_OPS.gather_max is ops.gather_max
    assert PLAIN_OPS.gather_max is ops.gather_max_plain
    assert KERNEL_OPS.gather_sum is ops.gather_sum
    assert PLAIN_OPS.gather_sum is ops.gather_sum_plain
    assert KERNEL_OPS.knn_topk is ops.knn_topk
    assert PLAIN_OPS.gather_matmul_max is ops.gather_matmul_max_plain
    assert KERNEL_OPS.gather_matmul_max_train is ops.gather_matmul_max_train
    assert (PLAIN_OPS.gather_matmul_max_train
            is ops.gather_matmul_max_train_plain)
    assert KERNEL_OPS.gather_mlp_max is ops.gather_mlp_max
    assert PLAIN_OPS.gather_mlp_max is ops.gather_mlp_max_plain
    assert KERNEL_OPS.densify_coefs_int8 is ops.densify_coefs_int8
    assert PLAIN_OPS.gather_max_int8 is ops.gather_max_int8_plain
    assert (PLAIN_OPS.gather_matmul_max_int8
            is ops.gather_matmul_max_int8_plain)
    assert KERNEL_OPS.edge_delta_mlp is ops.edge_delta_mlp
    assert PLAIN_OPS.edge_delta_mlp is ops.edge_delta_mlp_plain
    assert KERNEL_OPS.fused_gather_wls is ops.fused_gather_wls
    assert PLAIN_OPS.fused_gather_wls is ops.fused_gather_wls_plain
    assert KERNEL_OPS.gather_minmax is ops.gather_minmax
    assert PLAIN_OPS.gather_minmax is ops.gather_minmax_plain
    assert KERNEL_OPS.gather_matmul_minmax is ops.gather_matmul_minmax
    assert PLAIN_OPS.gather_matmul_minmax is ops.gather_matmul_minmax_plain


def test_kernels_refuse_other_devices():
    """A wrapper runs its kernel only on CUDA tensors: anything that is
    neither CPU nor CUDA raises before a launch. (The dtype, shape,
    contiguity and autograd checks are tested on the card,
    tests/test_torch_gpu.py.)"""
    rng = np.random.default_rng(1)
    h, idx, mask = _inputs(rng)
    meta = torch.device("meta")
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max(h.to(meta), idx.to(meta), mask.to(meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_rows(h.to(meta), idx.to(meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.densify_coefs(idx.to(meta), torch.zeros(2, 32, 6, 2, device=meta),
                          torch.zeros(2, 32, 6, 2, device=meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.wls(torch.zeros(2, 12, 6, 32, device=meta), 1.0, 1e-3)
    hm, im, mm = h.to(meta), idx.to(meta), mask.to(meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max_win(hm, im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max_bwd(im, torch.zeros(2, 32, 5, dtype=torch.int32,
                                           device=meta), hm, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.adjacency(im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_sum(hm, im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_sum_bwd(im, mm, hm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.knn_topk(torch.zeros(2, 32, 3, device=meta), 6, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.densify_coefs(im, torch.zeros(2, 32, 6, 2, device=meta),
                          torch.zeros(2, 32, 6, 2, device=meta),
                          torch.bfloat16)
    hb = hm.to(torch.bfloat16)
    aff = tuple(torch.zeros(5, device=meta) for _ in range(4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max_affine(hb, im, mm, aff, True)
    wb = torch.zeros(5, 7, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_matmul_max(hb, wb, im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max_win(hb, im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max_bwd(im, torch.zeros(2, 32, 5, dtype=torch.int32,
                                           device=meta), hb, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_matmul_max_win(hb, wb, im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max(hb, im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_mlp_max(hb, [torch.zeros(5, 7, device=meta)], [], im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_mlp_max(hb, [torch.zeros(5, 7, device=meta)], [], im, mm,
                           True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.mlp_rows(hb, [torch.zeros(5, 7, device=meta)], [])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max_merge(hb, im, mm, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.densify_coefs_int8(im, torch.zeros(2, 32, 6, 2, device=meta),
                               torch.zeros(2, 32, 6, 2, device=meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_max_int8(hb, im, mm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_matmul_max_int8(
            torch.zeros(2, 32, 5, dtype=torch.int8, device=meta), wb, im, mm)
    ab = torch.zeros(2, 5, device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.edge_mlp_fwd(hb, ab[0], ab[1], wb, torch.zeros(7, device=meta),
                         im)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.edge_mlp_bwd(hb, ab[0], ab[1], wb, im, torch.zeros(
            2, 6, 32, 7, dtype=torch.bfloat16, device=meta))
    em = torch.zeros(2, 12, 6, 32, device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.wls_bwd(em, em[:, :2], em[:, :2], 1.0, 1e-3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.densify_bwd(im, torch.zeros(2, 2, 32, 32, device=meta),
                        torch.zeros(2, 2, 32, 32, device=meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.densify_coefs(im, torch.zeros(2, 2, 32, 6, device=meta),
                          torch.zeros(2, 2, 32, 6, device=meta),
                          torch.bfloat16, planes=True)
    p3 = torch.zeros(2, 32, 3, device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.knn_topk(p3, 6, True, return_mean_dist=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_gather_wls(p3, p3, p3, p3, im, mm,
                             torch.zeros(2, device=meta))
    wm = torch.zeros(2, 32, 5, dtype=torch.int32, device=meta)
    for t in (hm, hb):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.gather_minmax(t, im, mm)
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.gather_minmax_win(t, im, mm)
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.gather_minmax_bwd(im, wm, t, wm, t, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gather_matmul_minmax(hb, wb, im, mm)
    assert sum(launch_counts().values()) == 0


def test_precision_modes():
    """None keeps the dtypes as built, float32 strips them, bfloat16 sets
    both, int8 sets bf16 compute on int8 operators (and serves); the
    engine serves a copy and leaves the caller's model as it was."""
    model = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                   num_neighbors=4)
    model.train()
    expect = {None: (None, None), "float32": (None, None),
              "bfloat16": (torch.bfloat16, torch.bfloat16),
              "int8": (torch.bfloat16, torch.int8)}
    for precision, (compute, operator) in expect.items():
        engine = InferenceEngine(model, num_points=16, precision=precision,
                                 device="cpu")
        assert engine.model is not model and not engine.model.training
        assert engine.model.compute_dtype is compute
        assert engine.model.operator_dtype is operator
        assert engine.model.lin_embedding.dtype is compute
    assert model.compute_dtype is None and model.training
    cloud = np.random.default_rng(5).standard_normal((16, 3)).astype(
        np.float32)
    normal = cloud / np.linalg.norm(cloud, axis=1, keepdims=True)
    logits = engine.predict([cloud], [normal])  # the int8 engine serves
    assert logits.shape == (1, 4) and np.isfinite(logits).all()
    with pytest.raises(ValueError, match="unknown precision"):
        InferenceEngine(model, num_points=16, precision="fp8", device="cpu")

    bf16 = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                  num_neighbors=4, compute_dtype="bfloat16",
                                  operator_dtype="bfloat16")
    kept = InferenceEngine(bf16, num_points=16, device="cpu")
    assert kept.model.compute_dtype is torch.bfloat16
    stripped = InferenceEngine(bf16, num_points=16, precision="float32",
                               device="cpu")
    assert stripped.model.compute_dtype is None
    assert stripped.model.operator_dtype is None
    assert all(m.dtype is None for m in stripped.model.modules()
               if hasattr(m, "dtype"))
    assert bf16.compute_dtype is torch.bfloat16  # unchanged


def test_int8_is_an_operator_dtype_only():
    """int8 quantizes the operators; the activations compute in f32 or
    bf16, so ``compute_dtype="int8"`` is refused."""
    with pytest.raises(ValueError, match="operator dtype only"):
        DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                               num_neighbors=4, compute_dtype="int8")
    model = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                   num_neighbors=4, operator_dtype="int8")
    assert model.operator_dtype is torch.int8 and model.compute_dtype is None
    with pytest.raises(ValueError, match="unknown dtype"):
        model.set_precision(None, "fp8")


def test_int8_operators_refuse_training():
    """int8 operators serve only, as the JAX package's: a train-mode
    forward raises instead of returning gradients of a rounding."""
    model = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                   num_neighbors=4, compute_dtype="bfloat16",
                                   operator_dtype="int8")
    pos = torch.randn((2, 16, 3), generator=torch.Generator().manual_seed(0))
    normal = torch.nn.functional.normalize(pos, dim=-1)
    with pytest.raises(NotImplementedError, match="serve only"):
        model.train()(pos, normal)
    with torch.inference_mode():
        assert model.eval()(pos, normal).shape == (2, 4)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises: nothing serves or
    trains on the CPU unless the caller asks for it."""
    from deltaconv_tpu_torch.training import create_train_state, sgd_momentum

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                   num_neighbors=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model, num_points=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model, sgd_momentum(0.1))
    state = create_train_state(model, sgd_momentum(0.1), device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"


def test_bf16_training_runs_on_the_cpu():
    """A narrow model at the production config (bf16 compute and
    operators, approximate kNN) takes a few CPU steps: the losses stay
    finite and fall, the parameters stay f32, and eval still serves."""
    from deltaconv_tpu_torch.training import (create_train_state,
                                              make_train_step, sgd_momentum)

    model = DeltaNetClassification(
        4, conv_channels=(8, 16, 136), embedding_size=16, num_neighbors=6,
        compute_dtype="bfloat16", operator_dtype="bfloat16",
        knn_method="approx", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    pos = torch.randn((4, 48, 3), generator=gen)
    normal = torch.nn.functional.normalize(pos, dim=-1)
    batch = {"pos": pos, "normal": normal, "label": torch.arange(4)}
    state = create_train_state(model, sgd_momentum(0.05), device="cpu")
    step = make_train_step(model)
    losses = [float(step(state, batch, gen)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    model.eval()
    assert model(pos, normal).dtype == torch.float32


def test_engine_rejects_oversized_and_mismatched_clouds():
    model = DeltaNetClassification(4, conv_channels=(8, 8), embedding_size=16,
                                   num_neighbors=4)
    engine = InferenceEngine(model, num_points=16, batch_size=2, device="cpu")
    cloud = np.zeros((17, 3), np.float32)
    with pytest.raises(ValueError, match="num_points"):
        engine.predict([cloud], [cloud])
    with pytest.raises(ValueError, match="normals"):
        engine.predict([cloud[:8]], [cloud[:7]])


def test_build_without_normals_gives_finite_operators():
    """A build without normals returns finite operators (dense and in
    coefficient form) on frames estimated from the cloud."""
    gen = torch.Generator().manual_seed(0)
    pos = torch.randn((2, 24, 3), generator=gen)
    gd = build_operators(pos, 4)
    assert gd.w_grad.shape == (2, 2, 24, 24)
    assert bool(torch.isfinite(gd.w_grad).all())
    assert bool(torch.isfinite(gd.w_div).all())
    coef = build_operators(pos, 4, dense_operators=False)
    assert bool(torch.isfinite(coef.grad_coef).all())
    assert bool(torch.isfinite(coef.div_coef).all())


def _run_smoke(args, cwd):
    """Runs Python on a card-less CPU with the repo off ``sys.path``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


_RUN_SMOKE = """
import runpy, sys
sys.argv = sys.argv[1:]  # the script's own command line
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as exc:
    print("exit:", exc)
print("imported:", "deltaconv_tpu_torch" in sys.modules)
"""


def test_chip_smoke_runs_from_another_directory(tmp_path):
    """From any working directory the script finds the port beside it
    (and then stops, since this host has no card)."""
    out = _run_smoke(["-c", _RUN_SMOKE, str(ROOT / "chip_smoke.py")],
                     tmp_path)
    assert "ModuleNotFoundError" not in out.stderr, out.stderr
    assert "imported: True" in out.stdout, out.stdout + out.stderr
    assert "torch.cuda.is_available() is False" in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the checkout beside it the script exits non-zero with no
    result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run_smoke(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert "ModuleNotFoundError" in out.stderr
    assert '"ok": true' not in out.stdout


def test_seeded_init_is_reproducible():
    def make(seed):
        return DeltaNetClassification(
            4, conv_channels=(8, 8), embedding_size=16, num_neighbors=4,
            generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    w = "deltanet_base.convs.0.s_mlp.0.0.weight"
    torch.testing.assert_close(a[w], b[w], rtol=0, atol=0)
    assert not torch.equal(a[w], c[w])
    assert a[w].abs().max() <= 1.0 / np.sqrt(a[w].shape[1])
