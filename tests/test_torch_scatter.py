"""The edge-row scatter and the adjacency counts of deltaconv_tpu_torch
against the JAX package on the CPU, in the layouts the port hands them.

``scatter_rows`` reads its ``[B, C, K, N]`` edge rows through their
strides: the coefficient-form VJPs give it the edge-major view of
``[B, N, K, C]`` rows, the operator build's gather VJP the
component-major tensor. On CPU tensors the wrapper takes the plain
version (``scatter_add_`` of the permuted rows), which must take any
strides. The destination-major kernel sums each row's edges in the order
of :func:`~deltaconv_tpu_torch.ops.inverse_adjacency`, whose plain
version (a stable ``argsort``) is what the card tests compare the kernel
with: it is held here against a list built edge by edge. ``adjacency``
is held exactly against the JAX Pallas kernel in interpret mode at an N
that is not a multiple of 4 (the kernel's rows that start off a 16-byte
boundary).

Tolerances: the scatter against the JAX kernel in interpret mode, 1e-5 x
max (f32 summation order, and the JAX kernel's hi/lo bf16 halves of g);
the inverse adjacency and the adjacency counts exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.ops.gather_sum import _adjacency_matrix
from deltaconv_tpu_torch import ops

jax_rows = importlib.import_module("deltaconv_tpu.ops.gather_rows")

torch.set_num_threads(1)

B, N, K = 2, 200, 8
REF_REL = 1e-5  # x max: f32 sums in another order


def _within(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _hub_graph(rng, n_out, n=N, k=K):
    """Indices in ``[0, n_out)`` repeated many times over, and a hub row
    (3) that takes every point's second slot."""
    idx = rng.integers(0, n_out, (B, n, k)).astype(np.int32)
    idx[:, :, 1] = 3
    return idx


def _layouts(g):
    """``g [B, C, K, N]`` as the callers hand it: contiguous
    (component-major), the edge-major view of ``[B, N, K, C]`` rows, and a
    view with a padded channel stride (no layout is contiguous)."""
    t = torch.from_numpy(g)
    edge_major = t.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)
    b, c, k, n = g.shape
    padded = torch.zeros((b, n, k, c + 3))
    padded[..., :c] = t.permute(0, 3, 2, 1)
    return {"component-major": t, "edge-major": edge_major,
            "padded": padded[..., :c].permute(0, 3, 2, 1)}


@pytest.mark.parametrize("layout", ["component-major", "edge-major",
                                    "padded"])
@pytest.mark.parametrize("n_out,c", [(N, 9), (N, 70), (N - 13, 12)])
def test_scatter_rows_layouts_match_jax(layout, n_out, c):
    """``scatter_rows`` and ``scatter_rows_plain`` on each layout against
    the JAX kernel in interpret mode; ``n_out < N`` drops the indices
    outside ``[0, n_out)``."""
    rng = np.random.default_rng(70)
    idx = _hub_graph(rng, N)
    g = rng.standard_normal((B, c, K, N)).astype(np.float32)
    want = jax_rows.scatter_rows(jnp.asarray(g), jnp.asarray(idx), n_out,
                                 128, True)
    view = _layouts(g)[layout]
    assert view.is_contiguous() == (layout == "component-major")
    for fn in (ops.scatter_rows_plain, ops.scatter_rows):
        got = fn(view, torch.from_numpy(idx), n_out)
        assert got.shape == (B, n_out, c) and got.dtype == torch.float32
        _within(got, want, REF_REL)


def _listed_by_hand(idx, n_out):
    """Each cloud's rows' edge lists, built edge by edge in ascending
    order, and the ids of the edges whose index lies outside
    ``[0, n_out)``."""
    b, n, k = idx.shape
    rows = [[[] for _ in range(n_out)] for _ in range(b)]
    dropped = [[] for _ in range(b)]
    for ib in range(b):
        for e, m in enumerate(idx[ib].reshape(-1)):
            (rows[ib][m] if 0 <= m < n_out else dropped[ib]).append(e)
    return rows, dropped


@pytest.mark.parametrize("n_out", [N, N - 37, N + 20])
def test_inverse_adjacency_plain_lists_each_edge_once(n_out):
    """The plain inverse adjacency (a stable ``argsort`` of the
    destination keys), the version the card tests hold the kernel to:
    every in-range edge listed once, under its row, in ascending edge
    order; indices outside ``[0, n_out)`` (negative ones too) listed
    nowhere, the cloud's tail holding -1 for each; the wrapper on CPU
    tensors gives the same."""
    rng = np.random.default_rng(71)
    idx = rng.integers(-3, N + 5, (B, N, K)).astype(np.int32)
    idx[:, :, 1] = 3  # a hub row
    rows, dropped = _listed_by_hand(idx, n_out)
    for fn in (ops.inverse_adjacency_plain, ops.inverse_adjacency):
        offsets, edges = fn(torch.from_numpy(idx), n_out)
        assert offsets.dtype == edges.dtype == torch.int32
        assert offsets.shape == (B, n_out + 1) and edges.shape == (B, N * K)
        for ib in range(B):
            off, lst = offsets[ib].tolist(), edges[ib].tolist()
            assert off[0] == 0
            for m in range(n_out):
                assert lst[off[m]:off[m + 1]] == rows[ib][m], (ib, m)
            assert off[n_out] == N * K - len(dropped[ib])
            assert lst[off[n_out]:] == [-1] * len(dropped[ib])
    assert len(rows[0][3]) >= N  # the hub row holds every point's slot


def test_scatter_rows_plain_sums_the_inverse_adjacency():
    """Summing each row's listed edges in list order (what the kernel
    does) gives ``scatter_rows_plain``'s rows (1e-5 x max: the CPU
    ``scatter_add_`` may add in another order)."""
    rng = np.random.default_rng(72)
    idx = _hub_graph(rng, N)
    g = torch.from_numpy(rng.standard_normal((B, 6, K, N)).astype(
        np.float32))
    offsets, edges = ops.inverse_adjacency_plain(torch.from_numpy(idx), N)
    rows = g.permute(0, 3, 2, 1).reshape(B, N * K, 6)
    out = torch.zeros((B, N, 6))
    for ib in range(B):
        for m in range(N):
            for e in edges[ib, offsets[ib, m]:offsets[ib, m + 1]].tolist():
                out[ib, m] += rows[ib, e]
    _within(out, ops.scatter_rows_plain(g, torch.from_numpy(idx), N).numpy(),
            REF_REL)


@pytest.mark.parametrize("n", [130, 201])
def test_adjacency_matches_pallas_interpret_off_alignment(n):
    """``adjacency`` (the plain version on CPU tensors) exactly equal to
    the JAX kernel in interpret mode at N % 4 != 0, with repeated and
    masked slots."""
    rng = np.random.default_rng(73)
    k = 9
    idx = rng.integers(0, n, (B, n, k)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]
    mask = rng.random((B, n, k)) > 0.3
    want = _adjacency_matrix(jnp.asarray(idx), jnp.asarray(mask), 128, True)
    got = ops.adjacency(torch.from_numpy(idx), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (B, n, n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.float32))
    assert got.max() >= 2
