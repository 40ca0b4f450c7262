"""Farthest-point sampling (counterpart of
``deltaconv_tpu/geometry/fps.py``): geodesic, on the host (the port's own
C++ build, or a pure-Python fallback without a toolchain), and Euclidean,
a torch loop on the points' device.

The geodesic variant is the reference's preprocessing op: a kNN graph
(k=10, self prepended), Dijkstra from each selected sample into a shared
min-distance field, the next sample its argmax; the first sample is drawn
from a seedable RNG.
"""

from __future__ import annotations

import ctypes
import heapq
from typing import Optional

import numpy as np
import torch

from ..cpp import load_library

__all__ = ["euclidean_fps", "geodesic_fps"]


def _validate(points) -> np.ndarray:
    pts = np.asarray(points)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    if pts.shape[0] == 0:
        raise ValueError("points must be non-empty")
    return np.ascontiguousarray(pts, dtype=np.float64)


def _knn_numpy(pts: np.ndarray, k: int) -> np.ndarray:
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, -1.0)
    return np.argsort(d2, axis=1, kind="stable")[:, : k + 1]


def _geodesic_fps_python(pts: np.ndarray, n_samples: int, knn_k: int,
                         seed: Optional[int]) -> np.ndarray:
    """Pure-Python fallback (heapq Dijkstra over the kNN graph)."""
    n = pts.shape[0]
    adj = _knn_numpy(pts, min(knn_k, n - 1))
    rng = np.random.default_rng(seed)
    out = np.empty(n_samples, np.int32)
    out[0] = rng.integers(0, n)
    dist = np.full(n, np.inf)

    for s in range(1, n_samples):
        src = int(out[s - 1])
        dist[src] = 0.0
        pq = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist[u]:
                continue
            for v in adj[u]:
                v = int(v)
                if v == u:
                    continue
                nd = d + float(np.linalg.norm(pts[v] - pts[u]))
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(pq, (nd, v))
        out[s] = int(np.argmax(dist))
    return out


def geodesic_fps(points, n_samples: int, knn_k: int = 10,
                 seed: Optional[int] = None) -> np.ndarray:
    """Geodesic farthest-point sampling of ``points [N, 3]`` (array-like):
    ``n_samples`` (<= N) int32 indices over a ``knn_k``-NN distance graph
    (the reference's 10); ``seed`` draws the first sample (None: a
    non-deterministic draw, the reference's behaviour)."""
    pts = _validate(points)
    n = pts.shape[0]
    if n_samples > n:
        raise ValueError(f"n_samples ({n_samples}) > num points ({n})")

    lib = load_library()
    if lib is None:
        return _geodesic_fps_python(pts, n_samples, knn_k, seed)

    out = np.empty(n_samples, np.int32)
    rc = lib.geodesic_fps(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n),
        ctypes.c_int64(n_samples),
        ctypes.c_int64(min(knn_k, n - 1)),
        ctypes.c_int64(-1 if seed is None else int(seed)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"geodesic_fps failed with code {rc}")
    return out


def euclidean_fps(pos, n_samples: int, start: int = 0):
    """Euclidean farthest-point sampling of ``pos [N, 3]`` (a tensor) on
    its device: ``[n_samples]`` int32 indices, the first ``start``, each
    next the first point farthest from those chosen."""
    idx = torch.zeros(n_samples, dtype=torch.int32, device=pos.device)
    idx[0] = start
    dist = torch.full((pos.shape[0],), float("inf"), dtype=pos.dtype,
                      device=pos.device)
    for i in range(1, n_samples):
        d = pos - pos[idx[i - 1].long()]
        dist = torch.minimum(dist, torch.sqrt((d * d).sum(dim=-1)))
        idx[i] = torch.argmax(dist)
    return idx
