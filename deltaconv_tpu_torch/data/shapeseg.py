"""ShapeSeg human-body segmentation dataset (Maron et al.) (a copy of
``deltaconv_tpu/data/shapeseg.py``).

Upstream: the reference release's experiments/datasets/shape_seg.py:
composite Adobe + FAUST + MIT + SCAPE training set, SHREC test set;
MeshCNN remesh. MIT ships edge labels converted to vertex labels
(``edge_to_vertex_labels``). The per-mesh segmentation files are torch
``.pt`` blobs, read with ``torch.load``.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .cloud import Cloud
from .dataset import CloudDataset
from .io import download_url, extract_zip, read_obj, read_ply

__all__ = ["ShapeSeg", "edge_to_vertex_labels"]


def _torch_load_numpy(path):
    import torch

    # weights_only=False as in the JAX package's reader (the upstream
    # label blobs are read as that reader reads them): it unpickles
    # arbitrary objects, so only the dataset's own archive is read here.
    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t)


def edge_to_vertex_labels(face: np.ndarray, edge_labels: np.ndarray,
                          n_nodes: int) -> np.ndarray:
    """Converts MeshCNN per-edge labels to per-vertex labels.

    Edges are enumerated in MeshCNN order: for each face the sorted
    edges (v0,v1), (v1,v2), (v0,v2), first occurrence wins (reference
    shape_seg.py:177-193). Both endpoints of edge e receive
    ``edge_labels[e]``; labels are shifted to start at 0.
    """
    seen = set()
    edges = []
    for f in face.T:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[0], f[2])):
            key = (min(int(a), int(b)), max(int(a), int(b)))
            if key not in seen:
                seen.add(key)
                edges.append(key)
    edges = np.asarray(edges, np.int64)
    out = np.zeros(n_nodes, np.int64)
    out[edges[:, 0]] = edge_labels[: len(edges)]
    out[edges[:, 1]] = edge_labels[: len(edges)]
    return out - 1


class ShapeSeg(CloudDataset):
    url = "https://dl.dropboxusercontent.com/s/b9hukhdufzbpgqj/shapeseg.zip"

    split_names = ("train", "test")

    @property
    def num_classes(self) -> int:
        return 8

    @property
    def processed_prefix(self) -> str:
        return "shapeseg_"

    def download(self):
        if os.path.exists(os.path.join(self.raw_dir, "shapeseg.zip")):
            return
        download_url(self.url, self.raw_dir)

    def process(self):
        extract_zip(os.path.join(self.raw_dir, "shapeseg.zip"), self.raw_dir)
        base = os.path.join(self.raw_dir, "ShapeSeg")

        train = []
        # Adobe: per-mesh .pt labels.
        adobe = os.path.join(base, "Adobe", "raw")
        extract_zip(os.path.join(adobe, "adobe.zip"), adobe)
        for i in range(41):
            c = read_ply(os.path.join(adobe, "meshes", f"{i}.ply"))
            y = _torch_load_numpy(os.path.join(adobe, "segs", f"{i}.pt"))
            train.append(c.replace(y=np.asarray(y, np.int64)))

        # FAUST: one shared label vector for all 100 registrations.
        faust = os.path.join(base, "FAUST", "raw")
        extract_zip(os.path.join(faust, "faust.zip"), faust)
        faust_y = np.asarray(
            _torch_load_numpy(os.path.join(faust, "segs", "faust_seg.pt")),
            np.int64,
        )
        for i in range(100):
            c = read_ply(os.path.join(faust, "meshes", f"tr_reg_{i:03d}.ply"))
            train.append(c.replace(y=faust_y))

        # MIT: edge labels -> vertex labels.
        mit = os.path.join(base, "MIT", "raw")
        extract_zip(os.path.join(mit, "mit.zip"), mit)
        mit_meshes = os.path.join(mit, "meshes")
        for fn in sorted(os.listdir(mit_meshes)):
            c = read_obj(os.path.join(mit_meshes, fn))
            eseg = np.loadtxt(
                os.path.join(mit, "segs", fn.replace(".obj", ".eseg"))
            ).astype(np.int64)
            y = edge_to_vertex_labels(c.face, eseg, c.num_points)
            train.append(c.replace(y=y))

        # SCAPE: one shared label vector.
        scape = os.path.join(base, "SCAPE", "raw")
        extract_zip(os.path.join(scape, "scape.zip"), scape)
        scape_y = np.asarray(
            _torch_load_numpy(os.path.join(scape, "segs", "scape_seg.pt")),
            np.int64,
        )
        for i in range(71):
            c = read_ply(os.path.join(scape, "meshes", f"{i}.ply"))
            train.append(c.replace(y=scape_y))

        # SHREC test split: per-mesh .pt labels.
        test = []
        shrec = os.path.join(base, "SHREC", "raw")
        extract_zip(os.path.join(shrec, "shrec.zip"), shrec)
        for i in range(18):
            c = read_ply(os.path.join(shrec, "meshes", f"{i}.ply"))
            y = _torch_load_numpy(os.path.join(shrec, "segs", f"{i}.pt"))
            test.append(c.replace(y=np.asarray(y, np.int64)))

        out = {
            "train": self._apply_pre(train),
            "test": self._apply_pre(test),
        }
        shutil.rmtree(base)
        return out
