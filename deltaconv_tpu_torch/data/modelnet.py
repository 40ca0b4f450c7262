"""ModelNet10/40 classification dataset (a copy of
``deltaconv_tpu/data/modelnet.py``).

Upstream: the reference release's experiments/datasets/modelnet.py: auto-
download of the Princeton zips, OFF meshes per category, optional
per-class cap.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Optional

import numpy as np

from .dataset import CloudDataset
from .io import download_url, extract_zip, read_off

__all__ = ["ModelNet"]


class ModelNet(CloudDataset):
    urls = {
        "10": "http://vision.princeton.edu/projects/2014/3DShapeNets/"
              "ModelNet10.zip",
        "40": "http://modelnet.cs.princeton.edu/ModelNet40.zip",
    }

    split_names = ("train", "test")

    def __init__(self, root, name: str = "10", split: str = "train",
                 n_per_class: Optional[int] = None, **kw):
        assert name in ("10", "40")
        self.name = name
        self.n_per_class = n_per_class
        super().__init__(root, split, **kw)

    @property
    def processed_prefix(self) -> str:
        return f"modelnet{self.name}_"

    def download(self):
        marker = os.path.join(self.raw_dir, ".extracted")
        if os.path.exists(marker):
            return
        path = download_url(self.urls[self.name], self.root)
        extract_zip(path, self.root)
        os.unlink(path)
        folder = os.path.join(self.root, f"ModelNet{self.name}")
        if os.path.isdir(self.raw_dir):
            shutil.rmtree(self.raw_dir)
        os.rename(folder, self.raw_dir)
        macosx = os.path.join(self.root, "__MACOSX")
        if os.path.exists(macosx):
            shutil.rmtree(macosx)
        open(marker, "w").close()

    def categories(self):
        cats = [
            d for d in sorted(os.listdir(self.raw_dir))
            if os.path.isdir(os.path.join(self.raw_dir, d))
        ]
        return cats

    def process(self):
        out = {}
        for split in self.split_names:
            clouds = []
            for target, cat in enumerate(self.categories()):
                folder = os.path.join(self.raw_dir, cat, split)
                paths = sorted(glob.glob(f"{folder}/{cat}_*.off"))
                if self.n_per_class is not None:
                    paths = paths[: self.n_per_class + 1]
                for p in paths:
                    c = read_off(p)
                    c = c.replace(y=np.int64(target))
                    clouds.append(c)
            out[split] = self._apply_pre(clouds)
        return out
