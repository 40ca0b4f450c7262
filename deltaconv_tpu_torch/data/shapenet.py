"""ShapeNet part-segmentation dataset (with normals) (a copy of
``deltaconv_tpu/data/shapenet.py``).

Upstream: the reference release's experiments/datasets/shapenet.py: the
part-annotation benchmark with per-point normals, shuffled json split
lists, 16-category one-hots and the 50-part label table.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Sequence, Union

import numpy as np

from .dataset import CloudDataset
from .io import download_url, extract_zip

__all__ = ["ShapeNet"]


class ShapeNet(CloudDataset):
    url = ("https://shapenet.cs.stanford.edu/media/"
           "shapenetcore_partanno_segmentation_benchmark_v0_normal.zip")

    category_ids = {
        "Airplane": "02691156", "Bag": "02773838", "Cap": "02954340",
        "Car": "02958343", "Chair": "03001627", "Earphone": "03261776",
        "Guitar": "03467517", "Knife": "03624134", "Lamp": "03636649",
        "Laptop": "03642806", "Motorbike": "03790512", "Mug": "03797390",
        "Pistol": "03948459", "Rocket": "04099429", "Skateboard": "04225987",
        "Table": "04379243",
    }

    seg_classes = {
        "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7],
        "Car": [8, 9, 10, 11], "Chair": [12, 13, 14, 15],
        "Earphone": [16, 17, 18], "Guitar": [19, 20, 21],
        "Knife": [22, 23], "Lamp": [24, 25, 26, 27], "Laptop": [28, 29],
        "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37],
        "Pistol": [38, 39, 40], "Rocket": [41, 42, 43],
        "Skateboard": [44, 45, 46], "Table": [47, 48, 49],
    }

    split_names = ("train", "val", "test", "trainval")

    def __init__(self, root, categories: Union[None, str, Sequence] = None,
                 split: str = "trainval", include_normals: bool = True,
                 n_per_class: Optional[int] = None, **kw):
        if categories is None:
            categories = list(self.category_ids.keys())
        if isinstance(categories, str):
            categories = [categories]
        assert all(c in self.category_ids for c in categories)
        self.categories = list(categories)
        self.include_normals = include_normals
        self.n_per_class = n_per_class
        super().__init__(root, split, **kw)
        if not include_normals:
            self._clouds = [c.replace(normal=None) for c in self._clouds]

    @property
    def num_classes(self) -> int:
        return 50

    @property
    def processed_prefix(self) -> str:
        cats = "_".join(c[:3].lower() for c in self.categories)
        return f"shapenet_{cats}_"

    def download(self):
        marker = os.path.join(self.raw_dir, ".extracted")
        if os.path.exists(marker):
            return
        path = download_url(self.url, self.root)
        extract_zip(path, self.root)
        os.unlink(path)
        name = self.url.rpartition("/")[2].split(".")[0]
        if os.path.isdir(self.raw_dir):
            shutil.rmtree(self.raw_dir)
        os.rename(os.path.join(self.root, name), self.raw_dir)
        open(marker, "w").close()

    def _process_filenames(self, filenames: List[str]):
        from .cloud import Cloud

        cat_ids = [self.category_ids[c] for c in self.categories]
        cat_idx = {cid: i for i, cid in enumerate(cat_ids)}
        remaining = {cid: self.n_per_class for cid in cat_ids}

        clouds = []
        for name in filenames:
            cat = name.split(os.sep)[0]
            if cat not in cat_idx:
                continue
            if self.n_per_class is not None:
                if remaining[cat] <= 0:
                    continue
                remaining[cat] -= 1
            arr = np.loadtxt(os.path.join(self.raw_dir, name),
                             dtype=np.float32)
            onehot = np.zeros(16, np.float32)
            onehot[cat_idx[cat]] = 1.0
            clouds.append(Cloud(
                pos=arr[:, :3],
                normal=arr[:, 3:6],
                y=arr[:, -1].astype(np.int64),
                category=onehot,
            ))
        return self._apply_pre(clouds)

    def process(self):
        out = {}
        trainval = []
        for split in ("train", "val", "test"):
            path = os.path.join(self.raw_dir, "train_test_split",
                                f"shuffled_{split}_file_list.json")
            with open(path) as f:
                filenames = [
                    os.sep.join(n.split("/")[1:]) + ".txt"
                    for n in json.load(f)
                ]
            clouds = self._process_filenames(filenames)
            out[split] = clouds
            if split in ("train", "val"):
                trainval += clouds
        out["trainval"] = trainval
        return out
