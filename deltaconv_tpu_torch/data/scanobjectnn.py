"""ScanObjectNN real-scan classification dataset (a copy of
``deltaconv_tpu/data/scanobjectnn.py``): the upstream h5 reader, manual
download required, background/no-background x 5 perturbation-variant
files. ``h5py`` is imported only when the raw files are processed.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .cloud import Cloud
from .dataset import CloudDataset

__all__ = ["ScanObjectNN"]


class ScanObjectNN(CloudDataset):
    url = "https://hkust-vgd.github.io/scanobjectnn/"

    class_names = [
        "bag", "bed", "bin", "box", "cabinets", "chair", "desk", "display",
        "door", "pillow", "shelves", "sink", "sofa", "table", "toilet",
    ]
    augmentation_variants = (None, "PB_T25", "PB_T25_R", "PB_T50_R",
                             "PB_T50_RS")

    raw_file_dict = {
        None: ["training_objectdataset.h5", "test_objectdataset.h5"],
        "PB_T25": ["training_objectdataset_augmented25_norot.h5",
                   "test_objectdataset_augmented25_norot.h5"],
        "PB_T25_R": ["training_objectdataset_augmented25rot.h5",
                     "test_objectdataset_augmented25rot.h5"],
        "PB_T50_R": ["training_objectdataset_augmentedrot.h5",
                     "test_objectdataset_augmentedrot.h5"],
        "PB_T50_RS": ["training_objectdataset_augmentedrot_scale75.h5",
                      "test_objectdataset_augmentedrot_scale75.h5"],
    }

    split_names = ("train", "test")

    def __init__(self, root, background: bool = False,
                 augmentation: Optional[str] = None, split: str = "train",
                 **kw):
        assert augmentation in self.augmentation_variants
        self.augmentation = augmentation
        self.background = background
        self.bg_path = "main_split" if background else "main_split_nobg"
        super().__init__(root, split, **kw)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def processed_prefix(self) -> str:
        bg = "bg" if self.background else "nobg"
        aug = self.augmentation or "vanilla"
        return f"scanobjectnn_{bg}_{aug}_"

    def download(self):
        first = os.path.join(self.raw_dir, self.bg_path,
                             self.raw_file_dict[self.augmentation][0])
        if not os.path.exists(first):
            raise RuntimeError(
                f"ScanObjectNN requires manual download from {self.url}; "
                f"place the h5 files under {self.raw_dir}/{self.bg_path}/"
            )

    def process(self):
        import h5py

        out = {}
        for split, fn in zip(self.split_names,
                             self.raw_file_dict[self.augmentation]):
            path = os.path.join(self.raw_dir, self.bg_path, fn)
            clouds = []
            with h5py.File(path, "r") as h5:
                data = np.asarray(h5["data"], np.float32)
                labels = np.asarray(h5["label"]).astype(np.int64)
            for pos, y in zip(data, labels):
                clouds.append(Cloud(pos=pos, y=np.int64(y)))
            out[split] = self._apply_pre(clouds)
        return out
