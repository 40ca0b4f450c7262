"""SHREC-11 classification dataset (MeshCNN remesh) (a copy of
``deltaconv_tpu/data/shrec.py``).

Upstream: the reference release's experiments/datasets/shrec.py: 30 classes,
random 10-per-class training split (``split10``), OBJ meshes. The
split RNG is seedable here (the reference uses global numpy state).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

from .dataset import CloudDataset
from .io import download_url, extract_zip, read_obj

__all__ = ["SHREC"]


class SHREC(CloudDataset):
    url = "https://dl.dropboxusercontent.com/s/biiwlkkky7bp5ya/shrec_16.zip"

    class_names = [
        "alien", "ants", "armadillo", "bird1", "bird2", "camel", "cat",
        "centaur", "dinosaur", "dino_ske", "dog1", "dog2", "flamingo",
        "glasses", "gorilla", "hand", "horse", "lamp", "laptop", "man",
        "myScissor", "octopus", "pliers", "rabbit", "santa", "shark",
        "snake", "spiders", "two_balls", "woman",
    ]

    split_names = ("train", "test")

    def __init__(self, root, split: str = "train", split10: bool = True,
                 split_seed: Optional[int] = None, **kw):
        self.split10 = split10
        self.split_seed = split_seed
        super().__init__(root, split, **kw)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def processed_prefix(self) -> str:
        return "shrec_split10_" if self.split10 else "shrec_full_"

    def download(self):
        if os.path.exists(os.path.join(self.raw_dir, "shrec_16.zip")):
            return
        download_url(self.url, self.raw_dir)

    def process(self):
        extract_zip(os.path.join(self.raw_dir, "shrec_16.zip"), self.raw_dir)
        raw_path = os.path.join(self.raw_dir, "shrec_16")
        rng = np.random.default_rng(self.split_seed)

        train_list, test_list = [], []
        for class_idx, class_name in enumerate(self.class_names):
            train_dir = os.path.join(raw_path, class_name, "train")
            if not os.path.isdir(train_dir):
                continue
            files = sorted(os.listdir(train_dir))
            if self.split10:
                keep = set(rng.permutation(len(files))[:10].tolist())
            else:
                keep = set(range(len(files)))
            for i, fn in enumerate(files):
                if i not in keep:
                    continue
                c = read_obj(os.path.join(train_dir, fn))
                train_list.append(c.replace(y=np.int64(class_idx)))

            test_dir = os.path.join(raw_path, class_name, "test")
            for fn in sorted(os.listdir(test_dir)):
                c = read_obj(os.path.join(test_dir, fn))
                test_list.append(c.replace(y=np.int64(class_idx)))

        out = {
            "train": self._apply_pre(train_list),
            "test": self._apply_pre(test_list),
        }
        shutil.rmtree(raw_path)
        return out
