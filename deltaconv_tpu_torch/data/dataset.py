"""Dataset base class and the batch loader (a copy of
``deltaconv_tpu/data/dataset.py``; a host's shard comes from
``torch.distributed``).

Equivalent of PyG's InMemoryDataset machinery used by the reference
(experiments/datasets/*): one-time ``download`` + ``process`` with a
processed-file cache, per-access ``transform``. The cache is a pickled
numpy archive of Cloud fields (fixed-size clouds after an FPS
pre-transform stack into dense arrays for free).

The loader replaces PyG's ragged DataLoader with fixed-shape batches —
the static-shape contract the batched paths require: ``[B, N, 3]``
position tensors plus stacked labels/normals/categories.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from .cloud import Cloud

__all__ = ["CloudDataset", "BatchLoader"]


def _process_index_and_count():
    """This host's ``(index, count)``: the ``torch.distributed`` rank and
    world size of the default group, or ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1

_FIELDS = ("pos", "normal", "face", "x", "y", "category", "sample_idx")


class CloudDataset:
    """Base dataset: subclasses implement ``download`` and
    ``process`` returning lists of Clouds per split."""

    #: names of the splits this dataset produces (processed file names)
    split_names: Sequence[str] = ("train", "test")

    def __init__(self, root: str, split: str = "train",
                 transform: Optional[Callable] = None,
                 pre_transform: Optional[Callable] = None,
                 pre_filter: Optional[Callable] = None):
        self.root = os.path.abspath(root)
        self.split = split
        self.transform = transform
        self.pre_transform = pre_transform
        self.pre_filter = pre_filter

        if split not in self.split_names:
            raise ValueError(
                f"split '{split}' not in {tuple(self.split_names)}"
            )

        os.makedirs(self.raw_dir, exist_ok=True)
        os.makedirs(self.processed_dir, exist_ok=True)

        path = self._processed_path(split)
        if not os.path.exists(path):
            self.download()
            splits = self.process()
            for name, clouds in splits.items():
                self._save(self._processed_path(name), clouds)
        self._clouds = self._load(path)

    # -- layout ----------------------------------------------------------
    @property
    def raw_dir(self) -> str:
        return os.path.join(self.root, "raw")

    @property
    def processed_dir(self) -> str:
        return os.path.join(self.root, "processed")

    @property
    def processed_prefix(self) -> str:
        return ""

    def _processed_path(self, split: str) -> str:
        return os.path.join(
            self.processed_dir, f"{self.processed_prefix}{split}.npz"
        )

    # -- subclass hooks ----------------------------------------------------
    def download(self) -> None:  # pragma: no cover - network
        raise NotImplementedError

    def process(self) -> dict:
        """Returns {split_name: [Cloud, ...]}."""
        raise NotImplementedError

    def _apply_pre(self, clouds: List[Cloud]) -> List[Cloud]:
        if self.pre_filter is not None:
            clouds = [c for c in clouds if self.pre_filter(c)]
        if self.pre_transform is not None:
            clouds = [self.pre_transform(c) for c in clouds]
        return clouds

    # -- cache ----------------------------------------------------------
    @staticmethod
    def _save(path: str, clouds: List[Cloud]) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {}
        for field in _FIELDS:
            payload[field] = np.asarray(
                [getattr(c, field) for c in clouds], dtype=object
            )
        np.savez_compressed(path, **payload)

    @staticmethod
    def _load(path: str) -> List[Cloud]:
        with np.load(path, allow_pickle=True) as z:
            fields = {k: z[k] for k in _FIELDS if k in z}
        n = len(next(iter(fields.values())))
        clouds = []
        for i in range(n):
            kw = {k: v[i] for k, v in fields.items()}
            kw = {k: (None if v is None or (isinstance(v, np.ndarray)
                                            and v.dtype == object and
                                            v.ndim == 0) else v)
                  for k, v in kw.items()}
            clouds.append(Cloud(**kw))
        return clouds

    # -- access ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._clouds)

    def __getitem__(self, i: int) -> Cloud:
        c = self._clouds[i]
        if self.transform is not None:
            c = self.transform(c)
        return c

    def __repr__(self):
        return f"{self.__class__.__name__}({len(self)}, split={self.split})"


class BatchLoader:
    """Stacks fixed-size clouds into dense batch dicts.

    Yields ``{"pos": [B,N,3], "label": [B] or [B,N], "normal": ...,
    "category": [B,16]}`` — ready for the train step. The last
    incomplete batch is dropped by default so every step sees the same
    shapes.

    Multi-process input sharding: every process constructs the loader with the SAME seed and its own
    ``process_index``/``process_count`` (defaults with
    ``host_shard=True``: the ``torch.distributed`` rank and world size
    when its default group is initialized, else 0 and 1).
    All hosts then draw the identical global shuffle order and each
    yields its disjoint ``batch_size``-slice of every global batch of
    ``batch_size * process_count`` clouds — the per-process input split
    for data parallelism; the gradient all-reduce stitches the global
    batch back together.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0,
                 host_shard: bool = False, process_index: int = None,
                 process_count: int = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch = None
        if host_shard:
            # Fill the two fields independently: an explicit
            # process_count with a defaulted index (or vice versa)
            # must not leave every host on shard 0.
            rank, world = _process_index_and_count()
            if process_index is None:
                process_index = rank
            if process_count is None:
                process_count = world
        self.process_index = process_index or 0
        self.process_count = process_count or 1
        if self.process_count > 1 and not drop_last:
            raise ValueError(
                "host-sharded loading requires drop_last=True "
                "(every host must yield the same number of batches)"
            )

    def __len__(self) -> int:
        n = len(self.dataset)
        gbs = self.batch_size * self.process_count
        if self.drop_last:
            return n // gbs
        return (n + gbs - 1) // gbs

    def set_epoch(self, epoch: int):
        """Makes the next shuffle order a pure function of
        ``(seed, epoch)`` instead of the stateful stream — checkpoint
        resume (``fit(..., resume=True)``) replays the exact order the
        uninterrupted run would have drawn. Also the multi-host
        contract: every host derives the identical global order."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            if self._epoch is not None:
                np.random.default_rng(
                    (self._seed, self._epoch)).shuffle(order)
            else:
                self._rng.shuffle(order)
        bs = self.batch_size
        gbs = bs * self.process_count
        limit = (len(order) // gbs) * gbs if self.drop_last else len(order)
        lo = self.process_index * bs
        for start in range(0, limit, gbs):
            mine = order[start + lo:start + lo + bs]
            clouds = [self.dataset[int(i)] for i in mine]
            yield self.collate(clouds)

    @staticmethod
    def collate(clouds: List[Cloud]) -> dict:
        batch = {"pos": np.stack([c.pos for c in clouds]).astype(np.float32)}
        if clouds[0].normal is not None:
            batch["normal"] = np.stack(
                [c.normal for c in clouds]
            ).astype(np.float32)
        ys = [c.y for c in clouds]
        if ys[0] is not None:
            batch["label"] = np.asarray(np.stack(
                [np.asarray(y) for y in ys]
            )).astype(np.int32).squeeze()
            if batch["label"].ndim == 0:
                batch["label"] = batch["label"][None]
        if clouds[0].x is not None:
            batch["features"] = np.stack(
                [c.x for c in clouds]
            ).astype(np.float32)
        if clouds[0].category is not None:
            cats = np.stack([np.asarray(c.category).reshape(-1)
                             for c in clouds])
            batch["category"] = cats.astype(np.float32)
        return batch
