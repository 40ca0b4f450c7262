"""Profiling and throughput measurement (counterpart of
``deltaconv_tpu/utils/profiling.py``): ``trace`` records a
``torch.profiler`` trace into a folder, and ``Throughput`` is an
items-per-second meter that synchronises the card before it counts."""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

__all__ = ["Throughput", "trace"]


@contextlib.contextmanager
def trace(logdir: str):
    """Records the host's operators, and the card's kernels when CUDA is
    available, with ``torch.profiler`` while the block runs, and writes
    the trace into ``logdir`` as ``<host>_<pid>.<ms>.pt.trace.json``
    (``tensorboard_trace_handler``'s name: TensorBoard's PyTorch profiler
    plugin and ``chrome://tracing`` read it). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    torch.profiler.tensorboard_trace_handler(logdir)(prof)


def _synchronize(tree) -> None:
    """Waits for the CUDA devices of every tensor in ``tree`` (a tensor,
    or a tuple, list or dict of them, nested)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for value in tree.values():
            _synchronize(value)
    elif isinstance(tree, (tuple, list)):
        for value in tree:
            _synchronize(value)


class Throughput:
    """Items/sec meter with warmup exclusion and device sync.

    Usage::

        meter = Throughput(warmup=2)
        for batch in loader:
            out = step(batch)
            meter.tick(batch_size, sync=out)
        print(meter.rate())

    The clock starts at the ``warmup``-th tick and counts the items of
    every tick after it (JAX's meter, tick for tick).
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        self._items = 0
        self._start: Optional[float] = None

    def tick(self, items: int, sync=None):
        """Counts one step of ``items``, after waiting for the card to
        finish ``sync`` (tensors of the step's output) when given."""
        if sync is not None:
            _synchronize(sync)
        self._count += 1
        if self._count == self.warmup:
            self._start = time.perf_counter()
        elif self._count > self.warmup:
            self._items += items

    def rate(self) -> float:
        """Items a second since the clock started (0 before any)."""
        if self._start is None or self._items == 0:
            return 0.0
        return self._items / (time.perf_counter() - self._start)
