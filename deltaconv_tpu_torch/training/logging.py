"""Experiment logging: TensorBoard (when available) + JSONL (a copy of
``deltaconv_tpu/training/logging.py``).

Replaces the reference's ``SummaryWriter`` usage
(train_modelnet.py:199-215): scalars go to a TensorBoard event file via
tensorboardX when importable, and always to ``metrics.jsonl`` so runs
remain inspectable without TensorBoard. A ``settings.txt`` dump of the
run arguments matches the reference's convention.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["MetricsLogger", "make_run_dir"]


def make_run_dir(logdir: str, experiment_name: str) -> str:
    """``LOGDIR/runs/EXPERIMENT/TIME`` (reference layout)."""
    run_time = time.strftime("%d%b%y_%H_%M", time.localtime())
    path = os.path.join(logdir, "runs", experiment_name, run_time)
    os.makedirs(path, exist_ok=True)
    return path


class MetricsLogger:
    def __init__(self, run_dir: Optional[str]):
        self.run_dir = run_dir
        self._tb = None
        self._jsonl = None
        if run_dir is None:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(run_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        if self.run_dir is None:
            return
        value = float(value)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step)}) + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def write_settings(self, args, experiment_name: str):
        if self.run_dir is None:
            return
        lines = [experiment_name, "--", "Settings:", "--"]
        for key, val in sorted(vars(args).items()):
            lines.append(f"{key}: {val}")
        with open(os.path.join(self.run_dir, "settings.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
