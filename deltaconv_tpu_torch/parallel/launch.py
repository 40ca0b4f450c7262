"""Spawn a group of ranks on one host: ``run_ranks(fn, world, payload)``
starts ``world`` processes (``spawn``), joins them in one
``torch.distributed`` group on a ``FileStore`` in a temporary directory
(no network), runs ``fn(group, payload)`` on every rank and returns the
ranks' results in rank order.

The group's backend is ``gloo`` by default: on the CPU, and for ranks
that share one card, which ``nccl`` refuses (the collectives stage CUDA
tensors through host memory then, ``parallel.collectives``). The
initialisation has a bounded timeout, and so has the join: a rank that
fails or outlives ``timeout`` fails the call, and every rank still
running is stopped. ``fn`` must be importable by name (a module-level
function) and ``payload`` loadable with ``torch.load``.

The multi-rank tests, the dry run (``parallel.dryrun``) and the card's
smoke test (``chip_smoke.py``) share it.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]

_INIT_TIMEOUT = timedelta(seconds=60)  # to join, and of each collective


def _rank_main(rank, world, backend, store, fn, payload_path, out_dir,
               threads):
    """One spawned rank: joins the group, runs ``fn``, saves its result
    (or its traceback) under ``out_dir``."""
    if threads:
        torch.set_num_threads(threads)
    out = os.path.join(out_dir, f"rank{rank}.pt")
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=_INIT_TIMEOUT)
    try:
        payload = torch.load(payload_path, weights_only=False)
        result = {"ok": fn(dist.group.WORLD, payload)}
    except BaseException:  # reported by the parent, which raises
        result = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(result, out)
    if "error" in result:
        raise SystemExit(1)


def run_ranks(fn: Callable[[Any, Any], Any], world: int, payload=None,
              backend: str = "gloo", timeout: float = 240.0,
              threads: int = 1) -> List[Any]:
    """Runs ``fn(group, payload)`` on ``world`` spawned ranks of one
    ``backend`` group; returns their results, rank 0 first. Raises
    ``RuntimeError`` with the failing rank's traceback, or when the ranks
    do not all finish within ``timeout`` seconds (every rank still
    running is then terminated). ``threads``: each rank's
    ``torch.set_num_threads`` (0 leaves torch's default)."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        payload_path = os.path.join(tmp, "payload.pt")
        torch.save(payload, payload_path)
        ctx = mp.start_processes(
            _rank_main,
            args=(world, backend, os.path.join(tmp, "store"), fn,
                  payload_path, tmp, threads),
            nprocs=world, join=False, start_method="spawn")
        failed = None
        try:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    if ctx.join(timeout=1):
                        break
                except (mp.ProcessRaisedException,
                        mp.ProcessExitedException) as err:
                    failed = str(err)
                    break
                if time.monotonic() > deadline:
                    failed = f"the {world} ranks did not finish in {timeout} s"
                    break
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        results = []
        for rank in range(world):
            path = os.path.join(tmp, f"rank{rank}.pt")
            got = (torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
            if got is None or "error" in got:
                detail = "no result" if got is None else got["error"]
                raise RuntimeError(f"rank {rank} of {world} failed: {detail}"
                                   + (f" ({failed})" if failed else ""))
            results.append(got["ok"])
        if failed:
            raise RuntimeError(failed)
        return results
