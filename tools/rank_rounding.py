"""Where the distance of a 2-rank point-sharded train step from the
one-process step comes from, on the CPU.

The case is ``chip_smoke.py``'s ``[shard-train]`` segmentation step (the
ShapeNet recipe at full width, coefficient operators, exact kNN, dropout
0.5, SGD lr 0.01) on one cloud of ``--points`` points: once on 2 ``gloo``
ranks (``parallel.launch.run_ranks``), once in one process, and
``--controls`` times in one process on the cloud's points in another
order, each dropout mask permuted with them (the same function with its
sums in another order). It prints each run's distance from the
one-process run over that run's own move, ``||got - want|| / ||want -
start||`` (parameters, running statistics), and the parameter tensors
that hold most of the 2 ranks' distance.

``--f64`` runs the same steps with every f32 of the port's path widened
to f64: ``torch.float32`` is aliased to ``torch.float64`` in each
process, as the port pins f32 everywhere (a diagnostic device, not a
mode of the port). A distance that falls by the ratio of the two
roundings (about 5e8) is rounding; one that stays is a fault.

    python tools/rank_rounding.py --points 1024
    python tools/rank_rounding.py --points 1024 --f64
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402
from deltaconv_tpu_torch.parallel import (pad_cloud,  # noqa: E402
                                          point_sharded_train_step,
                                          shard_rows)
from deltaconv_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from deltaconv_tpu_torch.training import (create_train_state,  # noqa: E402
                                          sgd_momentum)

RANKS = 2


def _widen():
    """Every later ``torch.float32`` (and ``Tensor.float()``) is f64."""
    torch.set_default_dtype(torch.float64)
    torch.float32 = torch.float64
    torch.float = torch.float64
    torch.Tensor.float = lambda self: self.to(torch.float64)


def step_once(group, case):
    """One step of this rank's rows (``group=None``: the whole cloud,
    ``case["perm"]``: in that order, the masks permuted with it); its
    loss and the state before and after, as numpy (a widened process
    cannot ``torch.save`` its tensors for the parent)."""
    torch.set_num_threads(case["threads"])
    if case["f64"]:
        _widen()
    dev = torch.device("cpu")
    dt = torch.float64 if case["f64"] else torch.float32
    model = cs.random_seg_model(case["seed"], dev, "exact",
                                dense_operators=False)
    if case["f64"]:
        model.double()
    start = cs.state_bits(model)
    state = create_train_state(model, sgd_momentum(cs.SEG_LR), device=dev)
    step = point_sharded_train_step(model, group, per_point=True)
    perm = case.get("perm")
    order = slice(None) if perm is None else perm
    pos, nrm, mask = pad_cloud(torch.from_numpy(case["pos"][order]).to(dt),
                               RANKS,
                               torch.from_numpy(case["normal"][order]).to(dt))
    rows = [shard_rows(t, group) for t in (
        pos, nrm, torch.from_numpy(case["label"][order]), mask)]
    cat = torch.zeros(16, dtype=dt)
    cat[case["category"]] = 1.0
    gen = torch.Generator().manual_seed(case["seed"])
    masks = (contextlib.nullcontext() if perm is None
             else cs.permuted_masks(torch.from_numpy(perm), 1))
    with masks:
        loss = float(step(state, rows[0], rows[1], rows[2], gen,
                          point_mask=rows[3], category=cat)["loss"])
    host = {k: v.numpy() for k, v in cs.state_bits(model).items()}
    return loss, host, {k: v.numpy() for k, v in start.items()}


def _tensors(run):
    loss, bits, start = run
    return (loss, {k: torch.from_numpy(v) for k, v in bits.items()},
            {k: torch.from_numpy(v) for k, v in start.items()})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--points", type=int, default=1024)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--threads", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--f64", action="store_true")
    args = parser.parse_args(argv)
    rng = np.random.default_rng([args.seed, 28])
    (cloud,), (normal,) = cs.ellipsoid_clouds(rng, [args.points])
    case = dict(seed=args.seed, pos=cloud, normal=normal,
                label=rng.integers(0, cs.SEG_CLASSES, args.points),
                category=int(rng.integers(0, 16)), f64=args.f64,
                threads=args.threads)
    ranks = [_tensors(r) for r in run_ranks(step_once, RANKS, case,
                                            timeout=1200,
                                            threads=args.threads)]
    one = _tensors(step_once(None, case))
    dtype = "f64" if args.f64 else "f32"
    print(f"{dtype}, {args.points} points, dropout 0.5: loss 2 ranks "
          f"{ranks[0][0]!r}, one process {one[0]!r}")
    dist = cs.update_dist(ranks[0][1], one[1], one[2])
    print(f"2 ranks vs one process: parameters {dist['param']:.3e}, "
          f"statistics {dist['stat']:.3e} of the move")
    for i in range(args.controls):
        perm = np.random.default_rng([args.seed, 30, i]).permutation(
            args.points)
        ctrl = _tensors(step_once(None, dict(case, perm=perm)))
        d = cs.update_dist(ctrl[1], one[1], one[2])
        print(f"control {i} (points in another order): parameters "
              f"{d['param']:.3e}, statistics {d['stat']:.3e}")
    print("2 ranks: most of the distance in "
          + cs.largest_tensors(ranks[0][1], one[1], one[2]))


if __name__ == "__main__":
    main()
