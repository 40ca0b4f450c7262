"""A dry run of every multi-rank path at tiny shapes (counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``):

    python -m deltaconv_tpu_torch.parallel.dryrun [N]

spawns ``N`` ranks (``parallel.launch``): ``nccl`` ranks, one a card,
when ``N`` cards are visible, else ``gloo`` ranks on the CPU. Each rank
runs

- a data-parallel classification step (B = 4N clouds of 64 points;
  JAX's takes 2N, but at 2 clouds a rank the head's 4-row BatchNorms
  amplify the sums' order past the bound) against the one-process step
  on the whole batch: the same loss, and every parameter within rtol
  2e-5 + atol 2e-6 (JAX's check);
- a data-parallel segmentation step (per-point labels, the categorical
  one-hot);
- point sharding of ONE cloud of 64 N points: the laplacian, the
  classification and segmentation forwards, and a train step of each.

Every loss must be finite and every rank must hold the same parameters
bit for bit. The summary names the parameter farthest from the
one-process step; its distance comes from the cross-rank f32 sums,
which add in another order than one process's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .launch import run_ranks

__all__ = ["dryrun_multichip"]

_RTOL, _ATOL = 2e-5, 2e-6


def _device(group):
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        device = torch.device("cuda", dist.get_rank(group))
        torch.cuda.set_device(device)
        return device
    return torch.device("cpu")


def _batch(rng, b, n, device, seg=False):
    from ..data.synthetic import (synthetic_classification_batch,
                                  synthetic_segmentation_batch)

    seed = int(rng.integers(1 << 30))
    batch = (synthetic_segmentation_batch(seed, b, n, num_parts=6,
                                          num_categories=16) if seg
             else synthetic_classification_batch(seed, b, n, 4))
    out = {k: torch.from_numpy(np.asarray(v)).to(device)
           for k, v in batch.items()}
    out["label"] = out["label"].long()
    return out


def _flat(model) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}


def _rank(group, n):
    """One rank of the dry run; returns its summary."""
    from ..models import DeltaNetClassification, DeltaNetSegmentation
    from ..training import create_train_state, make_train_step, sgd_momentum
    from .collectives import all_gather
    from .mesh import shard_train_step
    from .point_sharding import (pad_cloud, point_sharded_classification,
                                 point_sharded_laplacian,
                                 point_sharded_segmentation,
                                 point_sharded_train_step, shard_rows)

    device = _device(group)
    rng = np.random.default_rng(0)
    out = {}

    def model_pair(make):
        return [make().to(device) for _ in range(2)]

    # Data parallel, classification: the group's step and one process's.
    ranks, one = model_pair(lambda: DeltaNetClassification(
        4, conv_channels=(16, 16), num_neighbors=8,
        generator=torch.Generator().manual_seed(0)))
    batch = _batch(rng, 4 * n, 64, device)
    losses = []
    for model, g in ((ranks, group), (one, None)):
        state = create_train_state(model, sgd_momentum(0.01), device=device)
        step = shard_train_step(make_train_step(model, smoothing=0.2,
                                                group=g))
        gen = torch.Generator(device=device).manual_seed(1)
        losses.append(float(step(state, batch, gen)["loss"]))
    a, b = _flat(ranks), _flat(one)
    worst = max(((float((a[k] - b[k]).abs().max()), k) for k in a
                 if a[k].is_floating_point()))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=_RTOL, atol=_ATOL,
                                   msg=lambda m, k=k: f"{k}: {m}")
    assert abs(losses[0] - losses[1]) <= 1e-5 * max(1.0, abs(losses[1])), \
        losses
    out["dp"] = (losses, worst, a)

    # Data parallel, segmentation.
    seg = DeltaNetSegmentation(6, conv_channels=(16, 16), mlp_depth=1,
                               embedding_size=16, categorical_vector=True,
                               num_neighbors=8,
                               generator=torch.Generator().manual_seed(2)
                               ).to(device)
    state = create_train_state(seg, sgd_momentum(0.01), device=device)
    step = shard_train_step(make_train_step(seg, smoothing=0.2,
                                            per_point=True, group=group))
    gen = torch.Generator(device=device).manual_seed(3)
    out["dp-seg"] = (float(step(state, _batch(rng, 2 * n, 64, device, True),
                                gen)["loss"]), _flat(seg))

    # Point sharding of one cloud.
    n_pts = 64 * n
    pos = torch.from_numpy(rng.random((n_pts, 3)).astype(np.float32))
    nrm = torch.from_numpy(rng.standard_normal((n_pts, 3)).astype(
        np.float32))
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    x = torch.from_numpy(rng.random((n_pts, 4)).astype(np.float32))
    pos, nrm, mask = (t.to(device) for t in pad_cloud(pos, n, nrm))
    pos_l, nrm_l, mask_l = (shard_rows(t, group) for t in (pos, nrm, mask))
    lap = point_sharded_laplacian(pos_l, shard_rows(x.to(device), group), 8,
                                  nrm_l, group)
    assert bool(torch.isfinite(lap).all())
    cls = DeltaNetClassification(4, conv_channels=(16, 16), num_neighbors=8,
                                 dense_operators=False,
                                 generator=torch.Generator().manual_seed(4)
                                 ).to(device).eval()
    with torch.no_grad():
        logits = point_sharded_classification(cls, pos_l, nrm_l, mask_l,
                                              group)
    assert bool(torch.isfinite(logits).all())
    state = create_train_state(cls, sgd_momentum(0.01), device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    sp = point_sharded_train_step(cls, group)(
        state, pos_l, nrm_l, torch.tensor(1, device=device), gen,
        point_mask=mask_l)
    out["sp"] = (float(sp["loss"]), _flat(cls))

    sp_seg = DeltaNetSegmentation(6, conv_channels=(16, 16), mlp_depth=1,
                                  embedding_size=16, categorical_vector=True,
                                  num_neighbors=8, dense_operators=False,
                                  generator=torch.Generator().manual_seed(6)
                                  ).to(device).eval()
    cat = torch.zeros(16, device=device)
    cat[2] = 1.0
    with torch.no_grad():
        seg_logits = all_gather(point_sharded_segmentation(
            sp_seg, pos_l, nrm_l, mask_l, cat, group), group)
    assert seg_logits.shape == (n_pts, 6)
    assert bool(torch.isfinite(seg_logits).all())
    state = create_train_state(sp_seg, sgd_momentum(0.01), device=device)
    label = torch.from_numpy(rng.integers(0, 6, n_pts)).to(device)
    sp = point_sharded_train_step(sp_seg, group, per_point=True)(
        state, pos_l, nrm_l, shard_rows(label, group), gen,
        point_mask=mask_l, category=cat)
    out["sp-seg"] = (float(sp["loss"]), _flat(sp_seg))
    for name in ("dp-seg", "sp", "sp-seg"):
        assert np.isfinite(out[name][0]), f"{name}: loss {out[name][0]}"
    return out


def dryrun_multichip(n: int = 2) -> str:
    """Runs the dry run on ``n`` ranks; returns (and prints) its summary.
    Raises when a check fails or the ranks' parameters differ."""
    on_cards = torch.cuda.is_available() and torch.cuda.device_count() >= n
    ranks = run_ranks(_rank, n, n, backend="nccl" if on_cards else "gloo",
                      timeout=900.0, threads=0 if on_cards else 1)
    first = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        for name in ("dp", "dp-seg", "sp", "sp-seg"):
            params = res[name][-1]
            same = all(torch.equal(params[k], first[name][-1][k])
                       for k in params)
            assert same, f"rank {r}'s {name} parameters differ from rank 0's"
    (loss, loss1), (dist, key), _ = first["dp"]
    where = "cards (nccl)" if on_cards else "CPU ranks (gloo)"
    summary = (
        f"dryrun_multichip({n}) on {n} {where}: ok; data-parallel "
        f"classification loss {loss:.6f} against {loss1:.6f} in one "
        f"process; largest parameter difference {dist:.3g} in {key} "
        f"(within rtol {_RTOL} + atol {_ATOL}; cause: the cross-rank f32 "
        f"sums add in another order than one process's); data-parallel "
        f"segmentation loss {first['dp-seg'][0]:.6f}; point-sharded "
        f"({64 * n} points) laplacian, forwards and train steps: "
        f"classification loss {first['sp'][0]:.6f}, segmentation loss "
        f"{first['sp-seg'][0]:.6f}; every rank's parameters bit-equal")
    print(summary)
    return summary


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
