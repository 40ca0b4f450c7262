"""The collectives of the sharded paths over a ``torch.distributed``
process group, in place of the JAX package's ``lax`` collectives over a
mesh axis: ``all_gather`` (tiled along dim 0), ``psum``, ``pmean`` and
``pmax``, each differentiable with the transpose JAX gives it inside
``shard_map(check_vma=False)``:

- ``all_gather``'s backward is a reduce-scatter: this rank's rows of the
  sum over ranks of every rank's cotangent;
- ``psum``'s backward is a ``psum`` (``pmean``'s a ``pmean``);
- ``pmax`` is ``all_gather`` then a max, as JAX's ``_cross_shard_max``
  (``lax.pmax`` has no AD rule), so its gradient splits among tied
  winners as the max's does.

With ``group=None``, or a group of one rank, each returns its input and
nothing needs initialising: a cloud or a batch on one card runs the same
code, bit for bit. Across ranks every sum gathers the ranks' values and
adds them in rank order, so every rank holds the same bits; a bf16
cotangent is summed in f32 and rounded once. bf16 and bool tensors
travel as their bytes (the ``gloo`` backend takes neither).

The backend decides how a CUDA tensor travels: an ``nccl`` group takes
it as it is; a ``gloo`` group (which has no CUDA ``all_gather``) gets a
copy in pinned host memory and the result is copied back to the card.
Any other pairing of backend and device raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "pmax", "pmean", "pmean_gradients", "psum",
           "rank_and_size"]

_AS_BYTES = (torch.bfloat16, torch.bool)
_LOW = (torch.bfloat16, torch.float16)


def rank_and_size(group=None) -> tuple[int, int]:
    """This process's rank in ``group`` and the group's size; ``(0, 1)``
    for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _host_staged(x, group) -> bool:
    """Whether ``x`` crosses ``group`` through host memory: a CUDA
    tensor on a ``gloo`` group. CPU tensors need a ``gloo`` group."""
    backend = dist.get_backend(group)
    if x.device.type == "cuda":
        if backend == "gloo":
            return True
        if backend == "nccl":
            return False
    elif backend == "gloo":
        return False
    raise ValueError(f"collectives on {x.device.type} tensors over a "
                     f"{backend!r} group are not supported: nccl for CUDA "
                     "tensors, gloo for CPU or CUDA tensors")


def _gather(x, group, size):
    """Every rank's ``x`` concatenated along dim 0, in rank order (no
    autograd)."""
    as_bytes = x.dtype in _AS_BYTES
    send = x.contiguous()
    if as_bytes:  # the last dim doubles for bf16
        send = send.view(torch.uint8)
    staged = _host_staged(send, group)
    if staged:
        send = send.to("cpu").pin_memory()
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=0)
    if staged:
        out = out.pin_memory().to(x.device, non_blocking=True)
    return out.view(x.dtype) if as_bytes else out


def _ranked_sum(x, group, size):
    """The sum over ranks of every rank's ``x``, added in rank order;
    f16 and bf16 summed in f32 and rounded once."""
    wide = x.float() if x.dtype in _LOW else x
    return _gather(wide[None], group, size).sum(dim=0).to(x.dtype)


class _AllGather(torch.autograd.Function):
    """Tiled ``all_gather`` whose backward is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size, ctx.rows = group, size, x.shape[0]
        return _gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        total = _ranked_sum(g, ctx.group, ctx.size)
        return total[rank * ctx.rows:(rank + 1) * ctx.rows], None, None


class _PSum(torch.autograd.Function):
    """``psum`` whose backward is ``psum``."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _ranked_sum(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _ranked_sum(g, ctx.group, ctx.size), None, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    size = rank_and_size(group)[1]
    if size == 1:
        return x
    return _AllGather.apply(x, group, size)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``."""
    size = rank_and_size(group)[1]
    if size == 1:
        return x
    return _PSum.apply(x, group, size)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of every rank's ``x`` (``psum`` over the group's size)."""
    size = rank_and_size(group)[1]
    if size == 1:
        return x
    return psum(x, group) / size


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x``: ``all_gather`` of
    the stacked values, then ``amax`` (its gradient split among tied
    ranks)."""
    if rank_and_size(group)[1] == 1:
        return x
    return all_gather(x[None], group).amax(dim=0)


def pmean_gradients(params, group=None):
    """Averages the parameters' gradients over ``group``'s ranks in one
    collective (flattened, summed in rank order): every rank ends with
    the same bits. A parameter without a gradient counts as zeros."""
    params = list(params)
    if rank_and_size(group)[1] == 1 or not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    flat = pmean(flat, group)
    start = 0
    for p in params:
        n = p.numel()
        p.grad = flat[start:start + n].view_as(p).clone()
        start += n
