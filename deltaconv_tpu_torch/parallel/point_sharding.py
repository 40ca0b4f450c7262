"""Point-sharded operators and eval forward of ONE large cloud (counterpart
of ``deltaconv_tpu/parallel/point_sharding.py``).

The N points of one cloud are spread over the ranks of a
``torch.distributed`` process group (the JAX package's mesh axis):

* rank r of D owns rows ``r N / D .. (r + 1) N / D`` of the padded cloud
  (:func:`pad_cloud` pads N to a multiple of D; :func:`shard_rows` takes a
  rank's block); every function here takes and returns this rank's
  rows, as the body of JAX's ``shard_map`` sees them;
* kNN runs locally against the all-gathered position table (12 bytes a
  point) through the table kernels (:func:`_local_knn`);
* each rank builds the operators of its rows with the table form of the
  fused build (``ops.wls_fused.build_grad_div_tables``), ``psum`` and
  ``pmax`` completing the mean edge length and the infinity norm;
* the convs apply them through :class:`ShardedGradDiv`, which gathers
  the feature table once per apply (neighbourhoods are arbitrary) and
  contracts locally; the pools complete with collectives.

With ``group=None`` (one rank) nothing is communicated: ``bench.py
--mode=point-shard`` serves a 65,536-point cloud this way on one card.

Training (:func:`point_sharded_train_step`, JAX's of the same name):
the forward runs in train mode on this rank's rows, every BatchNorm
before the pools (and the segmentation head's) completes its moments
over the group, the centralized conv's edge moments too; the loss is
replicated on every rank, the backward runs through the differentiable
collectives (``parallel.collectives``) and the gathers' backward
(``ops.gather_rows``: destination-major sums, no float atomics), and the
parameter gradients are averaged over the group before the optimizer
steps, so the parameters and the running statistics stay the same on
every rank.
"""

from __future__ import annotations

import torch

from ..geometry.dense import _bmm_f32
from ..geometry.frames import build_tangent_basis, estimate_basis
from ..geometry.grad_div import GradDiv
from ..ops import KERNEL_OPS, Ops
from ..ops.wls_fused import build_grad_div_tables
from .collectives import (all_gather, pmax, pmean_gradients, psum,
                          rank_and_size)

__all__ = ["ShardedGradDiv", "pad_cloud", "point_sharded_classification",
           "point_sharded_div", "point_sharded_grad",
           "point_sharded_laplacian", "point_sharded_operators",
           "point_sharded_segmentation", "point_sharded_train_step",
           "shard_rows"]

_NEG = -3.0e38
_BIG = 2e30

# Above this table length the local kNN leaves the whole [n_local, N]
# score block for the table kernel (memory O(n_local K)); above
# _KNN_BUCKETED_MIN, for the Morton-bucketed candidate sweep (about 10x
# less sweep work at 65,536 points). Module constants, as in the JAX
# package, so that tests can shrink them.
_KNN_TILE = 4096
_KNN_BUCKETED_MIN = 16384


def _local_knn(pos_local, pos_full, k, offset, point_mask_full=None,
               quantized=False, ops: Ops = KERNEL_OPS):
    """Top-k table columns of the local rows ``[n_l, 3]`` against the full
    table ``[N, 3]``, the row's own column (``offset + i``) in slot 0;
    masked table rows are never selected while k <= #valid points.

    The JAX package's TPU route on every device: up to ``_KNN_TILE``
    columns the whole score block and a top-k that breaks ties to the
    lowest column (a stable sort, as ``lax.top_k``); then the table kNN;
    from ``_KNN_BUCKETED_MIN`` columns the bucketed kNN. ``quantized``
    (``knn_method="approx"``) takes their packed-key bodies; the short
    table stays exact. ``ops`` chooses the kernels or the plain
    versions."""
    n_full = pos_full.shape[0]
    if n_full <= max(_KNN_TILE, 2 * k):
        sq_l = (pos_local * pos_local).sum(dim=-1)
        sq_f = (pos_full * pos_full).sum(dim=-1)
        s = (2.0 * torch.matmul(pos_local, pos_full.T) - sq_l[:, None]
             - sq_f[None, :])
        rows = offset + torch.arange(pos_local.shape[0],
                                     device=pos_local.device)
        cols = torch.arange(n_full, device=pos_local.device)
        s = torch.where(rows[:, None] == cols[None, :], _BIG, s)
        if point_mask_full is not None:
            s = torch.where(point_mask_full[None, :], s, -_BIG)
        # + 0.0 turns -0.0 into +0.0, so the sort sees equal scores tie.
        order = torch.sort(s + 0.0, dim=1, descending=True, stable=True)
        return order.indices[:, :k].to(torch.int32)
    fn = (ops.knn_topk_bucketed if n_full >= _KNN_BUCKETED_MIN
          else ops.knn_topk_table)
    return fn(pos_local, pos_full, k, row_offset=offset,
              point_mask=point_mask_full, quantized=quantized)


class _HiLoContract(torch.autograd.Function):
    """``sum_k a[n, j, k] g[n, k, c]`` of the bf16 hi/lo halves of the
    f32 ``a`` and bf16 ``g``, f32 sums (:meth:`ShardedGradDiv._contract`);
    the backward gives ``g`` the product of ``(hi + lo)^T`` and the f32
    cotangent, in f32, rounded to bf16 once (the coefficients, built
    without a graph, take none)."""

    @staticmethod
    def forward(ctx, a, g):
        hi = a.to(torch.bfloat16)
        lo = (a - hi.float()).to(torch.bfloat16)
        ctx.save_for_backward(hi, lo)
        out = _bmm_f32(torch.cat([hi, lo], dim=1), g)
        j = a.shape[1]
        return out[:, :j] + out[:, j:]

    @staticmethod
    def backward(ctx, ct):
        hi, lo = ctx.saved_tensors
        a = (hi.float() + lo.float()).transpose(1, 2)
        return None, torch.bmm(a, ct.float()).to(torch.bfloat16)


class ShardedGradDiv:
    """The operator object of this rank's rows (``local``: a batch of one
    :class:`GradDiv` whose ``nbr_idx`` are GLOBAL rows): every neighbour
    gather first all-gathers the feature table over ``group``. It offers
    what the conv stack asks of an operator object: ``grad``, ``div``,
    ``nbr_max``, ``nbr_sum`` (the train-mode edge moments),
    ``nbr_matmul_max`` (no epilogue) and ``nbr_gather``; and the min/max
    hooks ``nbr_minmax`` and ``nbr_matmul_minmax`` (plain torch, as JAX's
    sharded forms). Lacking ``nbr_max_affine``, ``nbr_mlp_max`` and
    ``nbr_matmul_max_train``, it sends the convs down their unfused
    routes in eval and in training, as the JAX convs route a
    ``ShardedGradDiv``; and the depth-2 max gathers the whole table's
    rows, so it is right at any world size.

    Differentiated in the features (training), the gathered table's rows
    come through ``ops.gather_rows``, whose backward sums each table
    row's edges destination-major with no float atomics
    (``inverse_adjacency`` + ``scatter_rows``, over the whole table), a
    bf16 cotangent in f32 rounded once; then the all-gather's backward
    (a reduce-scatter) returns each rank its rows' sums. The maxes and
    mins over gathered rows stay ``amax``/``amin``, whose gradient splits
    among tied winners, as ``jnp.max``'s in JAX's sharded forms.

    Contractions as JAX's (``_coef_contract``): f32 features against the
    f32 coefficients in full f32; bf16 features against a hi/lo bf16
    split of the coefficients, products exact and sums in f32 (one
    ``bmm`` a point, :meth:`_contract`)."""

    int8 = False

    def __init__(self, local: GradDiv, group=None):
        self.local = local
        self.group = group

    @property
    def nbr_idx(self):
        return self.local.nbr_idx

    @property
    def nbr_mask(self):
        return self.local.nbr_mask

    def _full(self, h):
        """``[1, n_l, ...] -> [1, N, ...]``: every rank's rows."""
        return all_gather(h[0], self.group)[None]

    def _rows(self, table):
        """Rows ``table[nbr_idx]`` of a FULL table: ``[1, N, ...] -> [1,
        n_l, K, ...]``; through ``ops.gather_rows`` (in f32, cast back)
        when the table is differentiated."""
        if not (table.requires_grad and torch.is_grad_enabled()):
            return table[0][self.nbr_idx[0].long()][None]
        b, n_t = table.shape[:2]
        flat = table.reshape(b, n_t, -1)
        rows = self.local.ops.gather_rows(flat.float().contiguous(),
                                          self.nbr_idx)
        n, k = self.nbr_idx.shape[1:]
        rows = rows.permute(0, 3, 2, 1).to(table.dtype)  # [1, n, K, C']
        return rows.reshape(b, n, k, *table.shape[2:])

    @staticmethod
    def _contract(coef, g):
        """``sum_k coef[n, k, j] g[n, k, c]`` for ``coef [1, n, K, J]`` f32
        and ``g [1, n, K, C]``: ``[1, n, J, C]`` f32. bf16 ``g`` meets the
        hi and lo bf16 halves of the coefficients in one product with
        f32 sums, and the halves' results are added (JAX's two
        ``einsum``s with ``preferred_element_type=f32``), no f32 copy of
        the edge tensor made."""
        a = coef[0].transpose(1, 2)  # [n, J, K]
        if g.dtype != torch.bfloat16:
            return torch.bmm(a, g[0])[None]
        if g.requires_grad and torch.is_grad_enabled():
            return _HiLoContract.apply(a, g[0])[None]
        hi = a.to(torch.bfloat16)
        lo = (a - hi.float()).to(torch.bfloat16)
        out = _bmm_f32(torch.cat([hi, lo], dim=1), g[0])
        j = a.shape[1]
        return (out[:, :j] + out[:, j:])[None]

    def grad(self, x):
        """``[1, n_l, C] -> [1, n_l, 2, C]`` in ``x``'s dtype."""
        xg = self._rows(self._full(x))  # [1, n_l, K, C]
        return self._contract(self.local.grad_coef, xg).to(x.dtype)

    def div(self, v):
        """``[1, n_l, 2, C] -> [1, n_l, C]`` in ``v``'s dtype."""
        vg = self._rows(self._full(v))  # [1, n_l, K, 2, C]
        b, n, k, _, c = vg.shape
        coef = self.local.div_coef.reshape(b, n, 2 * k, 1)
        return self._contract(coef, vg.reshape(b, n, 2 * k, c))[:, :, 0].to(
            v.dtype)

    def _gathered(self, table):
        """The rows of a FULL table as masked-ready neighbour values
        ``[1, n_l, K, C]``: bf16 stays bf16 (the max and min of bf16
        values are exact in it), any other dtype in f32."""
        g = self._rows(table)
        return g if g.dtype == torch.bfloat16 else g.float()

    def _max_of(self, g):
        neg = torch.tensor(_NEG, dtype=g.dtype, device=g.device)
        return torch.where(self.nbr_mask[..., None], g, neg).amax(dim=-2)

    def _min_of(self, g):
        pos = torch.tensor(-_NEG, dtype=g.dtype, device=g.device)
        return torch.where(self.nbr_mask[..., None], g, pos).amin(dim=-2)

    def _matmul_full(self, x, w):
        """``x @ w`` of the full table: f32 sums rounded to ``x``'s
        dtype."""
        return torch.matmul(self._full(x).float(), w.float()).to(x.dtype)

    def nbr_max(self, h):
        """Masked neighbour max; rows with no valid neighbour give 0."""
        out = self._max_of(self._gathered(self._full(h)))
        any_valid = self.nbr_mask.any(dim=-1, keepdim=True)
        return torch.where(any_valid, out, 0.0).to(h.dtype)

    def nbr_matmul_max(self, x, w):
        """Masked max of ``(x @ w)[nbr]``: the product of the full table,
        f32 sums rounded to ``x``'s dtype; rows with no valid neighbour
        give -3e38."""
        return self._max_of(self._gathered(self._matmul_full(x, w))).to(
            x.dtype)

    def nbr_minmax(self, h):
        """Masked neighbour ``(max, min)`` of the whole table's rows (JAX's
        sharded ``nbr_minmax``), bf16 for bf16 ``h``, else f32; rows with
        no valid neighbour give ``(-3e38, +3e38)``."""
        g = self._gathered(self._full(h))
        return self._max_of(g), self._min_of(g)

    def nbr_matmul_minmax(self, x, w):
        """Masked ``(max, min)`` of ``(x @ w)[nbr]``: the product of the
        full table rounded to ``x``'s dtype before the max and min, as
        JAX's sharded form (the unsharded hook always works in bf16)."""
        g = self._gathered(self._matmul_full(x, w))
        return self._max_of(g), self._min_of(g)

    def nbr_sum(self, h, mask=None):
        """``sum_k mask[n, k] h[nbr[n, k]]`` in f32 (JAX's sharded
        ``nbr_sum``): ``[1, n_l, C] -> [1, n_l, C]``; ``mask`` defaults to
        the graph's."""
        mask = self.nbr_mask if mask is None else mask
        g = self._rows(self._full(h)).float()
        return (g * mask[..., None].float()).sum(dim=-2)

    def nbr_gather(self, h):
        """Per-neighbour rows ``[1, n_l, C] -> [1, n_l, K, C]``."""
        return self._rows(self._full(h))


def shard_rows(x, group=None):
    """This rank's block of rows of a full ``[N, ...]`` array (N a
    multiple of the group's size: :func:`pad_cloud`)."""
    rank, size = rank_and_size(group)
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


def pad_cloud(pos, n_devices, normal=None):
    """Pads ``[N, 3]`` arrays to a multiple of ``n_devices`` rows and
    returns ``(pos, normal, point_mask)``; padded normals are unit z."""
    n = pos.shape[0]
    pad = (-n) % n_devices
    mask = torch.arange(n + pad, device=pos.device) < n
    if pad:
        pos = torch.cat([pos, pos.new_zeros((pad, 3))])
        if normal is not None:
            unit_z = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype,
                                  device=normal.device)
            normal = torch.cat([normal, unit_z.expand(pad, 3)])
    return pos, normal, mask


def _local_graph(pos, pos_full, k, offset, pm_full, knn_method, ops):
    """This rank's rows' ``(idx, mask)`` against the whole table: fillers
    beyond the table (>= N) and masked columns are invalid."""
    idx = _local_knn(pos, pos_full, k, offset, pm_full,
                     quantized=knn_method == "approx", ops=ops)
    n_full = pos_full.shape[0]
    mask = idx < n_full
    if pm_full is not None:
        mask &= pm_full[torch.clamp(idx, max=n_full - 1).long()]
    return idx, mask


def _build_local(pos, normal, point_mask, k, group, kernel_width,
                 regularizer, knn_method, ops, normal_k=10):
    """The operators of this rank's rows (the JAX ``shard_map`` body);
    without ``normal`` the frames are estimated from a ``normal_k``-NN
    graph against the whole table, as the unsharded build does."""
    rank, _ = rank_and_size(group)
    offset = rank * pos.shape[0]
    pos_full = all_gather(pos, group)
    pm_full = None if point_mask is None else all_gather(point_mask, group)
    idx, nbr_mask = _local_graph(pos, pos_full, k, offset, pm_full,
                                 knn_method, ops)
    if normal is None:
        nbr_n, mask_n = _local_graph(pos, pos_full, normal_k, offset,
                                     pm_full, knn_method, ops)
        nbr_n = torch.clamp(nbr_n, max=pos_full.shape[0] - 1)
        normal, xb, yb = (t[0] for t in estimate_basis(
            pos[None], nbr_n[None], mask_n[None], orientation=pos[None],
            table=pos_full[None]))
    else:
        xb, yb = build_tangent_basis(normal)
    table = torch.cat([pos_full, all_gather(xb, group),
                       all_gather(yb, group)], dim=-1)

    def avg_reduce(total, count):
        return psum(total, group) / torch.clamp(psum(count, group), min=1.0)

    return build_grad_div_tables(
        table[None], pos[None], normal[None], xb[None], yb[None], idx[None],
        nbr_mask[None], None if point_mask is None else point_mask[None],
        kernel_width, regularizer, avg_reduce,
        lambda m: pmax(m, group), ops)


def point_sharded_operators(pos, k: int, normal=None, point_mask=None,
                            group=None, kernel_width: float = 1.0,
                            regularizer: float = 0.001,
                            knn_method: str = "exact",
                            ops: Ops = KERNEL_OPS) -> GradDiv:
    """The operators of this rank's rows ``pos [n_l, 3]`` (with ``normal``
    and ``point_mask`` ``[n_l]``): a batch of one :class:`GradDiv` whose
    ``nbr_idx`` hold GLOBAL rows. Without ``normal`` the frames are
    estimated (a 10-NN graph against the whole cloud)."""
    return _build_local(pos, normal, point_mask, k, group, kernel_width,
                        regularizer, knn_method, ops)


def point_sharded_grad(gd: GradDiv, x, group=None):
    """``[n_l, C] -> [n_l, 2, C]`` through the sharded operators."""
    return ShardedGradDiv(gd, group).grad(x[None])[0]


def point_sharded_div(gd: GradDiv, v, group=None):
    """``[n_l, 2, C] -> [n_l, C]`` through the sharded operators."""
    return ShardedGradDiv(gd, group).div(v[None])[0]


def point_sharded_laplacian(pos, x, k: int, normal=None, group=None,
                            ops: Ops = KERNEL_OPS):
    """Sharded build, then ``-div(grad(x))`` of this rank's rows."""
    gd = point_sharded_operators(pos, k, normal=normal, group=group, ops=ops)
    return -point_sharded_div(gd, point_sharded_grad(gd, x, group), group)


def _forward(model, pos, normal, point_mask, group, ops, **kwargs):
    """The forward of a DeltaNet model on this rank's rows, in the
    model's mode (eval, or train: the operators built without a graph,
    the parameters differentiated)."""
    base = model.deltanet_base
    with torch.no_grad():
        gd = _build_local(pos, normal, point_mask, base.num_neighbors, group,
                          base.grad_kernel_width, base.grad_regularizer,
                          base.knn_method, ops)
    pm = None if point_mask is None else point_mask[None]
    nrm = None if normal is None else normal[None]
    return model(pos[None], nrm, pm, ops=ops,
                 operators=ShardedGradDiv(gd, group), group=group,
                 **kwargs)[0]


def point_sharded_classification(model, pos, normal=None, point_mask=None,
                                 group=None, ops: Ops = KERNEL_OPS):
    """Eval logits ``[num_classes]`` of ``DeltaNetClassification`` for ONE
    cloud whose rows are spread over ``group`` (``pos``, ``normal``,
    ``point_mask``: this rank's rows); the same on every rank."""
    return _forward(model, pos, normal, point_mask, group, ops)


def point_sharded_segmentation(model, pos, normal=None, point_mask=None,
                               category=None, group=None,
                               ops: Ops = KERNEL_OPS):
    """Per-point eval logits ``[n_l, num_classes]`` of
    ``DeltaNetSegmentation`` for this rank's rows of ONE cloud;
    ``category``: the ``[16]`` one-hot."""
    kwargs = {} if category is None else {"category": category[None]}
    return _forward(model, pos, normal, point_mask, group, ops, **kwargs)


def point_sharded_train_step(model, group=None, smoothing: float = 0.2,
                             per_point: bool = False,
                             ops: Ops = KERNEL_OPS):
    """Returns ``step(state, pos, normal, label, generator,
    point_mask=None, category=None) -> metrics`` (JAX's
    ``point_sharded_train_step``): one train step of a DeltaNet model
    (``state.model``) on ONE cloud whose rows are spread over ``group``.

    Each rank passes its rows: ``pos``, ``normal`` (or None) ``[n_l,
    3]``, ``point_mask`` ``[n_l]``; ``label`` the cloud's class (a 0-d
    int tensor), or with ``per_point`` this rank's ``[n_l]`` point
    labels; ``category`` the ``[16]`` one-hot. Every rank passes a
    generator in the same state: the classification head's dropout
    masks after the pools are then the same on every rank, and the
    segmentation head's are the whole cloud's, each rank keeping its
    points, so a step on D ranks equals the step on one, dropout
    included. (JAX's per-point sharded dropout folds the axis index into
    its key and cannot equal its own single-device step.)

    The loss is replicated on every rank: the classification loss of the
    pooled logits, or ``psum(sum nll m) / psum(sum m)`` per point. The
    backward runs through the differentiable collectives, which
    transpose as JAX's do, so each rank's gradient is the group's size
    times its share; the mean of the gradients over the ranks
    (:func:`pmean_gradients`) is the single-device gradient, and the
    optimizer steps with it on every rank. Every BatchNorm's moments are
    count-weighted across ranks (``nn.nonlin.batch_moments``), which
    holds on a padded cloud too, whose padding ``pad_cloud`` puts on the
    last rank. Returns ``{"loss", "accuracy"}`` (0-d, the same on every
    rank); updates ``state`` in place."""
    from ..training.losses import smooth_cross_entropy, smooth_nll
    from ..training.steps import _strict_f32

    params = [p for p in model.parameters() if p.requires_grad]

    def step(state, pos, normal, label, generator, point_mask=None,
             category=None):
        _strict_f32()
        model.train()
        kwargs = {} if category is None else {"category": category[None]}
        logits = _forward(model, pos, normal, point_mask, group, ops,
                          generator=generator, **kwargs)
        if per_point:
            nll = smooth_nll(logits, label, smoothing)
            m = (torch.ones_like(nll) if point_mask is None
                 else point_mask.to(nll.dtype))
            sums = psum(torch.stack([(nll * m).sum(), m.sum()]), group)
            loss = sums[0] / torch.clamp(sums[1], min=1.0)
        else:
            loss = smooth_cross_entropy(logits[None], label.reshape(1),
                                        smoothing)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        pmean_gradients(params, group)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            correct = (logits.argmax(dim=-1) == label).float()
            if per_point:
                sums = psum(torch.stack([(correct * m).sum(), m.sum()]),
                            group)
                accuracy = sums[0] / torch.clamp(sums[1], min=1.0)
            else:
                accuracy = correct.reshape(())
        return {"loss": loss.detach(), "accuracy": accuracy}

    return step
