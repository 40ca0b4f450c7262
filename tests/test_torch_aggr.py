"""``DeltaConv(aggr=...)`` and ``gather_neighbors`` in deltaconv_tpu_torch
against the JAX package on the CPU.

JAX's ``DeltaConv`` takes ``aggr`` "max" (its default, the branches the
other tests hold), "mean" or "sum"/"add": the scalar max branch is then
a plain MLP, on the gathered edge differences ``x_j - x_i`` when
centralized (its BatchNorm statistics over the valid edges when a point
mask is given), else on each point, and ``_aggregate``'s masked sum or
mean (over the valid-slot count, at least 1) reduces the neighbour axis.
The port gathers the edge rows with ``gd.nbr_gather`` (``gather_rows``,
backward ``scatter_rows``) and sums a point's neighbours with
``gd.nbr_sum`` (``gather_sum``, backward ``gather_sum_bwd``). Inputs are
numpy arrays from a seed, the operators the port's, handed to the JAX
layer; weights move across with ``state_dict_from_flax``.

Tolerances, and why:

- f32: the same arithmetic in another order: outputs within 1e-5 x max,
  parameter and input gradients within 1e-4 x max, running statistics
  within 1e-5 x max (``tests/test_torch_train.py``'s DeltaConv bounds).
- bf16, the scalar branch alone (``AggrMLP`` against JAX's lines of the
  same branch): JAX sums the bf16 edge values in f32 (``jnp.sum``
  upcasts) and rounds once, as the port does, but its f32 epilogues fuse
  into FMAs, so the bounds of ``tests/test_torch_bf16_train.py``'s
  modules: the output within one bf16 ulp of its largest entry (2^-7 of
  that entry's binade), gradients by their relative Frobenius deviation
  (below 2e-2), running statistics within 1e-5 x max.
- ``gather_neighbors``: a gather, exact.
"""

import flax.linen as lnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.nn.deltaconv as jax_dc
from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.nn import gather_neighbors as jax_gather_neighbors
from deltaconv_tpu.nn.deltaconv import DeltaConv as JaxDeltaConv
from deltaconv_tpu.nn.mlp import MLP as JaxMLP
from deltaconv_tpu_torch import state_dict_from_flax
from deltaconv_tpu_torch.models import build_operators
from deltaconv_tpu_torch.nn import AggrMLP, DeltaConv, gather_neighbors
from test_torch_bf16_train import _clouds, _perturb, _t, _to_numpy

torch.set_num_threads(1)

B, N, K = 2, 96, 8
GRAD_FROB = 2e-2


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _one_ulp(got, want, what):
    """Within one bf16 ulp of ``want``'s largest entry (2^-7 of its
    binade)."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=ulp,
                               err_msg=what)


def _frob(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(_np(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _operators(rng, masked, bf16):
    """The port's operators of a batch (bf16 or f32 dense), the same
    arrays as a JAX DenseGradDiv, and the point mask (None when
    uniform)."""
    pos, nrm, mask = _clouds(rng, [N, 60] if masked else [N] * B)
    pm = _t(mask) if masked else None
    gd = build_operators(_t(pos), K, _t(nrm), pm,
                         operator_dtype="bfloat16" if bf16 else None)
    jw = [jnp.asarray(w.float().numpy()) for w in (gd.w_grad, gd.w_div)]
    if bf16:
        jw = [w.astype(jnp.bfloat16) for w in jw]
    jgd = JaxDenseGradDiv(jnp.asarray(gd.nbr_idx.numpy()),
                          jnp.asarray(gd.nbr_mask.numpy()), *jw)
    return gd, jgd, pm


def _inputs(rng, shape, bf16):
    """(jnp, torch) of the same values, bf16 or f32; torch's requires
    grad."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    if bf16:
        j = j.astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j, np.float32))
    return j, (t.to(torch.bfloat16) if bf16 else t).requires_grad_()


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("centralized", [True, False],
                         ids=["centralized", "per-point"])
@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_deltaconv_aggr_train_matches_jax(aggr, centralized, masked):
    """One f32 train-mode DeltaConv with ``aggr`` mean or sum, centralized
    (3 -> 8, on positions) or not (8 -> 8), uniform or ragged: outputs,
    the gradients of every parameter and of both inputs, and the running
    statistics, against the JAX layer on the same operators and
    weights."""
    rng = np.random.default_rng(20)
    c_in, c_out = (3 if centralized else 8), 8
    gd, jgd, pm = _operators(rng, masked, False)
    x, tx = _inputs(rng, (B, N, c_in), False)
    v, tv = _inputs(rng, (B, N, 2, c_in), False)
    ct_x = rng.standard_normal((B, N, c_out)).astype(np.float32)
    ct_v = rng.standard_normal((B, N, 2, c_out)).astype(np.float32)
    jpm = None if pm is None else jnp.asarray(pm.numpy())
    layer = JaxDeltaConv(c_out, centralized=centralized, aggr=aggr)
    variables = layer.init(jax.random.PRNGKey(0), x, v, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)

    def loss(p, x_, v_):
        (xo, vo), mutated = layer.apply(
            {"params": p, "batch_stats": stats}, x_, v_, jgd, train=True,
            point_mask=jpm, mutable=["batch_stats"])
        return (jnp.sum(xo * ct_x) + jnp.sum(vo * ct_v),
                (xo, vo, mutated["batch_stats"]))

    (_, (jx, jv, mutated)), (jgrad, jdx, jdv) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(params, x, v)

    port = DeltaConv(c_in, c_out, centralized=centralized, aggr=aggr)
    assert isinstance(port.s_mlp_max, AggrMLP)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train()
    ox, ov = port(tx, tv, gd, pm)
    ((ox * _t(ct_x)).sum() + (ov * _t(ct_v)).sum()).backward()
    _close(ox, jx, 1e-5, "x'")
    _close(ov, jv, 1e-5, "v'")
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    want_grad = state_dict_from_flax(_to_numpy(jgrad), zero)
    for key, p in port.named_parameters():
        _close(p.grad, want_grad[key].numpy(), 1e-4, key)
    _close(tx.grad, jdx, 1e-4, "d x")
    _close(tv.grad, jdv, 1e-4, "d v")
    want_stats = state_dict_from_flax(params, _to_numpy(mutated))
    for key, b in port.named_buffers():
        _close(b, want_stats[key].numpy(), 1e-5, key)


class _JaxAggr(lnn.Module):
    """The scalar branch of JAX ``DeltaConv`` with ``aggr`` mean or sum,
    its lines as they stand (``deltaconv.py``: the edge MLP of a
    centralized conv, or the MLP a point, gathered; ``_aggregate``)."""

    channels: tuple
    centralized: bool
    aggr: str
    dtype: str

    @lnn.compact
    def __call__(self, x, gd, train, stats_mask):
        mlp = JaxMLP(self.channels, dtype=self.dtype, name="s_mlp_max")
        if self.centralized:
            h = mlp(gd.nbr_gather(x) - x[..., :, None, :], train=train,
                    mask=stats_mask)
        else:
            h = gd.nbr_gather(mlp(x, train=train, mask=stats_mask))
        return jax_dc._aggregate(h, gd.nbr_mask, self.aggr)


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("centralized", [True, False],
                         ids=["centralized", "per-point"])
@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_aggr_branch_bf16_train_matches_jax(aggr, centralized, masked):
    """The bf16 scalar branch alone (``AggrMLP``, 3 -> 8 centralized or 8
    -> 16 per point, bf16 operators' graph) in train mode against JAX's:
    output, parameter and input gradients, running statistics. (A whole
    bf16 DeltaConv adds the vector stream and ``s_mlp``, which
    ``tests/test_torch_bf16_train.py`` holds; at this test's inputs they
    alone move a parameter gradient by up to 3.7e-2 with ``aggr="max"``
    too, measured.)"""
    rng = np.random.default_rng(22)
    c_in, c_out = (3, 8) if centralized else (8, 16)
    gd, jgd, pm = _operators(rng, masked, True)
    if centralized:  # the edges of valid points, as DeltaConv gives
        stats_mask = gd.nbr_mask if pm is not None else None
    else:
        stats_mask = pm
    jstats = None if stats_mask is None else jnp.asarray(stats_mask.numpy())
    x, tx = _inputs(rng, (B, N, c_in), True)
    ct = rng.standard_normal((B, N, c_out)).astype(np.float32)
    layer = _JaxAggr((c_out,), centralized, aggr, "bfloat16")
    variables = layer.init(jax.random.PRNGKey(0), x, jgd, False, None)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)

    def loss(p, x_):
        out, mutated = layer.apply({"params": p, "batch_stats": stats}, x_,
                                   jgd, True, jstats, mutable=["batch_stats"])
        return (jnp.sum(out.astype(jnp.float32) * ct),
                (out, mutated["batch_stats"]))

    (_, (want, mutated)), (jgrad, jdx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)

    port = AggrMLP(c_in, [c_out], centralized, aggr, torch.bfloat16)
    strip = len("s_mlp_max.")
    port.load_state_dict({k[strip:]: w for k, w in state_dict_from_flax(
        params, stats).items()}, strict=True)
    port.train()
    out = port(tx, gd, stats_mask)
    (out.float() * _t(ct)).sum().backward()
    assert out.dtype == tx.grad.dtype == torch.bfloat16
    _one_ulp(out, want, "output")
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    want_grad = state_dict_from_flax(_to_numpy(jgrad), zero)
    grads = [(p.grad, want_grad["s_mlp_max." + key].numpy(), key)
             for key, p in port.named_parameters()] + [(tx.grad, jdx, "d x")]
    for got, w, what in grads:
        assert _frob(got, w) < GRAD_FROB, (what, _frob(got, w))
    want_stats = state_dict_from_flax(params, _to_numpy(mutated))
    for key, b in port.named_buffers():
        _close(b, want_stats["s_mlp_max." + key].numpy(), 1e-5, key)


def test_deltaconv_rejects_an_unknown_aggregation():
    with pytest.raises(ValueError, match="aggregation"):
        DeltaConv(3, 8, aggr="min")


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_gather_neighbors_matches_jax(lead):
    """``x [..., N, C], idx [..., N, K] -> [..., N, K, C]`` with 0, 1 and 2
    leading batch axes: equal to JAX's; the gradient is the scatter-add
    of the cotangent rows."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal(lead + (N, 5)).astype(np.float32)
    idx = rng.integers(0, N, lead + (N, K)).astype(np.int32)
    want = jax_gather_neighbors(jnp.asarray(x), jnp.asarray(idx))
    xt = _t(x).requires_grad_()
    got = gather_neighbors(xt, _t(idx))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    ct = rng.standard_normal(got.shape).astype(np.float32)
    got.backward(_t(ct))
    _, vjp = jax.vjp(lambda a: jax_gather_neighbors(a, jnp.asarray(idx)),
                     jnp.asarray(x))
    _close(xt.grad, vjp(jnp.asarray(ct))[0], 1e-6, "gradient")
