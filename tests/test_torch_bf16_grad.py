"""Gradients for positions and normals of the bf16 train-mode models in
deltaconv_tpu_torch against ``jax.grad`` of the JAX package's on the CPU.

The production mix (bf16 compute and operators) differentiated in the
positions and normals: the f32 build under autograd (as in f32), the
bf16 dense applies differentiated in their coefficients (the sampled
product ``ops.coef_cotangent`` of the bf16 features widened to f32 and
the f32 cotangent), or the coefficient form's applies, and the bf16 train
modules' input cotangents (the neighbour max with winners, the edge
moments' neighbour sum, the gather-then-matmul max, the gathered edge
rows of the segmentation net's conv0).

The rounding point of the dense operators' cotangent. JAX differentiates
``einsum(w_bf16, x_bf16, preferred_element_type=f32)``; the jaxpr of its
VJP (checked with ``jax.make_jaxpr``) takes ``dW`` as an f32
``dot_general`` of the cotangent and the bf16 features, then
``convert_element_type`` to bf16: each apply's operator cotangent is
rounded to bf16 in every cell, and the applies' cotangents of the one
``W`` are added by ``add_any`` in bf16, before ``_densify_bwd`` (or, on
the CPU, the one-hot einsum's transpose, rounded to the bf16 of the cast
coefficients) gathers the edges' cells and widens them to f32. The port
rounds at the same points: its applies see the coefficients cast to
bf16, so autograd rounds each apply's ``coef_cotangent`` (an f64 dot
rounded to f32) to bf16 and adds the applies' in bf16, and the cast's
backward widens the sum. :func:`test_bf16_dense_vjp_matches_jax` holds
the two on one operator used twice.

Tolerances, and why:

- The dense VJP alone: the coefficients' cotangent is a dot of N
  products summed in f32 by XLA and in f64 by the port, each rounded
  once to bf16 (then added in bf16 across the two applies), and the
  features' cotangent an f32 sum over 2N in another order rounded to
  bf16: one bf16 ulp of the largest entry (2^-7 of its binade).
- The models: a whole bf16 train-mode forward is ill-conditioned at a
  test's size (one-ulp differences flip neighbour-max winners at bf16
  ties), as ``tests/test_torch_bf16_train.py`` measures for the
  parameters. So the gradients are held by their relative Frobenius
  distance to ``jax.grad`` of the JAX f32 model on the same weights and
  inputs: the port's bf16 gradient may lie at most 1.25 times as far
  from it as the JAX bf16 gradient does. A wrong rounding point, a
  missing term (a conv whose input takes no cotangent, an apply whose
  coefficients take none) or a gradient of the wrong sign moves that
  distance far more (dropping the coefficients' cotangent reads 1.3 to
  1.5; measured 0.92 to 1.14). The loss is held to the JAX bf16 loss at
  rtol 1e-2 (measured up to 5.7e-3; JAX's own jitted and eager bf16
  losses of one masked case differ by 4.3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.geometry.dense import _dense_from_coef
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.models import DeltaNetSegmentation as JaxSegModel
from deltaconv_tpu_torch import (DeltaNetClassification,
                                 DeltaNetSegmentation, state_dict_from_flax)
from deltaconv_tpu_torch.geometry import GradDiv, densify
from deltaconv_tpu_torch.ops import KERNEL_OPS
from test_torch_pos_grad import _clouds, _perturbed, _safe_row_norm, _t

torch.set_num_threads(1)

RATIO = 1.25  # the port's distance to the f32 gradient over JAX bf16's
LOSS_RTOL = 1e-2
N, K = 128, 12
CLS = dict(num_classes=4, conv_channels=(16, 16), embedding_size=32,
           num_neighbors=K, dropout=0.0)
SEG = dict(num_classes=6, conv_channels=(8, 16), embedding_size=32,
           num_neighbors=K, dropout=0.0)
BF16 = dict(compute_dtype="bfloat16", operator_dtype="bfloat16")


def _np(t):
    return t.detach().float().numpy()


def _frob(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _one_ulp(got, want, what):
    """Within one bf16 ulp of ``want``'s largest entry."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=ulp,
                               err_msg=what)


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
def test_bf16_dense_vjp_matches_jax(masked):
    """One bf16 dense operator pair, each applied twice (grad on ``x`` and
    on ``y``, div on ``v`` and on ``u``), differentiated in the f32
    coefficients and the bf16 features: the port's ``densify`` + applies
    against ``jax.grad`` of JAX's bf16 assembly (``_dense_from_coef``,
    its CPU route) + ``DenseGradDiv.grad/div``; one bf16 ulp of the
    largest entry."""
    rng = np.random.default_rng(0)
    b, n, k, c = 2, 64, 8, 12
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    mask = np.ones((b, n, k), bool)
    if masked:  # masked slots hold zero coefficients and clamp to self
        mask = rng.random((b, n, k)) > 0.3
        mask[:, :, 0] = True
        idx = np.where(mask, idx, np.arange(n)[None, :, None]).astype(
            np.int32)
    gc = (rng.standard_normal((b, n, k, 2)) * mask[..., None]).astype(
        np.float32)
    dc = (rng.standard_normal((b, n, k, 2)) * mask[..., None]).astype(
        np.float32)
    feats = [jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(
        jnp.bfloat16) for s in ((b, n, c), (b, n, c), (b, n, 2, c),
                                (b, n, 2, c))]
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((b, n, 2, c), (b, n, 2, c), (b, n, c), (b, n, c))]

    def jax_loss(gc_, dc_, x, y, v, u):
        w = [_dense_from_coef(jnp.asarray(idx), co, n, jnp.bfloat16).astype(
            jnp.bfloat16) for co in (gc_, dc_)]
        gd = JaxDenseGradDiv(jnp.asarray(idx), jnp.asarray(mask), *w)
        outs = (gd.grad(x), gd.grad(y), gd.div(v), gd.div(u))
        return sum(jnp.sum(o.astype(jnp.float32) * ct)
                   for o, ct in zip(outs, cts))

    want = jax.grad(jax_loss, argnums=range(6))(jnp.asarray(gc),
                                                jnp.asarray(dc), *feats)
    gct, dct = _t(gc).requires_grad_(), _t(dc).requires_grad_()
    tf = [torch.from_numpy(np.asarray(f, np.float32)).to(
        torch.bfloat16).requires_grad_() for f in feats]
    gd = densify(GradDiv(nbr_idx=_t(idx), nbr_mask=_t(mask), grad_coef=gct,
                         div_coef=dct, ops=KERNEL_OPS), KERNEL_OPS,
                 torch.bfloat16)
    assert gd.w_grad.dtype == torch.bfloat16 and gd.w_grad.grad_fn is None
    outs = (gd.grad(tf[0]), gd.grad(tf[1]), gd.div(tf[2]), gd.div(tf[3]))
    sum((o.float() * _t(ct)).sum() for o, ct in zip(outs, cts)).backward()
    for got, w, what in zip((gct.grad, dct.grad, *(f.grad for f in tf)),
                            want, ("grad_coef", "div_coef", "x", "y", "v",
                                   "u")):
        assert got.dtype == (torch.float32 if what.endswith("coef")
                             else torch.bfloat16), what
        _one_ulp(got, w, what)


def _jax_variables(model, rng, pos, nrm, **kw):
    variables = jax.jit(lambda key, p, q: model.init(key, p, normal=q, **kw))(
        jax.random.PRNGKey(0), pos, nrm)
    return {name: _perturbed(jax.tree_util.tree_map(
        np.asarray, dict(variables[name])), rng, True)
        for name in ("params", "batch_stats")}


def _jax_grads(model, variables, pos, nrm, mask, labels, **kw):
    """The loss and ``(d pos, d normal)`` of the JAX model in train mode
    (the mean cross entropy over the logits' rows)."""
    def loss(p, q):
        out, _ = model.apply(variables, p, normal=q, point_mask=mask,
                             train=True, mutable=["batch_stats"], **kw)
        logp = jax.nn.log_softmax(out.reshape(-1, out.shape[-1]))
        lab = labels.reshape(-1)
        return -jnp.mean(logp[jnp.arange(lab.shape[0]), lab])

    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jnp.asarray(pos), jnp.asarray(nrm))
    return float(value), [np.asarray(g) for g in grads]


def _port_grads(port, pos, nrm, mask, labels, **kw):
    port.train()
    p, q = _t(pos).requires_grad_(), _t(nrm).requires_grad_()
    out = port(p, q, None if mask is None else _t(mask), **kw)
    loss = torch.nn.functional.cross_entropy(
        out.reshape(-1, out.shape[-1]), _t(labels).reshape(-1).long())
    loss.backward()
    assert p.grad.dtype == q.grad.dtype == torch.float32
    return float(loss.detach()), [p.grad.numpy(), q.grad.numpy()]


def _hold(cfg_cls, jax_cls, head, rng, dense, masked, monkeypatch,
          labels_of, **kw):
    """The bf16 model's position and normal gradients, port against JAX,
    held as the module docstring says."""
    cfg = dict(cfg_cls, dense_operators=dense)
    sizes = [N, 90, N, 100] * 2 if masked else [N] * 8
    pos, nrm, mask = _clouds(rng, sizes)
    labels = labels_of(rng, len(sizes))
    f32 = jax_cls(**cfg)
    variables = _jax_variables(f32, rng, pos[:2], nrm[:2],
                               **{key: v[:2] for key, v in kw.items()})
    jmask = jnp.asarray(mask) if masked else None
    if masked:
        _safe_row_norm(monkeypatch)
    jkw = {key: jnp.asarray(v) for key, v in kw.items()}
    loss32, want32 = _jax_grads(f32, variables, pos, nrm, jmask,
                           jnp.asarray(labels), **jkw)
    want_loss, want16 = _jax_grads(jax_cls(**cfg, **BF16), variables, pos,
                                   nrm, jmask, jnp.asarray(labels), **jkw)
    port_cls = (DeltaNetClassification if head == "classification"
                else DeltaNetSegmentation)
    port = port_cls(**cfg, **BF16)
    port.load_state_dict(state_dict_from_flax(variables["params"],
                                              variables["batch_stats"],
                                              head), strict=True)
    loss, got = _port_grads(port, pos, nrm, mask if masked else None,
                            labels, **{key: _t(v) for key, v in kw.items()})
    print(f"loss: port {loss}, JAX bf16 {want_loss}, JAX f32 {loss32}")
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    for g, w16, w32, what in zip(got, want16, want32, ("pos", "normal")):
        assert np.all(np.isfinite(g)), what
        port_err, jax_err = _frob(g, w32), _frob(w16, w32)
        print(f"{what}: port {port_err:.3e}, JAX bf16 {jax_err:.3e} from "
              f"the f32 gradient; port from JAX bf16 {_frob(g, w16):.3e}")
        assert port_err <= RATIO * jax_err, (what, port_err, jax_err)
    if masked:  # padded points take no part
        assert float(np.abs(got[0][1, 90:]).max()) == 0.0


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coef"])
@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
def test_classifier_bf16_position_gradients_match_jax(masked, dense,
                                                      monkeypatch):
    """``d loss / d pos`` and ``d loss / d normal`` of the narrow bf16
    classifier (conv (16, 16), k=12, 8 clouds of N=128, exact kNN, train
    mode on batch statistics, dropout 0; bf16 compute, and bf16 dense
    operators or the coefficient form) against ``jax.grad`` of the JAX
    bf16 model on the same weights: uniform, and clouds of 90 and 100
    points padded to 128."""
    _hold(CLS, JaxModel, "classification", np.random.default_rng(10), dense,
          masked, monkeypatch, lambda rng, b: np.arange(b) % 4)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coef"])
def test_segmentation_bf16_position_gradients_match_jax(dense, monkeypatch):
    """The same for the narrow bf16 segmentation net (conv (8, 16), depth
    2: conv0 the centralized ``DeepMaxMLP`` on gathered edge rows; the
    categorical head; per-point labels)."""
    cats = np.eye(16, dtype=np.float32)[np.arange(8) % 16]
    _hold(dict(SEG, categorical_vector=True), JaxSegModel, "segmentation",
          np.random.default_rng(11), dense, False, monkeypatch,
          lambda rng, b: rng.integers(0, 6, (b, N)), category=cats)
