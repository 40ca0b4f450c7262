"""Gradients for positions and normals in deltaconv_tpu_torch against the
JAX package on the CPU.

The port differentiates its operator build as the JAX package's custom
VJPs do: the gather through ``scatter_rows``, the WLS solve through
``wls_bwd`` (JAX ``_wls_bwd_pallas``), the dense assembly through
``densify_bwd`` (JAX ``_densify_bwd``). Here the plain versions are held
against the JAX Pallas functions in interpret mode, the build against
``jax.grad`` through the JAX fused build, and a narrow f32 classifier's
``d loss / d pos`` and ``d loss / d normal`` against ``jax.grad`` of the
JAX model's ``apply`` (its XLA build on the CPU), eval and train mode,
uniform and masked, dense and coefficient form, on the same weights
(``state_dict_from_flax``). Inputs are numpy arrays from a seed.

Tolerances, and why (each measured, the worst of the cases below):

- The WLS VJP: the same f32 math differentiated by ``jax.vjp`` in one
  order of operations and by torch autograd in another: 1e-5 x each
  plane's max (measured 1.2e-6).
- The assembly's VJP is a gather: exact.
- The build (``sum(grad_coef^2) + sum(sin(div_coef))``, JAX's own
  gradient test, tests/ops/test_kernels.py:826-852): the JAX kernels
  gather through bf16 ``hi + lo`` halves (about 16 mantissa bits), the
  port exactly: 5e-4 x max (measured 5.6e-5), inside JAX's atol 5e-4,
  rtol 1e-3.
- The model: the JAX XLA build against the port's, f32 through the whole
  network: 1e-4 x max|grad| (measured 9.9e-6); the loss at rtol 1e-5.
  Train mode perturbs the running statistics only and takes 8 clouds, as
  tests/test_torch_train.py does (its docstring says why: BatchNorm of
  two rows amplifies single-ulp differences).

A padded cloud's gradient is NaN in the JAX package: the build's row norm
``jnp.linalg.norm`` of a padded point's all-zero row has a 0/0 VJP
(grad_div.py, ``build_grad_div_tables``), and the NaN reaches every
position of the cloud. The port takes the norm's subgradient 0 there (the
PyTorch convention, which the JAX package's ``safe_norm`` adopts for the
same reason elsewhere), so its gradient is finite; the masked cases hold
the port against the JAX model with that one norm replaced by a safe
one.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.geometry.frames import \
    build_tangent_basis as jax_tangent_basis
from deltaconv_tpu.geometry.knn import knn as jax_knn
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu_torch import (KERNEL_OPS, PLAIN_OPS,
                                 DeltaNetClassification, launch_counts,
                                 reset_launch_counts, state_dict_from_flax)
from deltaconv_tpu_torch import ops
from deltaconv_tpu_torch.geometry import build_tangent_basis, knn
from deltaconv_tpu_torch.models import (build_dense_operators_fused,
                                        build_operators)
from deltaconv_tpu_torch.ops.wls_fused import edge_planes

# The modules (the package's ``ops`` exports functions of these names).
jax_wls = importlib.import_module("deltaconv_tpu.ops.wls_fused")
jax_densify = importlib.import_module("deltaconv_tpu.ops.densify_op")
jax_grad_div = importlib.import_module("deltaconv_tpu.geometry.grad_div")

torch.set_num_threads(1)

WLS_REL = 1e-5
BUILD_REL = 5e-4
MODEL_REL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _within(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert np.all(np.isfinite(got)), what
    tol = rel * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _cloud(rng, b, n, flat=False):
    pos = rng.random((b, n, 3)).astype(np.float32)
    nrm = rng.standard_normal((b, n, 3)).astype(np.float32)
    if flat:  # cloud 1 nearly flat, its normals up
        pos[1, :, 2] *= 1e-3
        nrm[1] = (0.0, 0.0, 1.0)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return pos, nrm


@pytest.mark.parametrize("masked,flat", [(False, False), (True, True)],
                         ids=["uniform", "masked-flat"])
def test_wls_vjp_matches_jax(masked, flat):
    """#4: the port's ``wls_bwd`` (and the backward of the differentiated
    ``ops.wls``) against JAX ``_wls_bwd_pallas`` in interpret mode on the
    same edges and cotangents, masked edges and a nearly flat
    neighbourhood included."""
    rng = np.random.default_rng(0)
    b, n, k = 2, 64, 10
    pos, nrm = _cloud(rng, b, n, flat)
    pm = None
    if masked:
        pm = torch.ones((b, n), dtype=torch.bool)
        pm[0, 40:] = False
    idx, mask = knn(_t(pos), k, pm)
    if masked:
        mask = mask & pm[:, :, None]
    xb, yb = build_tangent_basis(_t(nrm))
    edges = edge_planes(_t(pos), _t(nrm), xb, yb, idx, mask,
                        mask.any(dim=2).to(torch.float32)).contiguous()
    ctg = rng.standard_normal((b, 2, k, n)).astype(np.float32)
    ctd = rng.standard_normal((b, 2, k, n)).astype(np.float32)
    (want,) = jax_wls._wls_bwd_pallas(
        jnp.asarray(edges.numpy()), (jnp.asarray(ctg), jnp.asarray(ctd)),
        1.0, 1e-3, 64, True)
    want = np.asarray(want)
    got = ops.wls_bwd(edges, _t(ctg), _t(ctd), 1.0, 1e-3)
    e = edges.clone().requires_grad_()
    g, d = ops.wls(e, 1.0, 1e-3)
    torch.autograd.backward((g, d), (_t(ctg), _t(ctd)))
    torch.testing.assert_close(e.grad, got, rtol=0, atol=0)
    for p in range(12):
        _within(got[:, p], want[:, p], WLS_REL, f"plane {p}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_densify_vjp_matches_jax(dtype):
    """#6: the port's ``densify_coefs`` VJP (``densify_bwd``) against JAX
    ``_densify_bwd`` in interpret mode, f32 and bf16 bodies (bf16
    cotangents read as f32): exact, it is a gather. Padded slots clamped
    to self repeat a column."""
    rng = np.random.default_rng(1)
    b, n, k = 2, 96, 8
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    idx[:, :, -2:] = np.arange(n)[None, :, None]
    gc = _t(rng.standard_normal((b, n, k, 2)).astype(np.float32))
    dc = _t(rng.standard_normal((b, n, k, 2)).astype(np.float32))
    dwg = _t(rng.standard_normal((b, 2, n, n)).astype(np.float32)).to(dtype)
    dwd = _t(rng.standard_normal((b, 2, n, n)).astype(np.float32)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, want_g, want_d = jax_densify._densify_bwd(
        "bfloat16" if dtype == torch.bfloat16 else "float32", 128, True,
        (jnp.asarray(idx), jnp.zeros((0,), jnp.float32)),
        (jnp.asarray(dwg.float().numpy()).astype(jdt),
         jnp.asarray(dwd.float().numpy()).astype(jdt)))
    gcr, dcr = gc.clone().requires_grad_(), dc.clone().requires_grad_()
    wg, wd = ops.densify_coefs(_t(idx), gcr, dcr, dtype)
    assert wg.dtype == dtype
    torch.autograd.backward((wg, wd), (dwg, dwd))
    for got, want in ((gcr.grad, want_g), (dcr.grad, want_d)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _build_inputs(rng, b=2, n=64, k=10):
    pos, nrm = _cloud(rng, b, n)
    nbr, mask = jax.jit(jax.vmap(lambda p: jax_knn(p, k)))(jnp.asarray(pos))
    return pos, nrm, np.asarray(nbr), np.asarray(mask)


def _jax_build(p, q, nbr, mask):
    xb, yb = jax_tangent_basis(q)
    return jax_wls.build_grad_div_fused(p, q, xb, yb, nbr, mask, tile=64,
                                        interpret=True)


def _port_build(p, q, nbr, mask, route):
    xb, yb = build_tangent_basis(q)
    return ops.build_grad_div_fused(p, q, xb, yb, nbr, mask, ops=route)


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_build_gradient_matches_jax(route):
    """The build's loss of tests/ops/test_kernels.py:836-845,
    ``sum(grad_coef^2) + sum(sin(div_coef))``, differentiated in ``pos``
    and in ``normal`` (through the tangent frames): the port's
    ``build_grad_div_fused`` (CPU: the kernel wrappers' Functions, or the
    plain bundle) against ``jax.grad`` through the JAX fused build in
    interpret mode."""
    pos, nrm, nbr, mask = _build_inputs(np.random.default_rng(2))
    bundle = KERNEL_OPS if route == "kernels" else PLAIN_OPS

    def jloss(p, q):
        gd = _jax_build(p, q, nbr, mask)
        return jnp.sum(gd.grad_coef ** 2) + jnp.sum(jnp.sin(gd.div_coef))

    want_p, want_n = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos),
                                                     jnp.asarray(nrm))
    p, q = _t(pos).requires_grad_(), _t(nrm).requires_grad_()
    gd = _port_build(p, q, _t(nbr), _t(mask), bundle)
    loss = (gd.grad_coef ** 2).sum() + torch.sin(gd.div_coef).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(pos, nrm)),
                               rtol=1e-5)
    _within(p.grad, want_p, BUILD_REL, "pos")
    _within(q.grad, want_n, BUILD_REL, "normal")


def test_build_gradient_through_densify_matches_jax():
    """The same build, then the f32 dense assembly (``densify_coefs``, JAX
    in interpret mode): a loss of both dense operators differentiated in
    ``pos`` and ``normal``."""
    rng = np.random.default_rng(3)
    pos, nrm, nbr, mask = _build_inputs(rng)
    r = rng.standard_normal((2, 2, 64, 64)).astype(np.float32)

    def jloss(p, q):
        gd = _jax_build(p, q, nbr, mask)
        wg, wd = jax_densify.densify_coefs(jnp.asarray(nbr), gd.grad_coef,
                                           gd.div_coef, "float32", 64, True)
        return jnp.sum(wg * r) + jnp.sum(jnp.sin(wd))

    want_p, want_n = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos),
                                                     jnp.asarray(nrm))
    p, q = _t(pos).requires_grad_(), _t(nrm).requires_grad_()
    gd = _port_build(p, q, _t(nbr), _t(mask), KERNEL_OPS)
    reset_launch_counts()
    wg, wd = ops.densify_coefs(gd.nbr_idx, gd.grad_coef, gd.div_coef)
    ((wg * _t(r)).sum() + torch.sin(wd).sum()).backward()
    assert sum(launch_counts().values()) == 0  # CPU: the plain versions
    _within(p.grad, want_p, BUILD_REL, "pos")
    _within(q.grad, want_n, BUILD_REL, "normal")


MODEL_N, MODEL_K = 128, 12
NARROW = dict(num_classes=4, conv_channels=(16, 16), embedding_size=32,
              num_neighbors=MODEL_K, dropout=0.0)


def _clouds(rng, sizes):
    """Padded ellipsoid clouds with analytic normals and a point mask."""
    b = len(sizes)
    pos = np.zeros((b, MODEL_N, 3), np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (b, MODEL_N, 1))
    for i, m in enumerate(sizes):
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((m, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        q = d / axes
        pos[i, :m] = d * axes
        nrm[i, :m] = q / np.linalg.norm(q, axis=1, keepdims=True)
    mask = np.arange(MODEL_N)[None, :] < np.asarray(sizes)[:, None]
    return pos, nrm, mask


def _perturbed(tree, rng, stats_only):
    """Running statistics and, unless ``stats_only``, BatchNorm scales
    (both signs) away from their init."""
    out = {}
    for key, x in tree.items():
        if isinstance(x, dict):
            out[key] = _perturbed(x, rng, stats_only)
        elif key == "mean":
            out[key] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif key == "var":
            out[key] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif key == "scale" and not stats_only:
            out[key] = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        else:
            out[key] = np.asarray(x)
    return out


def _model_pair(rng, dense, stats_only=False):
    model = JaxModel(**NARROW, dense_operators=dense)
    pos, nrm, _ = _clouds(rng, [MODEL_N] * 2)
    variables = jax.jit(lambda key, p, q: model.init(key, p, normal=q))(
        jax.random.PRNGKey(0), pos, nrm)
    params = _perturbed(jax.tree_util.tree_map(
        np.asarray, dict(variables["params"])), rng, stats_only)
    stats = _perturbed(jax.tree_util.tree_map(
        np.asarray, dict(variables["batch_stats"])), rng, stats_only)
    port = DeltaNetClassification(**NARROW, dense_operators=dense)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model, {"params": params, "batch_stats": stats}, port


def _jax_grads(model, variables, pos, nrm, mask, labels, train):
    def loss(p, q):
        kw = dict(normal=q, point_mask=mask, train=train)
        if train:
            out, _ = model.apply(variables, p, **kw, mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        else:
            out = model.apply(variables, p, **kw)
        logp = jax.nn.log_softmax(out)
        return -jnp.mean(logp[jnp.arange(labels.shape[0]), labels])

    (value, grads) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jnp.asarray(pos), jnp.asarray(nrm))
    return float(value), [np.asarray(g) for g in grads]


def _safe_row_norm(monkeypatch):
    """The JAX build's ``jnp`` with ``linalg.norm`` as a norm whose VJP at
    an all-zero row is 0 (the same values); traces made before are
    dropped."""
    def norm(x, axis=None, keepdims=False):
        sq = jnp.sum(x * x, axis=axis, keepdims=keepdims)
        pos = sq > 0
        return jnp.where(pos, jnp.sqrt(jnp.where(pos, sq, 1.0)), 0.0)

    shim = types.SimpleNamespace(
        **{name: getattr(jnp, name) for name in dir(jnp)
           if not name.startswith("__")})
    shim.linalg = types.SimpleNamespace(
        **{name: getattr(jnp.linalg, name) for name in dir(jnp.linalg)
           if not name.startswith("__")})
    shim.linalg.norm = norm
    monkeypatch.setattr(jax_grad_div, "jnp", shim)
    jax.clear_caches()


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coef"])
@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_model_position_gradients_match_jax(train, masked, dense,
                                            monkeypatch):
    """``d loss / d pos`` and ``d loss / d normal`` of the narrow f32
    classifier (conv (16, 16), k=12, B=2, N=128, exact kNN; the cross
    entropy of its logits) against ``jax.grad`` of the JAX model's
    ``apply`` on the same weights: eval, and train mode on batch
    statistics; uniform, and a cloud of 90 points padded to 128; dense
    operators and the coefficient form."""
    rng = np.random.default_rng(4)
    model, variables, port = _model_pair(rng, dense, stats_only=train)
    sizes = [MODEL_N, 90] if masked else [MODEL_N] * 2
    if train:  # batch statistics over 8 clouds, as tests/test_torch_train.py
        sizes = sizes * 4
    pos, nrm, mask = _clouds(rng, sizes)
    labels = np.arange(len(sizes)) % 4
    jmask = jnp.asarray(mask) if masked else None
    if masked:
        _safe_row_norm(monkeypatch)
    want_loss, (want_p, want_n) = _jax_grads(model, variables, pos, nrm,
                                             jmask, jnp.asarray(labels),
                                             train)
    port.train(train)
    p, q = _t(pos).requires_grad_(), _t(nrm).requires_grad_()
    logits = port(p, q, _t(mask) if masked else None)
    loss = torch.nn.functional.cross_entropy(logits, _t(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _within(p.grad, want_p, MODEL_REL, "pos")
    _within(q.grad, want_n, MODEL_REL, "normal")
    if masked:  # padded points take no part
        assert float(p.grad[1, 90:].abs().max()) == 0.0


def test_padded_cloud_gradient_is_nan_in_jax_and_finite_in_the_port():
    """The JAX package's fault that the port does not copy (see the module
    docstring): on the unchanged JAX build a padded cloud's position
    gradient is NaN; the port's is finite."""
    rng = np.random.default_rng(5)
    model, variables, port = _model_pair(rng, True)
    pos, nrm, mask = _clouds(rng, [MODEL_N, 90])
    jax.clear_caches()
    _, (want_p, _) = _jax_grads(model, variables, pos, nrm,
                                jnp.asarray(mask), jnp.asarray([1, 3]), False)
    assert np.isnan(want_p[1]).any() and np.isfinite(want_p[0]).all()
    port.eval()
    p = _t(pos).requires_grad_()
    port(p, _t(nrm), _t(mask)).sum().backward()
    assert bool(torch.isfinite(p.grad).all())


def _narrow(**kw):
    return DeltaNetClassification(4, conv_channels=(8, 8),
                                  embedding_size=16, num_neighbors=6, **kw)


@pytest.mark.parametrize("route", ["bf16-compute", "bf16-operators",
                                   "int8-operators", "int8-build",
                                   "fused-build", "prebuilt-operators"])
def test_routes_without_a_vjp_raise(route):
    """Inputs that require grad on a route whose forward has no VJP raise,
    and never return a zero or partial gradient. bf16 trains with them
    (tests/test_torch_bf16_grad.py); bf16 eval raises, with bf16 compute
    on f32 operators (``bf16-compute``) and on bf16 operators, the
    production serving mix (``bf16-operators``): its neighbour maxes with
    the epilogue have no VJP."""
    rng = np.random.default_rng(6)
    pos, nrm, _ = _clouds(rng, [MODEL_N] * 2)
    p, q = _t(pos).requires_grad_(), _t(nrm)
    model = _narrow().eval()
    with pytest.raises(NotImplementedError) as err:
        if route == "bf16-compute":
            model.set_precision("bfloat16", None)
            model(p, q)
        elif route == "bf16-operators":
            model.set_precision("bfloat16", "bfloat16")
            model(p, q)
        elif route == "int8-operators":
            model.set_precision("bfloat16", "int8")
            model(p, q)
        elif route == "int8-build":
            build_operators(p, 6, q, operator_dtype="int8")
        elif route == "fused-build":
            build_dense_operators_fused(p, 6, q)
        else:
            with torch.no_grad():
                gd = build_operators(p, 6, q)
            model(p, q, operators=gd)
    assert p.grad is None
    assert {"bf16-compute": "bf16 eval", "bf16-operators": "bf16 eval",
            "int8-operators": "f32", "int8-build": "int8",
            "fused-build": "forward only",
            "prebuilt-operators": "prebuilt"}[route] in str(err.value)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coef"])
def test_build_keeps_no_graph_without_differentiated_inputs(dense):
    """With no input requiring grad (or grad mode off) the build keeps no
    autograd graph: the operators have no ``grad_fn`` and the parameter
    train step differentiates the parameters only; with ``pos`` requiring
    grad, they have one: the coefficients, and on the dense form not ``W``
    (its applies differentiate the coefficients by the sampled product,
    ``ops.coef_cotangent``)."""
    rng = np.random.default_rng(7)
    pos, nrm, _ = _clouds(rng, [MODEL_N] * 2)
    seen = []
    model = _narrow(dense_operators=dense, dropout=0.0).train()
    orig = model.deltanet_base.convs[0].forward

    def spy(x, v, gd, point_mask=None):
        seen.append(gd)
        return orig(x, v, gd, point_mask)

    model.deltanet_base.convs[0].forward = spy
    p = _t(pos)
    model(p, _t(nrm)).sum().backward()
    with torch.no_grad():
        model(p.clone().requires_grad_(), _t(nrm))
    model(p.clone().requires_grad_(), _t(nrm))
    ops_of = (lambda gd: (gd.w_grad, gd.w_div)) if dense else (
        lambda gd: (gd.grad_coef, gd.div_coef))
    assert len(seen) == 3
    assert all(t.grad_fn is None for gd in seen[:2] for t in ops_of(gd))
    coefs = (seen[2].grad_coef, seen[2].div_coef)
    assert all(t.grad_fn is not None for t in coefs)
    if dense:
        assert all(t.grad_fn is None and not t.requires_grad
                   for t in ops_of(seen[2]))
