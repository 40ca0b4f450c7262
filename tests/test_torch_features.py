"""The backbone's ``features`` input, ``in_channels`` and
``centralize_first`` in deltaconv_tpu_torch against the JAX package on
the CPU.

The JAX backbone reads ``features`` (``[B, N, C]``) in place of the
positions when given and sizes its first conv by them; the port's takes
``in_channels`` (the upstream reference's name, 3 by default) to size it
and the same ``features``. ``centralize_first=False`` runs the first
conv's max branch on the features themselves (``PointMaxMLP`` at depth
1, the non-centralized ``DeepMaxMLP`` at depth 2). Inputs are numpy
arrays from a seed; weights move across with ``state_dict_from_flax``.

Tolerances, and why: the same f32 arithmetic in another order (XLA's
fused reductions against torch's): outputs within 1e-5 x max, parameter
gradients within 1e-4 x max, running statistics within 1e-5 x max; the
train steps as ``tests/test_torch_train.py`` holds them (loss rtol 1e-5,
parameters 1e-3 x max, running statistics 1e-4 x max, after each of two
SGD steps; eval logits 1e-4 x max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.models import DeltaNetBase as JaxBase
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.training import TrainState as JaxTrainState
from deltaconv_tpu.training import make_eval_step as jax_eval_step
from deltaconv_tpu.training import make_train_step as jax_train_step
from deltaconv_tpu.training import sgd_momentum as jax_sgd
from deltaconv_tpu_torch import DeltaNetClassification, state_dict_from_flax
from deltaconv_tpu_torch.models import DeltaNetBase
from deltaconv_tpu_torch.training import (create_train_state,
                                          make_eval_step, make_train_step,
                                          sgd_momentum)
from test_torch_train import _clouds, _perturb, _t, _to_numpy

torch.set_num_threads(1)

B, N, K = 8, 64, 8
WIDTH = dict(conv_channels=(8, 8, 16), embedding_size=32, num_neighbors=K)
LR = 0.01


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        want, rtol=0, atol=rel * float(np.abs(want).max()), err_msg=what)


def _features(pos, nrm):
    """Positions and normals side by side: 6 input channels."""
    return np.concatenate([pos, nrm], axis=-1)


def test_conv0_is_sized_by_in_channels_and_carries_jax_weights():
    """``in_channels=6`` sizes the first conv's three MLPs as the JAX
    model initialised on 6 feature channels sizes them, and the JAX
    weights load strictly, unchanged (the kernels transposed)."""
    rng = np.random.default_rng(0)
    pos, nrm, _ = _clouds(rng, [N] * 2)
    model = JaxModel(num_classes=4, **WIDTH)
    variables = jax.jit(lambda key, p, q, f: model.init(
        key, p, normal=q, features=f))(jax.random.PRNGKey(0), pos, nrm,
                                       _features(pos, nrm))
    sd = state_dict_from_flax(_to_numpy(variables["params"]),
                              _to_numpy(variables["batch_stats"]))
    port = DeltaNetClassification(4, in_channels=6, **WIDTH)
    port.load_state_dict(sd, strict=True)
    conv0 = port.deltanet_base.convs[0]
    assert conv0.s_mlp_max[0][0].weight.shape == (8, 6)
    assert conv0.s_mlp[0][0].weight.shape == (8, 24)
    assert conv0.v_mlp[0][0].weight.shape == (8, 2 * (2 * 6 + 8))
    kernel = variables["params"]["deltanet_base"]["conv0"]["s_mlp_max"][
        "lin0"]["kernel"]
    np.testing.assert_array_equal(conv0.s_mlp_max[0][0].weight.detach(),
                                  np.asarray(kernel).T)


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "ragged"])
def test_train_and_eval_steps_take_features(masked):
    """Two SGD steps and the eval step of a narrow f32 classifier on a
    batch that carries ``features`` (positions and normals, 6 channels):
    the port's ``make_train_step``/``make_eval_step`` against JAX's on
    the same weights and batch."""
    rng = np.random.default_rng(1)
    sizes = [N, 50, N, 40] * 2 if masked else [N] * B
    pos, nrm, mask = _clouds(rng, sizes)
    feats = _features(pos, nrm)
    labels = rng.integers(0, 4, B)
    model = JaxModel(num_classes=4, dropout=0.0, **WIDTH)
    variables = jax.jit(lambda key, p, q, f: model.init(
        key, p, normal=q, features=f))(jax.random.PRNGKey(0), pos, nrm, feats)
    params = _perturb(_to_numpy(variables["params"]), rng, stats_only=True)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng,
                     stats_only=True)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_sgd(LR))
    jbatch = {"pos": jnp.asarray(pos), "normal": jnp.asarray(nrm),
              "features": jnp.asarray(feats), "label": jnp.asarray(labels)}
    tbatch = {"pos": _t(pos), "normal": _t(nrm), "features": _t(feats),
              "label": _t(labels)}
    if masked:
        jbatch["point_mask"] = jnp.asarray(mask)
        tbatch["point_mask"] = _t(mask)
    port = DeltaNetClassification(4, dropout=0.0, in_channels=6, **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    tstate = create_train_state(port, sgd_momentum(LR), device="cpu")
    jstep, tstep = jax_train_step(model, smoothing=0.2), make_train_step(
        port, smoothing=0.2)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        tm = tstep(tstate, tbatch, gen)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        want = state_dict_from_flax(_to_numpy(state.params),
                                    _to_numpy(state.batch_stats))
        got = port.state_dict()
        for key, w in want.items():
            _close(got[key], w.numpy(), 1e-4 if ".running_" in key else 1e-3,
                   f"{key}, step {i}")
    want = jax_eval_step(model)(state, jbatch)
    got = make_eval_step(port)(tstate, tbatch)
    _close(got, want, 1e-4, "eval logits")
    # The features are the input: other features, other logits.
    tbatch["features"] = tbatch["features"].flip(-1)
    assert not torch.allclose(make_eval_step(port)(tstate, tbatch), got)


@pytest.mark.parametrize("features", [False, True], ids=["pos", "features"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "ragged"])
def test_backbone_without_centralized_first_conv_matches_jax(masked, depth,
                                                             features):
    """``DeltaNetBase(centralize_first=False)`` at MLP depth 1 and 2, on
    positions and on 6 feature channels: train-mode stage outputs,
    parameter gradients of a random projection of them and running
    statistics against the JAX backbone's on the same weights; then the
    eval outputs on the updated statistics. 8 clouds and unperturbed
    BatchNorm scales, as ``tests/test_torch_pos_grad.py`` takes them:
    with 4 clouds and scales of both signs, one-ulp differences grow to
    3e-4 x max in the depth-2 parameter gradients (measured)."""
    rng = np.random.default_rng(2 + depth)
    sizes = [N, 50, N, 40] * 2 if masked else [N] * B
    pos, nrm, mask = _clouds(rng, sizes)
    feats = _features(pos, nrm) if features else None
    cfg = dict(conv_channels=(8, 16), mlp_depth=depth, num_neighbors=K)
    model = JaxBase(centralize_first=False, **cfg)
    jmask = jnp.asarray(mask) if masked else None
    variables = jax.jit(lambda key: model.init(
        key, pos, normal=nrm, features=feats))(jax.random.PRNGKey(0))
    params = _perturb(_to_numpy(variables["params"]), rng, stats_only=True)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng,
                     stats_only=True)
    cts = [rng.standard_normal((B, N, c)).astype(np.float32)
           for c in cfg["conv_channels"]]

    def loss(p):
        outs, mutated = model.apply(
            {"params": p, "batch_stats": stats}, pos, normal=nrm,
            features=feats, point_mask=jmask, train=True,
            mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts)), (outs,
                                                                mutated)

    (_, (jouts, mutated)), jgrad = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    port = DeltaNetBase(in_channels=3 if feats is None else 6,
                        centralize_first=False, **cfg)
    assert not port.convs[0].centralized
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train()
    tmask = _t(mask) if masked else None
    tfeats = None if feats is None else _t(feats)
    outs = port(_t(pos), _t(nrm), tmask, features=tfeats)
    sum((o * _t(c)).sum() for o, c in zip(outs, cts)).backward()
    for got, want in zip(outs, jouts):
        _close(got, want, 1e-5, "train outputs")
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    want_grad = state_dict_from_flax(_to_numpy(jgrad), zero)
    for key, p in port.named_parameters():
        _close(p.grad, want_grad[key].numpy(), 1e-4, key)
    new_stats = _to_numpy(mutated["batch_stats"])
    want_stats = state_dict_from_flax(params, new_stats)
    for key, b in port.named_buffers():
        _close(b, want_stats[key].numpy(), 1e-5, key)
    port.eval()
    with torch.no_grad():
        outs = port(_t(pos), _t(nrm), tmask, features=tfeats)
    jouts = model.apply({"params": params, "batch_stats": new_stats}, pos,
                        normal=nrm, features=feats, point_mask=jmask)
    for got, want in zip(outs, jouts):
        _close(got, want, 1e-5, "eval outputs")
