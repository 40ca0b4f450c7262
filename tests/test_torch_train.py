"""The deltaconv_tpu_torch train step against the JAX package on the CPU.

Train-mode BatchNorm, the losses and the lr schedule are held against
their JAX functions. One DeltaConv layer of each kind (the centralized
first conv with its edge statistics, and a plain conv) runs in train mode
in both packages on the same dense operators, with BatchNorm scales of
both signs (the sign fold of the max branches), and the outputs, every
parameter gradient and the updated running statistics must agree.

Then a narrow DeltaNetClassification (channels (8, 8, 16, 16), embedding
32, 4 classes, k=8, dropout 0) takes 3 SGD steps in both packages from
the same JAX-initialised weights (running statistics randomized), on a
uniform and on a ragged (masked) batch of 8 clouds. After each step the
loss must agree to rtol 1e-5, every parameter to 1e-3 x the tensor's max
magnitude and every running statistic to 1e-4 x max.

Why this setup and not perturbed scales at lr 0.1 on 4 clouds: there the
JAX package's own f32 step is already far from exact arithmetic. From
perturbed weights its first-step gradients differed from the same step
evaluated in f64 (jax x64) by up to 1e-1 x max in the first three convs,
while the port's f32 gradients stayed within 3e-5 x max of the f64 ones;
a neighbour-max winner flipped at a near-tie, and 4-row BatchNorm in the
head amplified it step by step. Agreement then says nothing about the
port, so the whole-slice comparison is made where both f32 runs are
close to exact (measured: loss within 2e-6, parameters within 4e-5 x
max, statistics within 2e-6 x max), and the sign fold is tested layer by
layer above, where no such amplification exists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.geometry.dense import DenseGradDiv as JaxDenseGradDiv
from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.nn.deltaconv import DeltaConv as JaxDeltaConv
from deltaconv_tpu.nn.nonlin import BatchNorm as JaxBatchNorm
from deltaconv_tpu.training import TrainState as JaxTrainState
from deltaconv_tpu.training import cosine_epoch_schedule as jax_cosine
from deltaconv_tpu.training import make_train_step as jax_train_step
from deltaconv_tpu.training import sgd_momentum as jax_sgd
from deltaconv_tpu.training import smooth_cross_entropy as jax_sce
from deltaconv_tpu_torch import DeltaNetClassification, state_dict_from_flax
from deltaconv_tpu_torch.models.deltanet_base import build_operators
from deltaconv_tpu_torch.nn import BatchNorm, DeltaConv, Dropout
from deltaconv_tpu_torch.training import (cosine_epoch_schedule,
                                          create_train_state,
                                          make_eval_step, make_train_step,
                                          sgd_momentum, smooth_cross_entropy)

torch.set_num_threads(1)

B, N, K = 8, 64, 8
WIDTH = dict(conv_channels=(8, 8, 16, 16), embedding_size=32,
             num_neighbors=K)
LR = 0.01


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_matches_flax(masked):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 20, 6)) * 2.0 + 0.5).astype(np.float32)
    mask = rng.random((3, 20)) > 0.3 if masked else None
    scale = rng.uniform(-1.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0.0, 0.2, 6).astype(np.float32)
    mean0 = rng.normal(0.0, 0.2, 6).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0,
                                                 "var": var0}}}
    want, mutated = JaxBatchNorm().apply(
        variables, jnp.asarray(x), train=True,
        mask=None if mask is None else jnp.asarray(mask),
        mutable=["batch_stats"])
    stats = mutated["batch_stats"]["BatchNorm_0"]

    bn = BatchNorm(6)
    bn.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                        "running_mean": _t(mean0), "running_var": _t(var0)})
    got = bn(_t(x), None if mask is None else _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6)

    bn.eval()  # eval normalizes with the (updated) running statistics
    want_eval = JaxBatchNorm().apply(
        {"params": variables["params"], "batch_stats": mutated[
            "batch_stats"]}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn(_t(x)).detach().numpy(),
                               np.asarray(want_eval), atol=1e-5)


@pytest.mark.parametrize("smoothing,masked", [(0.2, False), (0.2, True),
                                              (0.0, False)])
def test_smooth_cross_entropy_matches_jax(smoothing, masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((5, 7, 40)) * 3.0).astype(np.float32)
    labels = rng.integers(0, 40, (5, 7))
    mask = rng.random((5, 7)) > 0.4 if masked else None
    want = jax_sce(jnp.asarray(logits), jnp.asarray(labels), smoothing,
                   None if mask is None else jnp.asarray(mask))
    got = smooth_cross_entropy(_t(logits), _t(labels), smoothing,
                               None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cosine_epoch_schedule_matches_jax():
    """The JAX schedule evaluates its cosine in f32, the port's in f64:
    rtol 1e-6 plus atol 1e-8 (f32 rounding of ``1 + cos`` near its zero,
    times the base lr 0.1)."""
    want = jax_cosine(0.1, 250, 307, eta_min=0.001)
    got = cosine_epoch_schedule(0.1, 250, 307, eta_min=0.001)
    for step in (0, 1, 306, 307, 1000, 307 * 125, 307 * 250 - 1,
                 307 * 250, 307 * 400):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-8)


def test_dropout_draws_from_the_given_generator():
    x = torch.ones((64, 32))
    drop = Dropout(0.5)
    out = drop(x, torch.Generator().manual_seed(3))
    again = drop(x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert set(out.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < float((out > 0).float().mean()) < 0.6
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    drop.eval()
    assert drop(x) is x


def _clouds(rng, sizes):
    """Padded ellipsoid clouds with analytic normals and a point mask."""
    pos = np.zeros((len(sizes), N, 3), np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (len(sizes), N, 1))
    for i, n in enumerate(sizes):
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        q = d / axes
        pos[i, :n] = d * axes
        nrm[i, :n] = q / np.linalg.norm(q, axis=1, keepdims=True)
    mask = np.arange(N)[None, :] < np.asarray(sizes)[:, None]
    return pos, nrm, mask


def _perturb(tree, rng, stats_only=False, in_bn=False):
    """Running statistics away from their init and, unless
    ``stats_only``, BatchNorm scales of both signs (the sign fold in
    training) and biases."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _perturb(x, rng, stats_only, in_bn or k == "BatchNorm_0")
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif stats_only:
            out[k] = np.asarray(x)
        elif k == "scale":
            out[k] = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        elif k == "bias" and in_bn:
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.mark.parametrize("centralized,masked", [(True, False), (True, True),
                                                (False, False),
                                                (False, True)])
def test_deltaconv_train_matches_jax(centralized, masked):
    """One train-mode DeltaConv on the same dense operators (the port's,
    handed to the JAX layer): outputs within 1e-5 x max, gradients of
    every parameter within 1e-4 x max, running statistics within 1e-5 x
    max. BatchNorm scales of both signs run the sign fold of the
    centralized edge statistics and of both max branches."""
    rng = np.random.default_rng(5)
    c_in, c_out = 3 if centralized else 8, 8
    pos, nrm, mask = _clouds(rng, [N, 50, N, 40] if masked else [N] * 4)
    point_mask = _t(mask) if masked else None
    gd = build_operators(_t(pos), K, _t(nrm), point_mask)
    jgd = JaxDenseGradDiv(*(jnp.asarray(t.numpy()) for t in (
        gd.nbr_idx, gd.nbr_mask, gd.w_grad, gd.w_div)))
    x = rng.standard_normal((4, N, c_in)).astype(np.float32)
    v = rng.standard_normal((4, N, 2, c_in)).astype(np.float32)
    ct_x = rng.standard_normal((4, N, c_out)).astype(np.float32)
    ct_v = rng.standard_normal((4, N, 2, c_out)).astype(np.float32)
    jmask = jnp.asarray(mask) if masked else None

    layer = JaxDeltaConv(c_out, centralized=centralized)
    variables = layer.init(jax.random.PRNGKey(0), x, v, jgd)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)

    def loss(p):
        (xo, vo), mutated = layer.apply(
            {"params": p, "batch_stats": stats}, x, v, jgd, train=True,
            point_mask=jmask, mutable=["batch_stats"])
        return jnp.sum(xo * ct_x) + jnp.sum(vo * ct_v), (xo, vo, mutated)

    (_, (jx, jv, mutated)), jgrad = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)

    port = DeltaConv(c_in, c_out, centralized=centralized)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train()
    tx, tv = port(_t(x), _t(v), gd, point_mask)
    ((tx * _t(ct_x)).sum() + (tv * _t(ct_v)).sum()).backward()

    for got, want in ((tx, jx), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    want_grad = state_dict_from_flax(_to_numpy(jgrad), zero)
    for key, p in port.named_parameters():
        w = want_grad[key].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
    want_stats = state_dict_from_flax(params, _to_numpy(
        mutated["batch_stats"]))
    for key, b in port.named_buffers():
        w = want_stats[key].numpy()
        np.testing.assert_allclose(b.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("masked", [False, True])
def test_three_train_steps_match_jax(masked):
    rng = np.random.default_rng(3)
    sizes = [N, 50, N, 40] * 2 if masked else [N] * B
    pos, nrm, mask = _clouds(rng, sizes)
    labels = rng.integers(0, 4, B)
    model = JaxModel(num_classes=4, dropout=0.0, **WIDTH)
    variables = jax.jit(lambda key, p, n_: model.init(key, p, normal=n_))(
        jax.random.PRNGKey(0), pos, nrm)
    params = _perturb(_to_numpy(variables["params"]), rng, stats_only=True)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng,
                     stats_only=True)

    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_sgd(LR))
    jbatch = {"pos": jnp.asarray(pos), "normal": jnp.asarray(nrm),
              "label": jnp.asarray(labels)}
    tbatch = {"pos": _t(pos), "normal": _t(nrm), "label": _t(labels)}
    if masked:
        jbatch["point_mask"] = jnp.asarray(mask)
        tbatch["point_mask"] = _t(mask)
    jstep = jax_train_step(model, smoothing=0.2)

    port = DeltaNetClassification(4, dropout=0.0, **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    tstate = create_train_state(port, sgd_momentum(LR), device="cpu")
    tstep = make_train_step(port, smoothing=0.2)
    gen = torch.Generator().manual_seed(0)

    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        tm = tstep(tstate, tbatch, gen)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        want = state_dict_from_flax(_to_numpy(state.params),
                                    _to_numpy(state.batch_stats))
        got = port.state_dict()
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            w = w.numpy()
            rel = 1e-4 if ".running_" in key else 1e-3
            np.testing.assert_allclose(
                got[key].numpy(), w, rtol=0,
                atol=rel * float(np.abs(w).max()),
                err_msg=f"{key}, step {i}")
    assert tstate.step == 3
    assert tstate.optimizer.param_groups[0]["lr"] == LR

    # Eval after training: running statistics, no dropout.
    want = model.apply({"params": state.params,
                        "batch_stats": state.batch_stats},
                       jbatch["pos"], normal=jbatch["normal"],
                       point_mask=jbatch.get("point_mask"), train=False)
    got = make_eval_step(port)(tstate, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 * float(np.abs(want).max()))


def test_point_mask_invariance_in_training():
    """Padding a cloud with masked points changes neither the loss nor
    the update: the masked BatchNorm statistics leave them out."""
    rng = np.random.default_rng(3)
    pos, nrm, _ = _clouds(rng, [N] * B)
    labels = _t(rng.integers(0, 4, B))
    pad = 16
    pos_p = np.concatenate([pos, np.zeros((B, pad, 3), np.float32)], 1)
    nrm_p = np.concatenate([nrm, np.tile(np.asarray(
        [0.0, 0.0, 1.0], np.float32), (B, pad, 1))], 1)
    mask_p = np.arange(N + pad)[None, :].repeat(B, 0) < N

    def one_step(batch):
        model = DeltaNetClassification(
            4, dropout=0.0, generator=torch.Generator().manual_seed(0),
            **WIDTH)
        state = create_train_state(model, sgd_momentum(LR), device="cpu")
        m = make_train_step(model)(state, batch, None)
        return float(m["loss"]), model.state_dict()

    loss_a, sd_a = one_step({"pos": _t(pos), "normal": _t(nrm),
                             "label": labels})
    loss_b, sd_b = one_step({"pos": _t(pos_p), "normal": _t(nrm_p),
                             "point_mask": _t(mask_p), "label": labels})
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-5)
    for key, w in sd_a.items():
        torch.testing.assert_close(sd_b[key], w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-7)
