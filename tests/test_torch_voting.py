"""Voting and the batched augmentations of deltaconv_tpu_torch against the
JAX package on the CPU.

Each augmentation is split into its draw (from a ``torch.Generator``) and
its application; the application is held against the JAX function on
JAX's own draws (the same ``jax.random.uniform`` calls on the same key),
within 1e-6. ``InferenceEngine.predict_voting`` with a deterministic
augment (one that ignores its generator or key) must equal ``num_votes``
x ``predict`` and the JAX engine's ``predict_voting`` within 1e-4 x
max|logit| (tests/test_torch_model.py's bound), with and without normals,
uniform and ragged; the default augment gives finite logits that differ
from a single pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.serving import InferenceEngine as JaxEngine
from deltaconv_tpu.transforms import augment as jaug
from deltaconv_tpu_torch import (DeltaNetClassification, InferenceEngine,
                                 state_dict_from_flax)
from deltaconv_tpu_torch.transforms import augment as aug

torch.set_num_threads(1)

B, N = 2, 96
WIDTH = dict(conv_channels=(8, 8, 16), embedding_size=16, num_neighbors=8)
APPLY_ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(rng, b=3, n=N):
    pos = rng.standard_normal((b, n, 3)).astype(np.float32)
    nrm = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pos, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


def _close(got, want, atol=APPLY_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("with_normal", [False, True])
def test_scale_applies_jax_draws(with_normal):
    pos, nrm = _batch(np.random.default_rng(0))
    key, scales = jax.random.PRNGKey(1), (0.7, 1.4)
    s = jax.random.uniform(key, (3, 1, 3), minval=scales[0],
                           maxval=scales[1])
    n_in = nrm if with_normal else None
    want = jaug.random_scale(key, jnp.asarray(pos),
                             None if n_in is None else jnp.asarray(n_in),
                             scales)
    got = aug.apply_scale(_t(pos), None if n_in is None else _t(n_in),
                          _t(s))
    _close(got[0], want[0])
    if with_normal:
        _close(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rotate_applies_jax_draws(axis):
    pos, nrm = _batch(np.random.default_rng(1))
    key = jax.random.PRNGKey(axis)
    ang = jax.random.uniform(key, (3,), minval=-360.0, maxval=360.0) * (
        jnp.pi / 180.0)
    want = jaug.random_rotate(key, jnp.asarray(pos), jnp.asarray(nrm), 360.0,
                              axis)
    got = aug.apply_rotation(_t(pos), _t(nrm), _t(ang), axis)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_translate_and_normal_jitter_apply_jax_draws():
    pos, nrm = _batch(np.random.default_rng(2))
    key = jax.random.PRNGKey(3)
    t = jax.random.uniform(key, (3, 1, 3), minval=-0.1, maxval=0.1)
    _close(aug.apply_translation(_t(pos), _t(t)),
           jaug.random_translate_global(key, jnp.asarray(pos), 0.1))
    jit = jax.random.uniform(key, nrm.shape, minval=-0.2, maxval=0.2)
    _close(aug.apply_normal_jitter(_t(nrm), _t(jit)),
           jaug.random_normals(key, jnp.asarray(nrm), 0.2))


def test_augment_classification_applies_jax_draws():
    pos, nrm = _batch(np.random.default_rng(3))
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    s = jax.random.uniform(k1, (3, 1, 3), minval=0.8, maxval=1.25)
    t = jax.random.uniform(k2, (3, 1, 3), minval=-0.1, maxval=0.1)
    want = jaug.augment_classification(key, jnp.asarray(pos),
                                       jnp.asarray(nrm))
    p, n = aug.apply_scale(_t(pos), _t(nrm), _t(s))
    _close(aug.apply_translation(p, _t(t)), want[0])
    _close(n, want[1])


def test_draws_are_in_range_and_follow_the_generator():
    """Each draw lies in its interval, per cloud; the same seed gives the
    same draws, and ``random_*`` is its draw then its application."""
    pos, nrm = _batch(np.random.default_rng(4), b=64)
    p, n = _t(pos), _t(nrm)

    def gen(seed=0):
        return torch.Generator().manual_seed(seed)

    s = aug.draw_scale(gen(), p, (0.8, 1.25))
    assert s.shape == (64, 1, 3) and 0.8 <= s.min() and s.max() <= 1.25
    a = aug.draw_rotation(gen(), p, 30.0)
    assert a.shape == (64,) and a.abs().max() <= np.pi / 6 + 1e-6
    t = aug.draw_translation(gen(), p, 0.1)
    assert t.shape == (64, 1, 3) and t.abs().max() <= 0.1
    j = aug.draw_normal_jitter(gen(), n, 0.05)
    assert j.shape == n.shape and j.abs().max() <= 0.05
    assert torch.equal(s, aug.draw_scale(gen(), p, (0.8, 1.25)))
    assert not torch.equal(s, aug.draw_scale(gen(1), p, (0.8, 1.25)))
    for got, want in (
            (aug.random_scale(gen(), p, n, (0.8, 1.25)),
             aug.apply_scale(p, n, s)),
            (aug.random_rotate(gen(), p, n, 30.0, 1),
             aug.apply_rotation(p, n, a, 1)),
            ((aug.random_translate_global(gen(), p, 0.1), None),
             (aug.apply_translation(p, t), None)),
            ((aug.random_normals(gen(), n, 0.05), None),
             (aug.apply_normal_jitter(n, j), None))):
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    g = gen()
    p2, n2 = aug.augment_classification(g, p, n)
    g2 = gen()
    s2 = aug.draw_scale(g2, p, (0.8, 1.25))
    t2 = aug.draw_translation(g2, p, 0.1)
    want_p, want_n = aug.apply_scale(p, n, s2)
    assert torch.equal(p2, aug.apply_translation(want_p, t2))
    assert torch.equal(n2, want_n)


# -- predict_voting ---------------------------------------------------------------


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _perturb(tree, rng, in_bn=False):
    """Running statistics away from their init, BatchNorm scales of both
    signs and biases (tests/test_torch_model.py)."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _perturb(x, rng, in_bn or k == "BatchNorm_0")
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        elif k == "bias" and in_bn:
            out[k] = rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x)
    return out


@pytest.fixture(scope="module")
def engines():
    """(the JAX engine, the port's), the port loaded from the JAX
    initialisation with perturbed weights and running statistics."""
    rng = np.random.default_rng(5)
    model = JaxModel(num_classes=4, **WIDTH)
    pos, _ = _batch(rng, b=B)
    variables = jax.jit(lambda key, p: model.init(key, p))(
        jax.random.PRNGKey(0), pos)
    params = _perturb(_to_numpy(variables["params"]), rng)
    stats = _perturb(_to_numpy(variables["batch_stats"]), rng)
    port = DeltaNetClassification(4, **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    jax_engine = JaxEngine(model, {"params": params, "batch_stats": stats},
                           num_points=N, batch_size=B)
    return jax_engine, InferenceEngine(port, num_points=N, batch_size=B,
                                       device="cpu")


def _clouds(seed, sizes, with_normals):
    rng = np.random.default_rng(seed)
    clouds, normals = [], []
    for n in sizes:
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        q = d / axes
        clouds.append(d * axes)
        normals.append(q / np.linalg.norm(q, axis=1, keepdims=True))
    return clouds, normals if with_normals else None


def _within(got, want, rel=1e-4):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale


_SCALE = np.asarray([1.1, 0.9, 1.05], np.float32)
_SHIFT = np.asarray([0.05, -0.02, 0.0], np.float32)


def _stretch_jax(key, pos, normal):
    """A deterministic augment (it ignores its key): a fixed per-axis
    stretch and shift, the normals by the inverse stretch."""
    p = pos * _SCALE + _SHIFT
    if normal is None:
        return p, None
    n = normal / _SCALE
    return p, n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def _stretch_torch(generator, pos, normal):
    """:func:`_stretch_jax` on tensors (it ignores its generator)."""
    s, shift = torch.from_numpy(_SCALE), torch.from_numpy(_SHIFT)
    p = pos * s + shift
    if normal is None:
        return p, None
    n = normal / s
    return p, n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


@pytest.mark.parametrize("sizes", [[N] * 3, [N, 70, 55]],
                         ids=["uniform", "ragged"])
@pytest.mark.parametrize("with_normals", [False, True])
def test_deterministic_voting_matches_jax_engine(engines, sizes,
                                                 with_normals):
    jax_engine, engine = engines
    clouds, normals = _clouds(6, sizes, with_normals)
    want = jax_engine.predict_voting(clouds, normals, num_votes=3,
                                     augment=_stretch_jax)
    got = engine.predict_voting(clouds, normals, num_votes=3,
                                augment=_stretch_torch)
    assert got.shape == (len(sizes), 4) and got.dtype == np.float32
    _within(got, want)


@pytest.mark.parametrize("with_normals", [False, True])
def test_identity_voting_is_num_votes_times_predict(engines, with_normals):
    _, engine = engines
    clouds, normals = _clouds(7, [N, 80, N], with_normals)
    calls = []

    def identity(gen, pos, normal):
        calls.append(gen)
        return pos, normal

    got = engine.predict_voting(clouds, normals, num_votes=4,
                                augment=identity)
    _within(got, 4 * engine.predict(clouds, normals))
    # One draw a (vote, batch), all from one generator.
    assert len(calls) == 4 * 2 and all(g is calls[0] for g in calls)


def test_default_augment_votes(engines):
    _, engine = engines
    clouds, _ = _clouds(8, [N, 60, N], False)
    single = engine.predict(clouds)
    votes = engine.predict_voting(clouds, num_votes=3, seed=1)
    assert votes.shape == single.shape and np.isfinite(votes).all()
    assert np.abs(votes - 3 * single).max() > 1e-4 * np.abs(single).max()
    np.testing.assert_array_equal(
        votes, engine.predict_voting(clouds, num_votes=3, seed=1))
    assert not np.array_equal(
        votes, engine.predict_voting(clouds, num_votes=3, seed=2))
    assert engine.predict_voting([], num_votes=2) == []
    with pytest.raises(ValueError, match="num_votes"):
        engine.predict_voting(clouds, num_votes=0)
