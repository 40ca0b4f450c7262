"""The whole deltaconv_tpu_torch serving slice against the JAX package.

A narrow DeltaNetClassification (channels (8, 8, 16, 16), embedding 32,
4 classes, k=8) is initialised in JAX, its BatchNorm statistics, scales
(both signs, which exercises the sign fold of the max branches) and
biases perturbed with numpy, converted with ``state_dict_from_flax`` and
loaded strictly into the port. Eval logits must agree within
``atol = 1e-4 * max|logit|`` uniform and ragged (masked), directly and
through both ``InferenceEngine``s.
"""

import jax
import numpy as np
import pytest
import torch

from deltaconv_tpu.models import DeltaNetClassification as JaxModel
from deltaconv_tpu.serving import InferenceEngine as JaxEngine
from deltaconv_tpu.utils.torch_export import export_torch_state_dict
from deltaconv_tpu_torch import (DeltaNetClassification, InferenceEngine,
                                 state_dict_from_flax)

torch.set_num_threads(1)

B, N, K = 2, 128, 8
WIDTH = dict(conv_channels=(8, 8, 16, 16), embedding_size=32,
             num_neighbors=K)


def _clouds(rng, sizes):
    """Points on random ellipsoids with their analytic normals."""
    clouds, normals = [], []
    for n in sizes:
        axes = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        nrm = d / axes
        clouds.append(d * axes)
        normals.append(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    return clouds, normals


def _perturb(tree, rng, in_bn=False):
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
def pair():
    """(JAX model, its numpy variables, the port loaded from them)."""
    rng = np.random.default_rng(0)
    model = JaxModel(num_classes=4, **WIDTH)
    clouds, normals = _clouds(rng, [N] * B)
    variables = jax.jit(lambda key, p, n_: model.init(key, p, normal=n_))(
        jax.random.PRNGKey(0), np.stack(clouds), np.stack(normals))
    params = _perturb(jax.tree_util.tree_map(np.asarray,
                                             dict(variables["params"])), rng)
    stats = _perturb(jax.tree_util.tree_map(
        np.asarray, dict(variables["batch_stats"])), rng)
    port = DeltaNetClassification(4, **WIDTH)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model, {"params": params, "batch_stats": stats}, port


def _close(got, want):
    np.testing.assert_allclose(got, want,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("masked", [False, True])
def test_logits_match_jax_apply(pair, masked):
    model, variables, port = pair
    rng = np.random.default_rng(1)
    sizes = [N, 90] if masked else [N] * B
    clouds, normals = _clouds(rng, sizes)
    pad = [N - len(c) for c in clouds]
    pos = np.stack([np.pad(c, ((0, p), (0, 0))) for c, p in zip(clouds, pad)])
    nrm = np.stack([np.concatenate([n_, np.tile([[0.0, 0.0, 1.0]], (p, 1))])
                    for n_, p in zip(normals, pad)]).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(sizes)[:, None]
    pm = mask if masked else None
    want = np.asarray(jax.jit(
        lambda v, p, n_, m: model.apply(v, p, normal=n_, point_mask=m,
                                        train=False))(variables, pos, nrm, pm))
    with torch.inference_mode():
        got = port(torch.from_numpy(pos), torch.from_numpy(nrm),
                   None if pm is None else torch.from_numpy(pm)).numpy()
    assert got.shape == (B, 4)
    _close(got, want)


def test_inference_engine_matches_jax_engine(pair):
    """Uniform then ragged requests, a partial last batch included."""
    model, variables, port = pair
    rng = np.random.default_rng(2)
    jax_engine = JaxEngine(model, variables, num_points=N, batch_size=B)
    engine = InferenceEngine(port, num_points=N, batch_size=B)
    for sizes in ([N] * 3, [N, 100, 77]):
        clouds, normals = _clouds(rng, sizes)
        want = jax_engine.predict(clouds, normals)
        got = engine.predict(clouds, normals)
        assert got.shape == (len(sizes), 4) and got.dtype == np.float32
        _close(got, want)
    assert engine.predict([]) == []


def test_state_dict_matches_torch_export(pair):
    _, variables, port = pair
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    ref = export_torch_state_dict(variables["params"],
                                  variables["batch_stats"])
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert sorted(sd) == sorted(port.state_dict())


def test_state_dict_loads_upstream_extras(pair):
    """Upstream checkpoints also carry BatchNorm step counters and the
    dead VectorNonLin bias; a strict load takes them."""
    _, variables, _ = pair
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    sd["deltanet_base.convs.0.v_mlp.0.1.bias"] = torch.zeros(8)
    port = DeltaNetClassification(4, **WIDTH)
    port.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
