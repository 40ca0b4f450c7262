"""Pointwise vector-field operators in the ``[..., N, 2, C]`` layout
(counterpart of ``deltaconv_tpu/geometry/operators.py``): a C-channel
tangent vector field on N points keeps its two components on axis -2.
``curl``, ``laplacian`` and ``hodge_laplacian`` compose the ``grad`` and
``div`` of an operator object (``GradDiv`` or ``DenseGradDiv``, batched or
of one cloud)."""

from __future__ import annotations

import torch

from .utils import safe_norm

__all__ = ["I_J", "J", "curl", "hodge_laplacian", "laplacian", "norm"]


def norm(v):
    """Channelwise vector norms: ``[..., N, 2, C] -> [..., N, C]``."""
    return safe_norm(v, dim=-2)


def J(v):
    """90-degree counter-clockwise rotation of a tangent vector field."""
    return torch.stack([-v[..., 1, :], v[..., 0, :]], dim=-2)


def I_J(v):
    """Concatenate a vector field with its rotated copy along channels."""
    return torch.cat([v, J(v)], dim=-1)


def curl(v, gd):
    """``curl v = -div (J v)``."""
    return -gd.div(J(v))


def laplacian(x, gd):
    """``lap x = -div grad x``."""
    return -gd.div(gd.grad(x))


def hodge_laplacian(v, gd):
    """The Hodge Laplacian of a vector field, ``-(grad div v + J grad
    curl v)``."""
    grad_div_v = gd.grad(gd.div(v))
    j_grad_curl_v = J(gd.grad(curl(v, gd)))
    return -(grad_div_v + j_grad_curl_v)
