"""Classification losses (counterpart of
``deltaconv_tpu/training/losses.py``): cross-entropy with optional label
smoothing (eps-blended one-hot)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "smooth_cross_entropy", "smooth_nll"]


def smooth_nll(logits, labels, smoothing: float):
    """Per-element label-smoothed negative log-likelihood ``[...]``: the
    target keeps ``1 - eps`` on the true class and shares ``eps`` among
    the other ``C - 1`` classes."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), c).to(logits.dtype)
    off = smoothing / max(c - 1, 1)
    target = onehot * (1.0 - smoothing) + (1.0 - onehot) * off
    return -(target * logp).sum(dim=-1)


def smooth_cross_entropy(logits, labels, smoothing: float = 0.2,
                         label_mask=None):
    """Label-smoothed cross entropy, reduced to the (optionally masked)
    mean. ``logits [..., C]``, ``labels [...]`` int, ``label_mask``
    optional ``[...]`` bool (masked entries left out)."""
    nll = smooth_nll(logits, labels, smoothing)
    if label_mask is None:
        return nll.mean()
    m = label_mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def cross_entropy(logits, labels, label_mask=None):
    """Mean cross-entropy from logits and integer labels."""
    return smooth_cross_entropy(logits, labels, 0.0, label_mask)
