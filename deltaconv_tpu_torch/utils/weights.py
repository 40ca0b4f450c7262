"""JAX parameter trees -> the port's ``state_dict``.

``state_dict_from_flax(params, batch_stats)`` takes the ``params`` and
``batch_stats`` trees of the JAX package's models as nested dicts of
numpy arrays and returns a ``state_dict`` in the upstream release's key
layout, which is the port's module tree: linear kernels are transposed
``[in, out] -> [out, in]`` and BatchNorm leaves renamed
(scale/bias/mean/var -> weight/bias/running_mean/running_var). It is the
mapping of ``deltaconv_tpu/utils/torch_export.py``, written again here
so that the port needs nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]

_BN_LEAF = {"scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}

_HEADS = {
    "classification": (("head0.", "classification_head.0."),
                       ("head1.", "classification_head.2."),
                       ("head_out.", "classification_head.4.")),
    "segmentation": (("head0.", "segmentation_head.0."),
                     ("head1.", "segmentation_head.2."),
                     ("head2.", "segmentation_head.4."),
                     ("head_out.", "segmentation_head.6.")),
}


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _key(path, head: str) -> str:
    """One parameter-tree path -> its ``state_dict`` key."""
    parts = list(path)
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p.startswith("conv") and p[4:].isdigit():
            out.append(f"convs.{p[4:]}")
        elif (p.startswith("lin") and p[3:].isdigit()
              and parts[i + 1] == "kernel"):
            out.append(f"{p[3:]}.0.weight")  # lin{j}/kernel
            i += 2
            continue
        elif p.startswith("bn") and p[2:].isdigit():
            # bn{j}/BatchNorm_0/{leaf}
            out.append(f"{p[2:]}.1.bn.{_BN_LEAF[parts[i + 2]]}")
            i += 3
            continue
        elif p.startswith("nonlin") and p[6:].isdigit():
            # nonlin{j}/bn/BatchNorm_0/{leaf} (VectorNonLin)
            out.append(f"{p[6:]}.1.batchnorm.bn.{_BN_LEAF[parts[i + 3]]}")
            i += 4
            continue
        elif p == "kernel":
            out.append("weight")
        else:
            out.append(p)
        i += 1
    name = ".".join(out)
    for old, new in _HEADS[head]:
        name = name.replace(old, new)
    return name


def state_dict_from_flax(params, batch_stats, head: str = "classification"
                         ) -> Dict[str, torch.Tensor]:
    """``params``/``batch_stats`` trees -> the port's ``state_dict``
    (``head``: "classification" | "segmentation" selects the positional
    names of the head)."""
    if head not in _HEADS:
        raise ValueError(f"unknown head {head!r}")
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, arr in _flatten(tree).items():
            name = _key(path, head)
            arr = np.asarray(arr)
            if (name.endswith("weight") and arr.ndim == 2
                    and ".bn." not in name):
                arr = arr.T  # [in, out] -> [out, in]
            sd[name] = torch.tensor(arr)  # a copy: the input may be read-only
    return sd
