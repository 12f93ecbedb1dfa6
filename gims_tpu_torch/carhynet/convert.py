"""CAR-HyNet weights: the JAX package's flax variables into the port's modules.

``load_car_checkpoint`` reads a flat ``::``-keyed ``.npz`` (as
``gims_tpu_dense_gray_e2e_car.npz``) into the flax variables tree
(``params`` and ``batch_stats``, numpy leaves). ``variables_to_state_dict``
maps that tree onto ``CARHyNet``'s ``state_dict``: the port's submodules
carry the flax module names, so a leaf's path is its key, with the leaf
renamed:

* ``Conv.kernel`` (kh, kw, in/groups, out), HWIO -> ``Conv2d.weight``
  (out, in/groups, kh, kw); a depthwise (3, 3, 1, C) kernel becomes
  (C, 1, 3, 3);
* ``BatchNorm`` ``scale`` -> ``weight``, and ``batch_stats`` ``mean``/``var``
  -> ``running_mean``/``running_var``;
* everything else (``bias``, FRN's ``weight``, TLU's ``tau``) as it is.

``module_variables`` is the inverse, for ``core.checkpoint.save_npz``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gims_tpu_torch.carhynet.model import BatchNorm
from gims_tpu_torch.core.checkpoint import unflatten_npz

_RENAME = {"kernel": "weight", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}
_COLLECTIONS = ("params", "batch_stats")


def load_car_checkpoint(path: str):
    """CAR-HyNet variables from a ``.npz`` of the JAX package."""
    return unflatten_npz(path)


def variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax CAR-HyNet variables tree (numpy leaves) -> the port's state_dict."""
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + [key])
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            name = ".".join(path + [_RENAME.get(key, key)])
            if name in sd:
                raise ValueError(f"two variables map to {name}")
            sd[name] = torch.from_numpy(np.array(arr, order="C"))

    for collection in _COLLECTIONS:
        walk(variables.get(collection, {}), [])
    return sd


def load_variables(model: torch.nn.Module, variables) -> None:
    """Copy a flax variables tree into `model`; raises on any missing or
    unexpected key (strict load)."""
    model.load_state_dict(variables_to_state_dict(variables), strict=True)


def module_variables(model: torch.nn.Module, params=None):
    """The JAX layout's variables tree (``params``, ``batch_stats``; f32 numpy
    leaves) of a CARHyNet. `params` optionally maps parameter names to
    tensors that take the parameters' place (an EMA copy)."""
    params = params or {}
    out = {"params": {}, "batch_stats": {}}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = np.array(value, order="C")

    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        pre = f"{name}." if name else ""
        for leaf, p in mod.named_parameters(recurse=False):
            arr = params.get(pre + leaf, p).detach().float().cpu().numpy()
            key = leaf
            if isinstance(mod, torch.nn.Conv2d) and leaf == "weight":
                key, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif isinstance(mod, BatchNorm) and leaf == "weight":
                key = "scale"
            put(out["params"], path + [key], arr)
        for leaf, buf in mod.named_buffers(recurse=False):
            key = {"running_mean": "mean", "running_var": "var"}[leaf]
            put(out["batch_stats"], path + [key], buf.detach().float().cpu().numpy())
    return out
