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
``convert_carhynet_torch`` maps the reference's torch state_dict
(carhynet/models.py:311-399, shipped as ``car_hynet.pth``) onto the same
flax tree, as the JAX package's converter does
(``gims_tpu/carhynet/convert.py:84-134``): OIHW kernels to HWIO (the same
permutation takes a depthwise (C, 1, kh, kw) to (kh, kw, 1, C)), and FRN's
and TLU's (1, C, 1, 1) tensors flattened to (C,).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gims_tpu_torch.carhynet.model import BatchNorm
from gims_tpu_torch.core.checkpoint import unflatten_npz
from gims_tpu_torch.matcher.convert import TorchTree, nest_flat

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


class _CarTree(TorchTree):
    def frn(self, tp, fp):
        self.params[fp] = {"weight": self.get(f"{tp}.weight").reshape(-1),
                           "bias": self.get(f"{tp}.bias").reshape(-1)}
        self.used.add(f"{tp}.eps")  # a fixed buffer (1e-6), not a parameter

    def tlu(self, tp, fp):
        self.params[fp] = {"tau": self.get(f"{tp}.tau").reshape(-1)}

    def conv(self, tp, fp, bias=True):
        p = {"kernel": self.get(f"{tp}.weight").transpose(2, 3, 1, 0)}  # OIHW -> HWIO
        if bias:
            p["bias"] = self.get(f"{tp}.bias")
        self.params[fp] = p

    def bn(self, tp, fp, affine=True):
        if affine:
            self.params[fp] = {"scale": self.get(f"{tp}.weight"),
                               "bias": self.get(f"{tp}.bias")}
        self.stats[fp] = {"mean": self.get(f"{tp}.running_mean"),
                          "var": self.get(f"{tp}.running_var")}
        self.used.add(f"{tp}.num_batches_tracked")

    def coord(self, tp, fp):
        self.conv(f"{tp}.conv1", f"{fp}/conv1")
        self.bn(f"{tp}.bn1", f"{fp}/bn1")
        self.conv(f"{tp}.conv_h", f"{fp}/conv_h")
        self.conv(f"{tp}.conv_w", f"{fp}/conv_w")

    def sandglass(self, tp, fp):
        # the reference's Sequential (carhynet/models.py:201-222, inp == oup,
        # stride 1, expand 6): 0 ConvBNReLU dw3x3, 1 CoordAtt, 2 conv1x1
        # reduce, 3 BN, 4 ConvBNReLU 1x1 expand, 5 conv dw3x3, 6 BN
        self.conv(f"{tp}.conv.0.0", f"{fp}/dw1/conv", bias=False)
        self.bn(f"{tp}.conv.0.1", f"{fp}/dw1/bn")
        self.coord(f"{tp}.conv.1", f"{fp}/coord")
        self.conv(f"{tp}.conv.2", f"{fp}/pw_reduce", bias=False)
        self.bn(f"{tp}.conv.3", f"{fp}/pw_reduce_bn")
        self.conv(f"{tp}.conv.4.0", f"{fp}/pw_expand/conv", bias=False)
        self.bn(f"{tp}.conv.4.1", f"{fp}/pw_expand/bn")
        self.conv(f"{tp}.conv.5", f"{fp}/dw2", bias=False)
        self.bn(f"{tp}.conv.6", f"{fp}/dw2_bn")


def convert_carhynet_torch(state_dict):
    """A reference CAR-HyNet state_dict -> the JAX layout's variables tree
    ({'params': ..., 'batch_stats': ...}); a key left over raises."""
    b = _CarTree(state_dict)
    b.frn("layer1.0", "l1_frn_in")
    b.tlu("layer1.1", "l1_tlu_in")
    b.conv("layer1.2", "l1_conv")
    b.frn("layer1.3", "l1_frn")
    b.coord("layer1.4", "l1_coord")
    b.tlu("layer1.5", "l1_tlu")
    b.conv("layer2.0", "l2_conv")
    b.frn("layer2.1", "l2_frn")
    b.coord("layer2.2", "l2_coord")
    b.tlu("layer2.3", "l2_tlu")
    b.sandglass("layer2_5", "l2_sg")
    for n in (3, 4, 5, 6):
        b.conv(f"layer{n}.0", f"l{n}_conv")
        b.frn(f"layer{n}.1", f"l{n}_frn")
        b.tlu(f"layer{n}.2", f"l{n}_tlu")
        if n == 4:
            b.sandglass("layer4_5", "l4_sg")
    b.conv("layer7.1", "l7_conv", bias=False)
    b.bn("layer7.2", "l7_bn", affine=False)
    b.check_consumed()
    return {"params": nest_flat(b.params), "batch_stats": nest_flat(b.stats)}
