"""GMatcher weights: the JAX package's checkpoints into the port's modules.

``load_gims_checkpoint`` reads the ``.npz`` flat-pytree format of the JAX
package (``gims_tpu/matcher/convert.py:128-140``) into the same nested
variables tree. ``variables_to_state_dict`` maps that tree onto the port's
``state_dict``: the port's submodules carry the flax module names, so a
leaf's path is its key, with the leaf renamed:

* flax ``Dense.kernel`` (in, out) -> ``Linear.weight`` (out, in), transposed;
* ``MaskedBatchNorm`` ``scale``/``bias`` -> ``weight``/``bias``, and
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* everything else (``bias``, ``bin_score``, ``a_2``/``b_2``) as it is.

``load_variables`` then puts each attention layer's heads in the port's
head-major order (``head_major_perm``) and loads the result strictly.
``module_variables`` is the inverse: a module's parameters and buffers as
the JAX layout's variables tree, heads back in the reference's channel
interleave, so that ``core.checkpoint.save_npz`` writes a checkpoint the
JAX package loads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gims_tpu_torch.core.checkpoint import unflatten_npz
from gims_tpu_torch.matcher.layers import MaskedBatchNorm, MultiHeadedAttention

_RENAME = {"kernel": "weight", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}
_COLLECTIONS = ("params", "batch_stats")


def load_gims_checkpoint(path: str):
    """GMatcher variables from a ``.npz`` of the JAX package."""
    if not str(path).endswith(".npz"):
        raise NotImplementedError(
            "only .npz GMatcher checkpoints load in the port; the reference's "
            "torch .pt import is not ported yet (see ROADMAP.md)")
    return unflatten_npz(path)


def variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax variables tree (numpy leaves) -> the port's state_dict."""
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
                arr = arr.T
            name = ".".join(path + [_RENAME.get(key, key)])
            if name in sd:
                raise ValueError(f"two variables map to {name}")
            sd[name] = torch.from_numpy(np.array(arr, order="C"))

    for collection in _COLLECTIONS:
        walk(variables.get(collection, {}), [])
    return sd


def head_major_perm(d_model: int, num_heads: int) -> torch.Tensor:
    """perm[h*D + d] = d*H + h: the reference's channel of head h, dim d."""
    dim = d_model // num_heads
    return torch.arange(d_model).view(dim, num_heads).t().reshape(-1)


def load_variables(model: torch.nn.Module, variables) -> None:
    """Copy a flax variables tree into `model`; raises on any missing or
    unexpected key (strict load). The reference interleaves the attention
    heads by channel (c = d*H + h); the q/k/v projection rows and the
    merge columns are permuted here to the port's head-major order."""
    sd = variables_to_state_dict(variables)
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadedAttention):
            perm = head_major_perm(mod.d_model, mod.num_heads)
            pre = f"{name}." if name else ""
            for proj in ("proj_q", "proj_k", "proj_v"):
                for leaf in ("weight", "bias"):
                    sd[f"{pre}{proj}.{leaf}"] = sd[f"{pre}{proj}.{leaf}"][perm]
            sd[f"{pre}merge.weight"] = sd[f"{pre}merge.weight"][:, perm]
    model.load_state_dict(sd, strict=True)


def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def module_variables(model: torch.nn.Module, params=None):
    """The JAX layout's variables tree (``params``, ``batch_stats``; f32 numpy
    leaves) of a GMatcher. `params` optionally maps parameter names to
    tensors that take the parameters' place (an EMA copy)."""
    params = params or {}
    out = {"params": {}, "batch_stats": {}}
    attn = []
    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        pre = f"{name}." if name else ""
        for leaf, p in mod.named_parameters(recurse=False):
            arr = params.get(pre + leaf, p).detach().float().cpu().numpy()
            key = leaf
            if isinstance(mod, torch.nn.Linear) and leaf == "weight":
                key, arr = "kernel", arr.T
            elif isinstance(mod, MaskedBatchNorm) and leaf == "weight":
                key = "scale"
            _put(out["params"], path + [key], arr)
        for leaf, buf in mod.named_buffers(recurse=False):
            key = {"running_mean": "mean", "running_var": "var"}[leaf]
            _put(out["batch_stats"], path + [key], buf.detach().float().cpu().numpy())
        if isinstance(mod, MultiHeadedAttention):
            attn.append((path, mod))
    for path, mod in attn:  # heads back to the reference's interleave
        inv = torch.argsort(head_major_perm(mod.d_model, mod.num_heads)).numpy()
        node = out["params"]
        for p in path:
            node = node[p]
        for proj in ("proj_q", "proj_k", "proj_v"):
            node[proj]["kernel"] = node[proj]["kernel"][:, inv]
            node[proj]["bias"] = node[proj]["bias"][inv]
        node["merge"]["kernel"] = node["merge"]["kernel"][inv]
    return _contiguous(out)


def _contiguous(tree):
    return {k: _contiguous(v) if isinstance(v, dict) else np.array(v, order="C")
            for k, v in tree.items()}
