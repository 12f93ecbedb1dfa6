"""GMatcher weights: the JAX package's checkpoints into the port's modules.

``load_gims_checkpoint`` reads the ``.npz`` flat-pytree format of the JAX
package (``gims_tpu/matcher/convert.py:128-140``) into the same nested
variables tree, or a reference torch training checkpoint (``.pt``: the EMA
weights first, then ``model``, then a bare state_dict) through
``convert_gmatcher_torch``, the port's copy of the JAX package's converter
(``gims_tpu/matcher/convert.py:70-148``; reference layout
models/gmatcher.py:165-217). ``variables_to_state_dict`` maps that tree onto the port's
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


def _f32(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float32)


class TorchTree:
    """Collects flax leaves from a reference state_dict and records the keys
    it consumed."""

    def __init__(self, sd):
        self.sd = dict(sd)
        self.params = {}
        self.stats = {}
        self.used = set()

    def get(self, key):
        self.used.add(key)
        return _f32(self.sd[key])

    def dense_from_conv1d(self, tp, fp):  # Conv1d (O, I, 1) -> Dense (I, O)
        self.params[fp] = {"kernel": self.get(f"{tp}.weight")[:, :, 0].T,
                           "bias": self.get(f"{tp}.bias")}

    def dense_from_linear(self, tp, fp, bias=True):
        p = {"kernel": self.get(f"{tp}.weight").T}
        if bias:
            p["bias"] = self.get(f"{tp}.bias")
        self.params[fp] = p

    def bn(self, tp, fp):
        self.params[fp] = {"scale": self.get(f"{tp}.weight"), "bias": self.get(f"{tp}.bias")}
        self.stats[fp] = {"mean": self.get(f"{tp}.running_mean"),
                          "var": self.get(f"{tp}.running_var")}
        self.used.add(f"{tp}.num_batches_tracked")

    def mlp(self, tp, fp, n_layers):
        """The reference MLP(): [conv, norm, relu] * (n - 1) + conv, so the
        convs sit at 3i and the norms at 3i + 1."""
        for i in range(n_layers):
            self.dense_from_conv1d(f"{tp}.{3 * i}", f"{fp}/dense_{i}")
            if i < n_layers - 1:
                self.bn(f"{tp}.{3 * i + 1}", f"{fp}/norm_{i}")

    def check_consumed(self):
        unused = set(self.sd) - self.used
        if unused:
            raise ValueError(f"unconsumed torch keys: {sorted(unused)[:8]} ...")


def nest_flat(flat):
    """{"a/b/c": leaf} -> nested dicts; a module's extra leaves merge into it."""
    tree = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        last = parts[-1]
        if last in node and isinstance(node[last], dict) and isinstance(leaf, dict):
            node[last].update(leaf)  # GraphSAGE's bias on the conv module itself
        else:
            node[last] = leaf
    return tree


def convert_gmatcher_torch(state_dict, num_gnn_layers=18, kenc_layers=(32, 64, 128, 256),
                           has_input_proj=False):
    """A reference GMatcher state_dict -> the JAX layout's variables tree
    ({'params': ..., 'batch_stats': ...}, f32 numpy leaves). DDP's
    ``module.`` prefixes are stripped (reference utils/common.py:107-114);
    a key left over raises."""
    b = TorchTree({(k[7:] if k.startswith("module.") else k): v
                    for k, v in dict(state_dict).items()})
    b.mlp("kenc.encoder", "kenc/encoder", len(kenc_layers) + 1)
    for i in range(num_gnn_layers):
        base, fp = f"gnn.layers.{i}", f"gnn/layer_{i}"
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            b.dense_from_conv1d(f"{base}.attn.proj.{j}", f"{fp}/attn/{name}")
        b.dense_from_conv1d(f"{base}.attn.merge", f"{fp}/attn/merge")
        b.mlp(f"{base}.mlp", f"{fp}/mlp", 2)
    for i in range(3):
        base, fp = f"gnn_encoder.layers.{i}", f"gnn_encoder/layer_{i}"
        b.dense_from_linear(f"{base}.fc_self", f"{fp}/fc_self", bias=False)
        b.dense_from_linear(f"{base}.fc_neigh", f"{fp}/fc_neigh", bias=False)
        b.params[fp] = {"bias": b.get(f"{base}.bias")}  # DGL keeps it on the conv
    if has_input_proj:
        b.dense_from_linear("input_proj", "input_proj")
    b.dense_from_conv1d("final_proj", "final_proj")
    b.params["bin_score"] = b.get("bin_score").reshape(())
    b.check_consumed()
    return {"params": nest_flat(b.params), "batch_stats": nest_flat(b.stats)}


def load_gims_checkpoint(path: str, **kwargs):
    """GMatcher variables from a ``.npz`` of the JAX package, or from a
    reference torch checkpoint (``.pt``): its ``ema`` weights where set, else
    its ``model``, else the file as a bare state_dict (reference
    models/gmatcher.py:208-217). `kwargs` go to ``convert_gmatcher_torch``."""
    if str(path).endswith(".npz"):
        return unflatten_npz(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ckpt.get("ema") is not None:
        sd = ckpt["ema"]
    elif isinstance(ckpt, dict) and "model" in ckpt:
        sd = ckpt["model"]
    else:
        sd = ckpt
    return convert_gmatcher_torch(sd, **kwargs)


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
