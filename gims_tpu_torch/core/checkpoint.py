"""Checkpoint reading and writing in the flat ``.npz`` format of the JAX
package.

The JAX package saves a variables tree as one array per leaf under keys
joined with ``::`` (``params::gnn::layer_0::attn::proj_q::kernel``).
``flatten_tree`` and ``save_npz`` write that format from a nested dict of
arrays or tensors, so that the JAX package loads the port's exports
(port of ``gims_tpu/core/checkpoint.py:23-41``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

SEP = "::"


def unflatten_npz(path: str) -> Dict[str, Any]:
    """Load a flat ``::``-keyed npz into a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            parts = key.split(SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {``a::b::leaf``: numpy array}; tensors are copied to
    the host."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(flatten_tree(val, name))
        else:
            if hasattr(val, "detach"):
                val = val.detach().cpu().numpy()
            flat[name] = np.asarray(val)
    return flat


def save_npz(path: str, tree) -> None:
    """Write a nested dict of arrays as the JAX package's flat npz."""
    np.savez(path, **flatten_tree(tree))
