"""Checkpoint reading for the flat ``.npz`` format of the JAX package.

The JAX package saves a variables tree as one array per leaf under keys
joined with ``::`` (``params::gnn::layer_0::attn::proj_q::kernel``).
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
