"""Weight bridge between the flax variable trees of the JAX package and the
port's `state_dict`.

The port's submodules carry the flax names and keep the flax layouts
(sparse conv kernels [K^3, Cin, Cout] with z-fastest offsets, linear
kernels [in, out]), so the bridge is a rename: the nested path
("stage0_block0", "se", "fc1", "kernel") is the key
"stage0_block0.se.fc1.kernel". BN running stats (`mean`, `var`) live in
`batch_stats` on the flax side and are buffers in the port. Plain nested
dicts of numpy arrays in, no flax needed."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_STAT_NAMES = ("mean", "var")


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + ".")
        else:
            yield key, v


def from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """{params, batch_stats} nested dicts of arrays -> state_dict."""
    out = {}
    for tree in (params, batch_stats or {}):
        for key, v in _flatten(tree):
            if key in out:
                raise ValueError(f"duplicate variable {key!r}")
            out[key] = torch.tensor(np.array(v))
    return out


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """state_dict -> (params, batch_stats) nested dicts of numpy arrays."""
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        path = key.split(".")
        node = stats if path[-1] in _STAT_NAMES else params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.detach().cpu().numpy()
    return params, stats
