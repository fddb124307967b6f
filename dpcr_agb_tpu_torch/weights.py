"""Weight bridge between the flax variable trees of the JAX package and the
port's `state_dict`.

The port's submodules carry the flax names and keep the flax layouts
(sparse conv kernels [K^3, Cin, Cout] with z-fastest offsets, linear
kernels [in, out]), so the bridge is a rename: the nested path
("stage0_block0", "se", "fc1", "kernel") is the key
"stage0_block0.se.fc1.kernel". BN running stats (`mean`, `var`) live in
`batch_stats` on the flax side and are buffers in the port. Plain nested
dicts of numpy arrays in, no flax needed. `opt_state_from_optax` carries
the optax state of the JAX recipe (clip, then AdaBelief, or per group an
optax.multi_transform of two such chains) across with the same names.
`in_channels_of` reads a model's input width off its weights, which is
how a JAX checkpoint's model is rebuilt: the JAX serving bundle builds
KPConv's input width from a feature count it leaves at 0 (-> 1), and
flax infers the other models' from the first batch."""
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
        elif not (isinstance(v, tuple) and len(v) == 0):
            # an empty tuple is optax's MaskedNode: a leaf of the other
            # group in a per-group state, which carries nothing
            yield key, v


def from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """{params, batch_stats} nested dicts of arrays (or tensors: a
    checkpoint's bf16 leaves) -> state_dict."""
    out = {}
    for tree in (params, batch_stats or {}):
        for key, v in _flatten(tree):
            if key in out:
                raise ValueError(f"duplicate variable {key!r}")
            out[key] = v.clone() if isinstance(v, torch.Tensor) \
                else torch.tensor(np.array(v))
    return out


def in_channels_of(option: dict, state_dict: Dict[str, torch.Tensor]
                   ) -> int:
    """The input feature width of the `conf/models` entry `option` whose
    weights are `state_dict`, read off its first layer: the sparse-voxel
    nets' stem kernel [343, Cin, 64]; KPConv's first block, a `simple`
    KPConv (every architecture in conf/ starts with one), [Kp, Cin, C];
    MPointNet's first linear [3 + Cin, 64] with its positions added (else
    [Cin, 64]); SimplestNet's [Cin + 3, 64] over [x, pos]; PointNeXt's
    stem [Cin, 32]; the PointNet encoder's first linear [3 + Cin, 64] over
    [pos, x]."""
    cls = option["class"]
    if cls == "kpconv.KPConv":
        return int(state_dict["block0_kpconv.weights"].shape[1])
    if cls == "simplestnet.SimplestNet":
        return int(state_dict["conv0.kernel"].shape[0]) - 3
    if cls == "pointnext.PointNext":
        if option.get("arch", "pointnext_s") == "pointnet":
            return int(state_dict["enc0.conv.kernel"].shape[0]) - 3
        return int(state_dict["stem.conv.kernel"].shape[0])
    if option.get("model_name") == "MinkowskiPointNet":
        return int(state_dict["b1_lin.kernel"].shape[0]) \
            - (3 if option.get("add_pos", False) else 0)
    return int(state_dict["stem_conv.kernel"].shape[1])


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


def opt_state_from_optax(opt_state) -> dict:
    """The JAX recipe's optimizer state, `(clip state, AdaBeliefState(count,
    exp_avg, exp_avg_var))` (optax.chain(optax.clip, adabelief)), as
    {"count": int, "exp_avg": {name: tensor}, "exp_avg_var": {name:
    tensor}} with the state_dict names of the parameters. Any object with
    `count`, `exp_avg` and `exp_avg_var` attributes (a NamedTuple) works;
    the clip state carries nothing. A per-group state (optax.multi_transform:
    `inner_states` of masked chains) gives {group: that dict} over the
    group's own parameters."""
    inner = getattr(opt_state, "inner_states", None)
    if inner is not None:
        return {k: opt_state_from_optax(getattr(v, "inner_state", v))
                for k, v in sorted(inner.items())}
    ada = next(s for s in opt_state if hasattr(s, "exp_avg_var"))
    return {"count": int(np.asarray(ada.count)),
            "exp_avg": from_flax(ada.exp_avg, None),
            "exp_avg_var": from_flax(ada.exp_avg_var, None)}
