"""Parameter regularizers (counterpart of `dpcr_agb_tpu/training/
regularizers.py`): L1, L2 and elastic-net penalties over the model's
parameters, added to the training loss through the model option
`regularizers: {type, lambda[, alpha]}`.

A parameter is exempt when any part of its path (the `state_dict` key
without its last part; the port keeps the flax names, so these are the
flax paths) contains "bn", or "norm" in any case: the norm layers' scales
and biases. The sums run over the parameters in the order jax flattens
the flax params."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .optim import _jax_order


def penalized_names(named_params: Dict[str, torch.Tensor]) -> List[str]:
    """The names of the parameters a regularizer sums over, in jax's
    order."""
    return [n for n in _jax_order(named_params)
            if not any("bn" in p or "norm" in p.lower()
                       for p in n.split(".")[:-1])]


def _abs(p: torch.Tensor) -> torch.Tensor:
    """|p| with jnp.abs's derivative: +1 at 0 (torch.abs gives 0 there,
    and a bias at its zero init would get no L1 gradient)."""
    return torch.where(p >= 0, p, -p)


def l1(named_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(torch.sum(_abs(named_params[n]))
               for n in penalized_names(named_params))


def l2(named_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(torch.sum(torch.square(named_params[n]))
               for n in penalized_names(named_params))


def elastic(named_params: Dict[str, torch.Tensor],
            alpha: float = 0.5) -> torch.Tensor:
    return alpha * l1(named_params) + (1 - alpha) * l2(named_params)


REGULARIZERS = {"L1": l1, "L2": l2, "elastic": elastic, "ELASTIC": elastic}


def build_regularizer(option: dict) -> Optional[Callable]:
    """From the model option: `regularizers: {type, lambda[, alpha]}` ->
    a function of the named parameters, or None (no option, or lambda 0)."""
    cfg = option.get("regularizers")
    if not cfg:
        return None
    rtype = str(cfg.get("type", "L2"))
    lam = float(cfg.get("lambda", cfg.get("lambda_", 0.0)))
    if lam == 0.0:
        return None
    if rtype not in REGULARIZERS:
        raise ValueError(f"Unknown regularizer: {rtype} "
                         f"(choose from {sorted(REGULARIZERS)})")
    if rtype.lower() == "elastic":
        alpha = float(cfg.get("alpha", 0.5))
        return lambda p: lam * elastic(p, alpha)
    fn = REGULARIZERS[rtype]
    return lambda p: lam * fn(p)
