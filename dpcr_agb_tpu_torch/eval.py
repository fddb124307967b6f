"""Evaluation CLI of the port (counterpart of the root `eval.py`): loads a
checkpoint, runs deterministic eval over `eval_stages` (with `voting_runs`,
`enable_dropout`, `enable_bn`) and exports the predictions.

    python -m dpcr_agb_tpu_torch.eval task=instance \\
        models=instance/minkowski_baseline model_name=SENet14 \\
        data=instance/NFI/reg data.transform_type=sparse_xy_eval \\
        checkpoint_dir=outputs/... weight_name=total_BMag_ha_rmse [device=cpu]

Without `data=` and `task=`, the run config stored in
`<checkpoint_dir>/<model_name>.ckpt` is composed instead (with the other
overrides on top) and the `visualization=eval` group exports the
predictions. It runs on CUDA unless `device=cpu` is given, and raises when
there is no CUDA device and the CPU was not asked for."""
from __future__ import annotations

import logging
import sys

from .cli import CONF_DIR, split_device, visualization_group
from .config import compose_from_checkpoint, load_config
from .device import resolve_device
from .parallel import destroy, maybe_init_distributed
from .training.trainer import Trainer


def main(overrides=None):
    """Evaluate; returns {stage: metrics}."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    overrides = list(overrides if overrides is not None else sys.argv[1:])
    device, overrides = split_device(overrides)
    started = maybe_init_distributed(device)
    try:
        return _evaluate(resolve_device(device), overrides)
    finally:
        if started:
            destroy()


def _evaluate(dev, overrides):
    cfg = compose_from_checkpoint(overrides)
    if cfg is None:
        cfg = load_config(CONF_DIR, "eval", overrides)
    else:
        # the stored run config holds the train-time visualization; eval
        # exports predictions unless visualization=<group> says otherwise
        viz = next((o.split("=", 1)[1] for o in overrides
                    if o.startswith("visualization=")), "eval")
        cfg["visualization"] = visualization_group(viz)
    if cfg.get("pretty_print"):
        print(cfg.pretty())
    # the trainer reads training.* keys; the eval root keeps them at the top
    cfg["training"] = {
        "epochs": 0, "batch_size": cfg.get("batch_size", 2),
        "num_workers": cfg.get("num_workers", 0), "shuffle": False,
        "checkpoint_dir": cfg["checkpoint_dir"],
        "weight_name": cfg.get("weight_name", "latest"),
        "optim": {"base_lr": 1e-3,
                  "optimizer": {"class": "AdaBelief", "params": {}}},
    }
    trainer = Trainer(cfg, eval_mode=True, device=dev)
    return {stage: trainer.eval(stage)
            for stage in cfg.get("eval_stages", ["val", "test"])}


if __name__ == "__main__":
    main()
