"""BN-recalibration CLI of the port (counterpart of the root
`calibrate_bn.py`): forward-only train-mode epochs, so that only the
BatchNorm running statistics change, then the checkpoint is saved again
(into `run_dir`, `<checkpoint_dir>/calibrate` by default).

    python -m dpcr_agb_tpu_torch.calibrate_bn task=instance \\
        models=instance/minkowski_baseline model_name=SENet14 \\
        data=instance/NFI/reg data.transform_type=sparse_xy \\
        checkpoint_dir=outputs/... epochs=20 batch_size=64 [device=cpu]

Without `data=` and `task=`, the run config stored in the checkpoint is
composed instead. The compute dtype is the one the checkpoint trained with.
It runs on CUDA unless `device=cpu` is given, and raises when there is no
CUDA device and the CPU was not asked for."""
from __future__ import annotations

import logging
import sys

from .cli import CONF_DIR, split_device
from .config import compose_from_checkpoint, load_config
from .device import resolve_device
from .parallel import destroy, maybe_init_distributed
from .training.trainer import Trainer


def main(overrides=None) -> Trainer:
    """Recalibrate; returns the Trainer."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    overrides = list(overrides if overrides is not None else sys.argv[1:])
    device, overrides = split_device(overrides)
    started = maybe_init_distributed(device)
    try:
        return _calibrate(resolve_device(device), overrides)
    finally:
        if started:
            destroy()


def _calibrate(dev, overrides) -> Trainer:
    cfg = compose_from_checkpoint(overrides)
    if cfg is None:
        cfg = load_config(CONF_DIR, "calibrate_bn", overrides)
    saved_training = dict(cfg.get("training") or {})
    cfg["training"] = {
        "epochs": 0,
        "batch_size": cfg.get("batch_size",
                              saved_training.get("batch_size", 2)),
        "num_workers": cfg.get("num_workers", 0), "shuffle": True,
        # no enable_mixed: the trainer inherits the checkpoint's
        "checkpoint_dir": cfg["checkpoint_dir"],
        "weight_name": cfg.get("weight_name", "latest"),
        "optim": {"base_lr": 1e-3,
                  "optimizer": {"class": "AdaBelief", "params": {}}},
    }
    trainer = Trainer(cfg, device=dev)
    trainer.iterate_epochs(int(cfg.get("epochs", 1)))
    return trainer


if __name__ == "__main__":
    main()
