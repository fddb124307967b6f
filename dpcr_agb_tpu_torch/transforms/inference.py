"""Inference transforms: a pretrained model run inside the data pipeline
(counterpart of `dpcr_agb_tpu/transforms/inference.py`).

`ModelInference` restores `<checkpoint_dir>/<model_name>.ckpt`, a
checkpoint of the JAX package's trainer, and rebuilds the network of its
run_config (`run_config["models"][run_config["model_name"]]`) with the
weights that `weight_name` names, on `device` (CUDA unless "cpu" is asked
for, as the entry points); subclasses implement `__call__`.
`PointNetForward` attaches a pretrained MPointNet's per-point embedding
(`return_point_features`: the [N, E] rows after the shared MLPs) as
`sample[feat_name]`. Both run on the host's sample dicts, one sample a
call."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data.batch import Batch
from ..device import resolve_device
from ..models.factory import build_model
from ..weights import from_flax, in_channels_of
from .core import Transform, register


@register
class ModelInference(Transform):
    """Base: the network and weights of a JAX `.ckpt`. `mock_dataset` is
    the reference's argument and changes nothing."""

    def __init__(self, checkpoint_dir: str, model_name: str,
                 weight_name: str = "latest",
                 feat_name: Optional[str] = None,
                 num_classes: Optional[int] = None, mock_dataset: bool = True,
                 device=None):
        # imported here: training.state imports serving, which imports
        # this package
        from ..training.state import Checkpoint

        path = os.path.join(checkpoint_dir, f"{model_name}.ckpt")
        with open(path, "rb") as f:
            ckpt = Checkpoint.from_bytes(f.read())
        run_cfg = ckpt.run_config
        option = dict(run_cfg["models"][run_cfg["model_name"]])
        saved = ckpt.get_model_state(weight_name)
        state = from_flax(saved["params"], saved.get("batch_stats"))
        if num_classes is None:
            num_classes = len(ckpt.dataset_properties.get(
                "target_stats", {}).get("scale", [])) or 2
        self.device = resolve_device(device)
        self.net, _ = build_model(option, num_classes,
                                  in_channels_of(option, state))
        self.net.load_state_dict(state)
        self.net.to(self.device).eval()
        self.feat_name = feat_name

    def __call__(self, rng, sample):
        raise NotImplementedError("subclass ModelInference")


@register
class PointNetForward(ModelInference):
    """sample[feat_name]: a pretrained MPointNet's per-point embedding
    [N, E] (f32) of the sample's positions and features (ones [N, 1]
    where it has none)."""

    def __init__(self, checkpoint_dir: str, model_name: str,
                 weight_name: str = "latest", feat_name: str = "pointnet_feat",
                 num_classes: Optional[int] = None, mock_dataset: bool = True,
                 device=None):
        super().__init__(checkpoint_dir, model_name, weight_name, feat_name,
                         num_classes, mock_dataset, device)

    @torch.no_grad()
    def __call__(self, rng, sample):
        pos = np.asarray(sample["pos"], np.float32)
        n = len(pos)
        x = sample.get("x")
        if x is None:
            x = np.ones((n, 1), np.float32)
        batch = Batch(pos=pos[None], x=np.asarray(x, np.float32)[None],
                      mask=np.ones((1, n), bool), y_reg=None,
                      y_reg_mask=None, area_idx=None, label_idx=None,
                      is_double=None).to(self.device)
        feats = self.net(batch, return_point_features=True)
        sample = dict(sample)
        sample[self.feat_name] = feats[0].float().cpu().numpy()
        return sample
