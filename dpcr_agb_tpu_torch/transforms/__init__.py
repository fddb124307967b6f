"""Host-side numpy transforms, every one that the JAX package registers:
the NFI pre_transform and the train and test chains of the presets (the
chains themselves are the plain dicts of `serving.py`), the augmentation,
crop, sampling and z-outlier transforms users put into their own presets,
the batch-level `ClampBatchSize`, the sample filters, the treeadd
presets' `RadiusObjectAdder`, and the checkpoint-restoring inference
transforms. Importing the package registers every transform."""
from . import feature_augment as _feature_augment  # noqa: F401
from . import features as _features  # noqa: F401 (registration)
from . import filters as _filters  # noqa: F401
from . import grid as _grid  # noqa: F401
from . import objects as _objects  # noqa: F401
from . import transforms as _transforms  # noqa: F401
from .core import (TRANSFORM_REGISTRY, Compose, Transform, apply_index,
                   apply_mask, instantiate_transform, instantiate_transforms)
from .inference import ModelInference, PointNetForward

__all__ = ["TRANSFORM_REGISTRY", "Compose", "ModelInference",
           "PointNetForward", "Transform", "apply_index", "apply_mask",
           "instantiate_transform", "instantiate_transforms"]
