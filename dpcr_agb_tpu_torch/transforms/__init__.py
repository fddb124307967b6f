"""Host-side numpy transforms: the NFI pre_transform and the train and
test chains of the sparse_xy and xy presets (the chains themselves are the
plain dicts of `serving.py`). Importing the package registers every
transform."""
from . import features as _features  # noqa: F401 (registration)
from . import grid as _grid  # noqa: F401
from . import transforms as _transforms  # noqa: F401
from .core import (TRANSFORM_REGISTRY, Compose, Transform, apply_index,
                   apply_mask, instantiate_transform, instantiate_transforms)

__all__ = ["TRANSFORM_REGISTRY", "Compose", "Transform", "apply_index",
           "apply_mask", "instantiate_transform", "instantiate_transforms"]
