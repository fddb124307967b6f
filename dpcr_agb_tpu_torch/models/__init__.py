from .base import InstanceSpec, convert_outputs, reg_output
from .factory import build_model, collate_spec, make_post_collate
from .minkowski import ResBlock, SparseConv, SparseResNet, build_resnet

__all__ = ["InstanceSpec", "convert_outputs", "reg_output", "build_model",
           "collate_spec", "make_post_collate", "ResBlock", "SparseConv",
           "SparseResNet", "build_resnet"]
