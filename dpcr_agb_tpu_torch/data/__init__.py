from .batch import (PAD_COORD, Batch, CollateSpec, bucket_size, collate,
                    normalize_sparse_rows)
from .las_io import read_pt
from .synthetic import generate_plot

__all__ = ["PAD_COORD", "Batch", "CollateSpec", "bucket_size", "collate",
           "normalize_sparse_rows", "read_pt", "generate_plot"]
