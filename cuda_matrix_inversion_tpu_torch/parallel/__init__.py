"""Batching across matrices of mixed size (the sharding across cards is
still to port)."""

from cuda_matrix_inversion_tpu_torch.parallel.bucketing import (
    DEFAULT_BUCKETS,
    assign_buckets,
    bucketed_gp_mean_variance,
    bucketed_inverse,
    pack_buckets,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "assign_buckets",
    "bucketed_gp_mean_variance",
    "bucketed_inverse",
    "pack_buckets",
]
