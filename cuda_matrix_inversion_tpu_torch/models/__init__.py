"""Models built on the batched kernels: the Gaussian-Process pipeline."""

from cuda_matrix_inversion_tpu_torch.models.gp import (
    gp_log_marginal_likelihood,
    gp_mean,
    gp_mean_host,
    gp_mean_variance,
    gp_mean_variance_host,
    gp_mean_variance_multi,
    gp_variance,
    gp_variance_host,
)

__all__ = [
    "gp_log_marginal_likelihood",
    "gp_mean",
    "gp_mean_host",
    "gp_mean_variance",
    "gp_mean_variance_host",
    "gp_mean_variance_multi",
    "gp_variance",
    "gp_variance_host",
]
