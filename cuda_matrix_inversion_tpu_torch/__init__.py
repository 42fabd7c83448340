"""cuda_matrix_inversion_tpu_torch — the PyTorch / NVIDIA Hopper port of
``cuda_matrix_inversion_tpu``.

Batched inversion of many small dense matrices through the same registry
of algorithms as the JAX package, and the Gaussian-Process mean/variance
pipeline on top of it.  The fixed-schedule Newton-Schulz, pivoted LU and
Cholesky lanes and the fused GP methods run hand-written CUDA kernels
(``csrc/``, built for ``sm_90a`` at first use) on CUDA tensors, and their
plain PyTorch versions on CPU tensors.  This package imports ``torch`` and
never ``jax``.
"""

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
from cuda_matrix_inversion_tpu_torch.ops.host_api import (
    SingularBatchError,
    inverse_batched,
    inverse_batched_device,
    solve_batched,
)
from cuda_matrix_inversion_tpu_torch.ops.registry import (
    get_inverse_algorithm,
    list_inverse_algorithms,
)

__version__ = "0.1.0"

__all__ = [
    "SingularBatchError",
    "get_inverse_algorithm",
    "gp_log_marginal_likelihood",
    "gp_mean",
    "gp_mean_host",
    "gp_mean_variance",
    "gp_mean_variance_host",
    "gp_mean_variance_multi",
    "gp_variance",
    "gp_variance_host",
    "inverse_batched",
    "inverse_batched_device",
    "list_inverse_algorithms",
    "solve_batched",
]
