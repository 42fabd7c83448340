"""cuda_matrix_inversion_tpu_torch — the PyTorch / NVIDIA Hopper port of
``cuda_matrix_inversion_tpu``.

Batched inversion of many dense matrices (8 … 512 and past) through the
same registry of algorithms as the JAX package, an fp64-class lane refined
in native float64, the Gaussian-Process mean/variance pipeline and its
hyper-parameter fit on top of it, the bucketed serving engines and the
mixed-dimension bucketing.  The fixed-schedule and warm-start
Newton-Schulz, pivoted LU (one block per matrix to n = 128, blocked panels
past it), Gauss-Jordan and Cholesky lanes, the fused GP methods and the
fused log marginal likelihood run hand-written CUDA kernels (``csrc/``,
built for ``sm_90a`` at first use) on CUDA tensors, and their plain
PyTorch versions on CPU tensors.  This package imports ``torch`` and never
``jax``.
"""

from cuda_matrix_inversion_tpu_torch.engine import GPEngine, InversionEngine
from cuda_matrix_inversion_tpu_torch.io.mats import (
    read_mats,
    read_test_folder,
    write_mats,
)
from cuda_matrix_inversion_tpu_torch.io.replicate import replicate_matrices
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
from cuda_matrix_inversion_tpu_torch.models.gp_fit import (
    GPFitResult,
    fit_gp_scales,
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
from cuda_matrix_inversion_tpu_torch.parallel.bucketing import (
    bucketed_gp_mean_variance,
    bucketed_inverse,
)
from cuda_matrix_inversion_tpu_torch.types import (
    MatrixBatch,
    default_dtype,
    set_default_dtype,
)

__version__ = "0.1.0"

__all__ = [
    "GPEngine",
    "GPFitResult",
    "InversionEngine",
    "MatrixBatch",
    "SingularBatchError",
    "__version__",
    "bucketed_gp_mean_variance",
    "bucketed_inverse",
    "default_dtype",
    "fit_gp_scales",
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
    "read_mats",
    "read_test_folder",
    "replicate_matrices",
    "set_default_dtype",
    "solve_batched",
    "write_mats",
]
