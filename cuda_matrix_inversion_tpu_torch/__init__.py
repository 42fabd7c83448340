"""cuda_matrix_inversion_tpu_torch — the PyTorch / NVIDIA Hopper port of
``cuda_matrix_inversion_tpu``.

Batched inversion of many small dense matrices through the same registry
of algorithms as the JAX package.  The fixed-schedule Newton-Schulz lanes
and the pivoted LU lane run hand-written CUDA kernels (``csrc/``, built
for ``sm_90a`` at first use) on CUDA tensors, and their plain PyTorch
versions on CPU tensors.  This package imports ``torch`` and never
``jax``.
"""

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
    "inverse_batched",
    "inverse_batched_device",
    "list_inverse_algorithms",
    "solve_batched",
]
