from cuda_matrix_inversion_tpu_torch.utils.errors import div_ceil, ensure, fail
from cuda_matrix_inversion_tpu_torch.utils.timer import Timer, WelfordAccumulator

__all__ = ["ensure", "fail", "div_ceil", "Timer", "WelfordAccumulator"]
