"""Batched inversion and the GP kernels: the registry, the host API, the
hand-written kernels' wrappers and the ``torch.linalg`` baseline."""
