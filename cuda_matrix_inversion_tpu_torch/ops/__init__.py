"""Batched inversion: the registry, the host API, the hand-written kernels'
wrappers and the ``torch.linalg`` baseline."""
