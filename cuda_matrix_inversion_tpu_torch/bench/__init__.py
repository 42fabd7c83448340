"""Benchmarks: the reference's two CLIs (``inverse_bench``, ``gauss_bench``),
their reporting, and the on-card probes of the kernels."""
