"""Benchmark helpers: the accuracy gate."""
