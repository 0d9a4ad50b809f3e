"""Benchmarks of the port that run on a CUDA card."""
