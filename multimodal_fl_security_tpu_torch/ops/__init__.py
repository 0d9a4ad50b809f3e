"""Tensor ops of the aggregation path and the Hopper kernels behind them."""
