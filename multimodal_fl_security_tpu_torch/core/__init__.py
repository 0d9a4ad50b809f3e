"""Flat parameter buffers and name registries."""
