"""Readers, one file a metric: ``read(ctx)`` returns the value, or None where the cell has nothing to read."""
