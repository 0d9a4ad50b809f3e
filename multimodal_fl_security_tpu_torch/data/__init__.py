"""Client-stacked data containers."""
