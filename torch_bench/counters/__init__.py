"""The program's counters, one file each: ``read() -> int``."""
