"""Parallelism over a sequence axis (single rank in this slice)."""
