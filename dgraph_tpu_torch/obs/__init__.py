"""Observability: the host-side metrics registry."""
