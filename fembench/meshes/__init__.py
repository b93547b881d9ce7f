"""Mesh recipes of the benchmark's configurations, one module each."""
