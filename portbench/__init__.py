"""The benchmark of upnerf_torch on the H100 (see README.md)."""
