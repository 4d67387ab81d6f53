"""Sparse MTTKRP kernel: ``ops`` (wrappers), ``kernel`` (ctypes launcher),
``ref`` (plain versions)."""
