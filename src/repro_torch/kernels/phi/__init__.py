"""Φ^(n) kernels: ``ops`` (wrappers), ``kernel`` (ctypes launchers),
``ref`` (plain versions)."""
