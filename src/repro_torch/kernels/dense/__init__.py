"""Dense matrix-free kernels: ``ops`` (wrappers), ``kernel`` (ctypes
launchers), ``ref`` (plain versions)."""
