"""Π^(n) rows in the blocked layout's slot order: ``ops`` (wrapper),
``kernel`` (ctypes launcher), ``ref`` (plain version)."""
