"""STREAM kernel: ``ops`` (wrapper), ``kernel`` (ctypes launcher), ``ref``
(plain version and the paper's Table 3 counts)."""
