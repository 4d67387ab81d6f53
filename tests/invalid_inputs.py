"""Invalid solver inputs for the input-check tests, one per case.

Each case changes a good tensor's indices, values or rank the way a
caller's mistake would.  The CPU parity test holds the port's messages to
the JAX package's on these cases; the on-card test holds a card tensor's
messages to the same tensor's on the CPU.  This module imports neither
jax nor torch, so both can share it.
"""
import numpy as np

CASES = ("index", "negative", "nan", "rank", "indices-width",
         "values-length", "inf", "-inf", "two-modes", "index-and-nan",
         "nan-and-negative", "bf16-negative")


def corrupt(case: str, shape, indices, values, rank: int):
    """``(indices, values, rank, bf16)`` of ``case``, made from copies of
    a good tensor's numpy arrays; ``bf16`` asks for the values in bf16."""
    idx, vals = np.array(indices), np.array(values)
    bf16 = False
    if case == "index":
        idx[3, 1] = shape[1]
    elif case == "negative":
        vals[5] = -1.0
    elif case == "nan":
        vals[2] = np.nan
    elif case == "rank":
        rank = 0
    elif case == "indices-width":
        idx = idx[:, :-1]
    elif case == "values-length":
        vals = vals[:-1]
    elif case == "inf":
        vals[4] = np.inf
    elif case == "-inf":
        vals[6] = -np.inf
    elif case == "two-modes":
        # mode 2's offender comes first, but the lower mode is named
        idx[3, 1] = shape[1]
        idx[1, 2] = -1
    elif case == "index-and-nan":
        idx[7, 0] = shape[0] + 5
        vals[1] = np.nan
    elif case == "nan-and-negative":
        # the negative value comes first, but non-finite is checked first
        vals[1] = -1.0
        vals[4] = np.nan
    elif case == "bf16-negative":
        vals[5] = -1.01  # held in bf16 as -1.0078125
        bf16 = True
    else:
        raise ValueError(case)
    return idx, vals, rank, bf16
