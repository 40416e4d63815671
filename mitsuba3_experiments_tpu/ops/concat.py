"""Array concatenation helpers mirroring the reference's gather/scatter
implementations (/root/reference/util.py:7-45).  In JAX both are just
``jnp.concatenate``; the two entry points are kept for API parity and the
scatter variant demonstrates the index-arithmetic formulation used when
building into a preallocated buffer.
"""
from __future__ import annotations

import jax.numpy as jnp


def concat_gather(arrays):
    """util.py:7-29 concat via arange+gather-select == jnp.concatenate."""
    return jnp.concatenate(arrays, axis=0)


def concat_scatter(arrays):
    """util.py:32-45 concat via scatter into a fresh buffer."""
    n = sum(a.shape[0] for a in arrays)
    out = jnp.zeros((n,) + arrays[0].shape[1:], arrays[0].dtype)
    off = 0
    for a in arrays:
        out = out.at[off : off + a.shape[0]].set(a)
        off += a.shape[0]
    return out
