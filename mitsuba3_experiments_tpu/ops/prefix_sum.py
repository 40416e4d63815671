"""Parallel prefix sum.

The reference hand-rolls a Hillis-Steele scan with gather/scatter because
Dr.Jit lacked one (/root/reference/prefix_sum.py:9-36).  In JAX the
idiomatic primitive is ``jnp.cumsum``, which XLA lowers to a log-depth scan.
"""
from __future__ import annotations

import jax.numpy as jnp


def prefix_sum(x, exclusive: bool = False):
    """Inclusive (default) or exclusive prefix sum along axis 0."""
    s = jnp.cumsum(x, axis=0)
    if exclusive:
        s = jnp.concatenate([jnp.zeros_like(s[:1]), s[:-1]], axis=0)
    return s
