"""Polymorphic dispatch over per-lane type ids — the vcall replacement.

The reference leans on Dr.Jit vcalls: `dr.dispatch` over BSDFPtr/ShapePtr
lanes (/root/reference/patch.py:14-44, custom-prop.py:14-21,
specular_from_bsdf.py:25-50) and `dr.reorder_threads` for coherence
(nerad.py:225).  XLA programs have no function pointers; the two idiomatic
lowerings are provided here:

  * `dispatch_masked` — evaluate every callee on all lanes, select by mask.
    Best when callees are cheap elementwise math (the BSDF library uses this form).
  * `dispatch_sorted` — sort lanes by type id, run each callee once on the
    full (sorted) batch with a mask, scatter results back.  The
    reorder-threads analog; wins when callees are expensive and types are
    many.
Both take the same (fn_table, type_id, *args) signature, so call sites can
switch strategies freely.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .compaction import invert_permutation, partition_by_key


def dispatch_masked(fn_table, type_id, *args):
    """fn_table: sequence of callables, one per type id; each is called on
    the full wavefront and results are masked together."""
    out = None
    for tid, fn in enumerate(fn_table):
        res = fn(*args)
        mask = type_id == tid
        if out is None:
            out = jax.tree_util.tree_map(jnp.zeros_like, res)
        out = jax.tree_util.tree_map(
            lambda o, r: jnp.where(
                mask.reshape(mask.shape + (1,) * (r.ndim - mask.ndim)), r, o
            ),
            out, res,
        )
    return out


def dispatch_sorted(fn_table, type_id, *args):
    """Sort-by-type, apply, scatter back (dr.reorder_threads + vcall)."""
    perm = partition_by_key(type_id)
    inv = invert_permutation(perm)
    sorted_args = jax.tree_util.tree_map(
        lambda x: jnp.take(x, perm, axis=0), args
    )
    sorted_ids = jnp.take(type_id, perm)
    out = dispatch_masked(fn_table, sorted_ids, *sorted_args)
    return jax.tree_util.tree_map(lambda x: jnp.take(x, inv, axis=0), out)


def reorder_threads(key, trees):
    """dr.reorder_threads analog: returns (permuted trees, inverse perm)."""
    perm = partition_by_key(key)
    inv = invert_permutation(perm)
    permuted = jax.tree_util.tree_map(
        lambda x: jnp.take(x, perm, axis=0), trees
    )
    return permuted, inv
