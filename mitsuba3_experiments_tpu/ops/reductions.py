"""Scatter reductions with arbitrary combiners.

The reference implements ``scatter_reduce_with(func, target, value, index)``
by iterated collision detection + ``dr.compress`` worklists
(/root/reference/reductions.py:12-54) because atomic scatter supports only
Add/Min/Max.  In JAX every scatter is one XLA op with defined semantics for
duplicate indices, so:

  * add/min/max/mul  -> native ``.at[idx].op(value)`` (race-free; on the GPU
    the float add/mul lower to atomics whose order, and so whose last bits,
    change from run to run — compare results with a tolerance)
  * arbitrary combiner -> sort-by-index + per-segment associative scan
    (segment boundaries from the sorted keys) — one sort, no contention loop.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def scatter_reduce(op: str, target, value, index):
    """op in {'add','min','max','mul'}: one XLA scatter."""
    at = target.at[index]
    return getattr(at, op)(value)


def scatter_reduce_with(combine, target, value, index):
    """Generic scatter-reduce with an arbitrary associative `combine(a, b)`.

    Sorts (index, value) pairs, reduces equal-index runs with an inclusive
    associative scan, and scatters the last element of each run into target.
    Shapes are static; cost is one sort + one scan, replacing
    the reference's data-dependent collision loop.
    """
    n = index.shape[0]
    order = jnp.argsort(index)
    si = jnp.take(index, order)
    sv = jax.tree_util.tree_map(lambda v: jnp.take(v, order, axis=0), value)

    # Segmented inclusive scan: combine within equal-si runs.
    def scan_fn(carry, xs):
        prev_i, prev_v = carry
        i, v = xs
        same = i == prev_i
        merged = jax.tree_util.tree_map(
            lambda a, b: jnp.where(same, combine(a, b), b), prev_v, v
        )
        return (i, merged), merged

    first = (jnp.asarray(-1, si.dtype), jax.tree_util.tree_map(lambda v: v[0], sv))
    (_, _), reduced = jax.lax.scan(scan_fn, first, (si, sv))

    # Run-last mask: position k is the last of its run.
    is_last = jnp.concatenate([si[:-1] != si[1:], jnp.ones((1,), bool)])
    # Scatter only run-lasts; dump others to a trash row (index n -> dropped
    # via mode='drop').
    tgt_idx = jnp.where(is_last, si, target.shape[0])
    return jax.tree_util.tree_map(
        lambda t, r: t.at[tgt_idx].set(r, mode="drop"), target, reduced
    )


def segment_sum(value, segment_ids, num_segments: int):
    """jax.ops.segment_sum wrapper (a scatter-add: atomics on the GPU)."""
    return jax.ops.segment_sum(value, segment_ids, num_segments=num_segments)


def block_sum(x, block: int):
    """dr.block_sum analog (/root/reference/nerad.py:231): sum over
    contiguous blocks of `block` elements along axis 0."""
    n = x.shape[0]
    assert n % block == 0, "block_sum: size must divide length"
    return jnp.sum(x.reshape((n // block, block) + x.shape[1:]), axis=1)
