"""Pytree struct utilities — the DRJIT_STRUCT protocol, the JAX way.

The reference decorates plain classes with ``@drjitstruct``
(/root/reference/drjitstruct.py:4-12) so Dr.Jit can gather/scatter/zero whole
records.  Here records are frozen dataclasses registered as JAX pytrees, and
the same whole-record operations are tree-mapped jnp primitives:

  dr.zeros(Struct, n)        -> tzeros_like / Struct.zeros(n)
  dr.gather(Struct, buf, i)  -> tgather(buf, i)
  dr.scatter(buf, v, i)      -> tscatter_set(buf, v, i) (functional .at[].set)
  dr.select(m, a, b)         -> twhere(m, a, b)
  dr.tile / dr.repeat        -> ttile / trepeat
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def jstruct(cls):
    """Decorator: frozen dataclass registered as a JAX pytree.

    Fields annotated with ``metadata={'static': True}`` become aux data.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


def replace(obj, **kwargs):
    return dataclasses.replace(obj, **kwargs)


# --- whole-record (tree) operations ----------------------------------------

def _bmask(mask, leaf):
    """Broadcast a (N,) mask against a (N, ...) leaf."""
    extra = leaf.ndim - mask.ndim
    return mask.reshape(mask.shape + (1,) * extra)


def twhere(mask, a, b):
    """Tree select: leaf-wise jnp.where with mask broadcast over trailing dims."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(_bmask(mask, x), x, y), a, b
    )


def tzeros_like(tree):
    return jax.tree_util.tree_map(jnp.zeros_like, tree)


def tgather(tree, idx, axis: int = 0):
    """Gather records by index along the wavefront axis (dr.gather on structs,
    e.g. Path.__getitem__ at /root/reference/pathrecord.py:50-59)."""
    return jax.tree_util.tree_map(lambda x: jnp.take(x, idx, axis=axis), tree)


def tscatter_set(buf, value, idx):
    """Functional scatter-write of records (dr.scatter on structs)."""
    return jax.tree_util.tree_map(lambda b, v: b.at[idx].set(v), buf, value)


def tscatter_add(buf, value, idx):
    return jax.tree_util.tree_map(lambda b, v: b.at[idx].add(v), buf, value)


def ttile(tree, count: int):
    """dr.tile: [a b c] -> [a b c a b c] along axis 0."""
    return jax.tree_util.tree_map(
        lambda x: jnp.tile(x, (count,) + (1,) * (x.ndim - 1)), tree
    )


def trepeat(tree, count: int):
    """dr.repeat: [a b c] -> [a a b b c c] along axis 0 (nerad.py:182)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.repeat(x, count, axis=0), tree
    )


def tslice(tree, sl):
    return jax.tree_util.tree_map(lambda x: x[sl], tree)


def tconcat(trees, axis: int = 0):
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=axis), *trees
    )


def tree_wavefront_size(tree) -> int:
    leaf = jax.tree_util.tree_leaves(tree)[0]
    return leaf.shape[0]
