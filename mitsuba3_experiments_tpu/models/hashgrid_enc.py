"""Multiresolution hash-grid feature encoding (instant-NGP).

JAX replacement for Dr.Jit's HashGridEncoding from the experimental
`coopvec-hashgrid` branch (/root/reference/nerad.py:7-11,66,98): per-level
hashed corner lookup + trilinear interpolation.  The backward pass — the
fp16 scatter-reduce the reference needed a custom drjit-core branch for
(`scatter-reduce-f16x2`) — falls out of JAX AD for free: the transpose of
the gather is XLA's deterministic scatter-add, accumulated in fp32.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 8
    n_features: int = 2
    log2_table_size: int = 15
    base_resolution: int = 16
    finest_resolution: int = 512

    @property
    def out_dim(self):
        return self.n_levels * self.n_features

    def level_resolutions(self):
        if self.n_levels == 1:
            return [self.base_resolution]
        b = math.exp(
            (math.log(self.finest_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1)
        )
        return [
            int(math.floor(self.base_resolution * (b**l)))
            for l in range(self.n_levels)
        ]


def init_hashgrid(key, cfg: HashGridConfig):
    """(L, T, F) fp32 table, U(-1e-4, 1e-4) like instant-NGP."""
    t = 1 << cfg.log2_table_size
    return jax.random.uniform(
        key, (cfg.n_levels, t, cfg.n_features), jnp.float32, -1e-4, 1e-4
    )


def _hash(q, table_size):
    h = (
        (q[..., 0].astype(jnp.uint32) * jnp.uint32(_PRIMES[0]))
        ^ (q[..., 1].astype(jnp.uint32) * jnp.uint32(_PRIMES[1]))
        ^ (q[..., 2].astype(jnp.uint32) * jnp.uint32(_PRIMES[2]))
    )
    return (h & jnp.uint32(table_size - 1)).astype(jnp.int32)


def hashgrid_encode(table, p, cfg: HashGridConfig):
    """p: (N, 3) in [0,1]^3 -> (N, L*F) features, trilinear per level."""
    t = 1 << cfg.log2_table_size
    outs = []
    for lvl, res in enumerate(cfg.level_resolutions()):
        x = p * res
        x0 = jnp.floor(x)
        f = x - x0
        x0 = x0.astype(jnp.int32)
        feat = 0.0
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    corner = x0 + jnp.asarray([cx, cy, cz], jnp.int32)
                    idx = _hash(corner, t)
                    w = (
                        jnp.where(cx, f[..., 0], 1 - f[..., 0])
                        * jnp.where(cy, f[..., 1], 1 - f[..., 1])
                        * jnp.where(cz, f[..., 2], 1 - f[..., 2])
                    )
                    feat = feat + w[..., None] * jnp.take(
                        table[lvl], idx, axis=0
                    )
        outs.append(feat)
    return jnp.concatenate(outs, axis=-1)
