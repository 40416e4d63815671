"""Counter-based RNG: the JAX replacement for Mitsuba's stateful
PCG32 sampler + TEA wavefront seeding (/root/reference/pssmlt.py:73,84-93,
metropolis.py:39).

Design: a *counter-based* hash RNG — u = hash(seed, lane, dim) — so every
sample is a pure function of (seed, lane index, dimension counter).  This is
exactly the role PCG32-per-lane + sample_tea_32 seeding plays in the
reference, but with zero carried state, which keeps `lax.scan`/`while_loop`
bodies free of RNG side-state and makes renders bitwise reproducible under
any sharding (lane index is global).

Two generators:
  * `tea32` — the classic TEA 4-round mix (same family as mi.sample_tea_32).
  * `pcg_hash` — one-round PCG output permutation for cheap decorrelation.
Both are pure uint32 jnp ops: elementwise only, no jax.random key plumbing in the
hot loop.  `jax.random` remains available at the API edges (seeding).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x, U32)


def tea32(v0, v1, rounds: int = 4):
    """TEA block mix of two uint32 streams -> (uint32, uint32).

    Same construction as mi.sample_tea_32 (used for wavefront seeding at
    /root/reference/pssmlt.py:84-93); 4 rounds is the standard GPU-RNG choice.
    """
    v0 = _u32(v0)
    v1 = _u32(v1)
    s = _u32(0)
    for _ in range(rounds):
        s = s + _u32(0x9E3779B9)
        v0 = v0 + (((v1 << 4) + _u32(0xA341316C)) ^ (v1 + s) ^ ((v1 >> 5) + _u32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + _u32(0xAD90777D)) ^ (v0 + s) ^ ((v0 >> 5) + _u32(0x7E95761E)))
    return v0, v1


def pcg_hash(x):
    """PCG output permutation of a uint32 (O'Neill 2014 / Jarzynski-Olano)."""
    x = _u32(x)
    state = x * _u32(747796405) + _u32(2891336453)
    word = ((state >> ((state >> 28) + _u32(4))) ^ state) * _u32(277803737)
    return (word >> 22) ^ word


def uint_to_float01(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits (fp32-exact)."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Sampler:
    """Stateless independent sampler over a wavefront of lanes.

    Fields
      seed: scalar uint32 (render seed, folded with pass index by callers)
      lane: (N,) uint32 global lane indices (pixel*spp + sample)
      dim:  scalar uint32 dimension counter (increments per draw)

    `next_1d` / `next_2d` return (new_sampler, sample) — pure-functional, so
    the sampler threads through `lax.scan` like any other loop state.
    """

    seed: jnp.ndarray
    lane: jnp.ndarray
    dim: jnp.ndarray

    @staticmethod
    def create(seed, n: int | None = None, lane=None):
        if lane is None:
            lane = jnp.arange(n, dtype=U32)
        return Sampler(
            seed=_u32(seed), lane=_u32(lane), dim=jnp.zeros((), U32)
        )

    def _draw_bits(self, offset):
        # Mix (seed, dim+offset) through TEA to get a stream key, then PCG over
        # (stream_key ^ lane-hash) for the per-lane value.  Two hash layers
        # decorrelate lanes and dimensions.
        k0, k1 = tea32(self.seed, self.dim + _u32(offset))
        return pcg_hash(pcg_hash(self.lane ^ k0) + k1)

    def next_1d(self):
        bits = self._draw_bits(0)
        s = dataclasses.replace(self, dim=self.dim + _u32(1))
        return s, uint_to_float01(bits)

    def next_2d(self):
        b0 = self._draw_bits(0)
        b1 = self._draw_bits(1)
        s = dataclasses.replace(self, dim=self.dim + _u32(2))
        return s, jnp.stack(
            [uint_to_float01(b0), uint_to_float01(b1)], axis=-1
        )

    def fork(self, salt: int):
        """Decorrelated sampler for a side-channel (e.g. RR decisions)."""
        k0, _ = tea32(self.seed, _u32(salt) ^ _u32(0xDEADBEEF))
        return dataclasses.replace(self, seed=k0)


def seed_from_int(seed: int):
    return _u32(seed & 0xFFFFFFFF)
