"""Discrete distributions: cumsum CDF + searchsorted sampling.

JAX analog of mi.DiscreteDistribution (shape-area emitter CDF at
/root/reference/nerad.py:289-295) and mi.DiscreteDistribution2D (image-target
sampling at normflow.py:191-215).  Build is a jnp.cumsum; sampling is a
vectorized binary search (jnp.searchsorted), both XLA-friendly.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import math as m
from .struct import jstruct


@jstruct
class DiscreteDistribution:
    pmf: jnp.ndarray   # (K,) nonnegative weights (unnormalized)
    cdf: jnp.ndarray   # (K,) inclusive cumsum, cdf[-1] == total
    total: jnp.ndarray  # () sum of weights

    @staticmethod
    def create(weights):
        weights = jnp.asarray(weights, m.Float)
        cdf = jnp.cumsum(weights)
        return DiscreteDistribution(pmf=weights, cdf=cdf, total=cdf[-1])

    def prob(self, idx):
        return jnp.take(self.pmf, idx) / self.total

    def sample(self, u):
        """u in [0,1) -> index, via binary search on the CDF."""
        x = u * self.total
        idx = jnp.searchsorted(self.cdf, x, side="right")
        return jnp.clip(idx, 0, self.pmf.shape[0] - 1).astype(jnp.int32)

    def sample_reuse(self, u):
        """Sample an index and rescale u to a fresh uniform within the bin
        (mi.DiscreteDistribution.sample_reuse) — saves RNG dimensions."""
        idx = self.sample(u)
        lo = jnp.where(idx > 0, jnp.take(self.cdf, idx - 1), 0.0)
        hi = jnp.take(self.cdf, idx)
        u2 = m.safe_div(u * self.total - lo, hi - lo)
        return idx, jnp.clip(u2, 0.0, 1.0 - 1e-7)


@jstruct
class DiscreteDistribution2D:
    """Row-major 2-D discrete distribution over an (H, W) weight image."""

    weights: jnp.ndarray    # (H, W)
    row_cdf: jnp.ndarray    # (H,)
    col_cdf: jnp.ndarray    # (H, W)
    total: jnp.ndarray      # ()

    @staticmethod
    def create(image):
        image = jnp.asarray(image, m.Float)
        row_sum = jnp.sum(image, axis=1)
        row_cdf = jnp.cumsum(row_sum)
        col_cdf = jnp.cumsum(image, axis=1)
        return DiscreteDistribution2D(
            weights=image, row_cdf=row_cdf, col_cdf=col_cdf,
            total=row_cdf[-1],
        )

    def sample(self, u2):
        """u2: (..., 2) -> (x, y) integer coords + pmf value."""
        h, w = self.weights.shape
        y = jnp.clip(
            jnp.searchsorted(self.row_cdf, u2[..., 1] * self.total, side="right"),
            0, h - 1,
        )
        row = jnp.take(self.col_cdf, y, axis=0)          # (..., W)
        row_total = row[..., -1]
        x = jnp.clip(
            jnp.searchsorted_vec(row, u2[..., 0] * row_total)
            if hasattr(jnp, "searchsorted_vec")
            else _row_searchsorted(row, u2[..., 0] * row_total),
            0, w - 1,
        )
        pmf = jnp.take(self.weights.reshape(-1), y * w + x) / self.total
        return x.astype(jnp.int32), y.astype(jnp.int32), pmf

    def sample_reuse(self, u2):
        """Sample (x, y) and rescale both uniforms to fresh uniforms within
        the chosen texel (the 2-D analog of DiscreteDistribution.sample_reuse)
        — gives sub-texel jitter for continuous equirect sampling without
        extra RNG dimensions."""
        h, w = self.weights.shape
        ty = u2[..., 1] * self.total
        y = jnp.clip(
            jnp.searchsorted(self.row_cdf, ty, side="right"), 0, h - 1
        ).astype(jnp.int32)
        row_lo = jnp.where(y > 0, jnp.take(self.row_cdf, y - 1), 0.0)
        row_hi = jnp.take(self.row_cdf, y)
        uy = jnp.clip(
            m.safe_div(ty - row_lo, row_hi - row_lo), 0.0, 1.0 - 1e-7
        )

        row = jnp.take(self.col_cdf, y, axis=0)          # (..., W)
        tx = u2[..., 0] * row[..., -1]
        x = jnp.clip(
            _row_searchsorted(row, tx), 0, w - 1
        ).astype(jnp.int32)
        flat_cdf = self.col_cdf.reshape(-1)   # flat (N,)-index gathers,
        col_lo = jnp.where(                   # not take_along_axis
            x > 0,
            jnp.take(flat_cdf, y * w + jnp.maximum(x - 1, 0)),
            0.0,
        )
        col_hi = jnp.take(flat_cdf, y * w + x)
        ux = jnp.clip(
            m.safe_div(tx - col_lo, col_hi - col_lo), 0.0, 1.0 - 1e-7
        )
        pmf = jnp.take(self.weights.reshape(-1), y * w + x) / self.total
        return x, y, ux, uy, pmf


def _row_searchsorted(rows, vals):
    """Vectorized per-row searchsorted: rows (..., W) sorted, vals (...,)."""
    return jnp.sum(rows <= vals[..., None], axis=-1)
