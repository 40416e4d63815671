"""Batched Möller–Trumbore ray/triangle intersection.

Replaces the OptiX/Embree triangle test (scene.ray_intersect at
/root/reference/path.py:238).  Pure elementwise arithmetic over (..., K) triangle
packets — no divergence, masks carry miss lanes.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import math as m

DET_EPS = 1e-10


def intersect_tri(o, d, tri, t_max):
    """o, d: (..., 3); tri: (..., K, 3, 3); t_max: (...,)

    Returns (t, u, v, hit) each (..., K); missed entries have t = +inf.
    """
    v0 = tri[..., 0, :]
    e1 = tri[..., 1, :] - v0
    e2 = tri[..., 2, :] - v0
    o = o[..., None, :]
    d = d[..., None, :]
    pvec = m.cross(d, e2)
    det = m.dot(e1, pvec)
    inv_det = m.safe_div(jnp.asarray(1.0, det.dtype), det)
    tvec = o - v0
    u = m.dot(tvec, pvec) * inv_det
    qvec = m.cross(tvec, e1)
    v = m.dot(d, qvec) * inv_det
    t = m.dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) > DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
        & (t < t_max[..., None])
    )
    t = jnp.where(hit, t, jnp.inf)
    return t, u, v, hit
