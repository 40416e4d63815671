"""Warp library: mappings from the unit square to common domains + densities.

JAX port of the Mitsuba warp module exercised by the reference
(mi.warp.square_to_uniform_sphere at /root/reference/pssmlt.py:251,
square_to_uniform_hemisphere at restirgi.py:443-444, square_to_std_normal at
metropolis.py:67, square_to_uniform_disk_concentric, cosine hemisphere inside
the diffuse BSDF).  All maps are branch-free jnp expressions.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import math as m


def square_to_uniform_sphere(u):
    """u: (..., 2) -> unit sphere (..., 3); pdf = 1/(4 pi)."""
    z = 1.0 - 2.0 * u[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    ph = 2.0 * m.PI * u[..., 0]
    return m.vec3(r * jnp.cos(ph), r * jnp.sin(ph), z)


def square_to_uniform_sphere_pdf(v):
    return jnp.full(v.shape[:-1], m.INV_FOUR_PI, v.dtype)


def square_to_uniform_hemisphere(u):
    """Upper (+z) hemisphere; pdf = 1/(2 pi)."""
    z = u[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    ph = 2.0 * m.PI * u[..., 0]
    return m.vec3(r * jnp.cos(ph), r * jnp.sin(ph), z)


def square_to_uniform_hemisphere_pdf(v):
    return jnp.where(v[..., 2] >= 0.0, m.INV_TWO_PI, 0.0)


def square_to_uniform_disk_concentric(u):
    """Concentric (Shirley) disk mapping — low-distortion, branchless select."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quad_x = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(quad_x, x, y)
    rr = jnp.where(quad_x, y, x)
    ph = 0.25 * m.PI * m.safe_div(rr, r)
    ph = jnp.where(quad_x, ph, 0.5 * m.PI - ph)
    ph = jnp.where(is_zero, 0.0, ph)
    return m.vec2(r * jnp.cos(ph), r * jnp.sin(ph))


def square_to_cosine_hemisphere(u):
    """Cosine-weighted +z hemisphere; pdf = cos(theta)/pi."""
    d = square_to_uniform_disk_concentric(u)
    z = m.safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return m.vec3(d[..., 0], d[..., 1], z)


def square_to_cosine_hemisphere_pdf(v):
    return jnp.maximum(v[..., 2], 0.0) * m.INV_PI


def square_to_std_normal(u):
    """Box-Muller: unit square -> 2-D standard normal (normflow.py:73-87)."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(1.0 - u[..., 0], 1e-38)))
    ph = 2.0 * m.PI * u[..., 1]
    return m.vec2(r * jnp.cos(ph), r * jnp.sin(ph))


def square_to_std_normal_pdf(p):
    return jnp.exp(-0.5 * m.squared_norm(p)) * m.INV_TWO_PI


def square_to_uniform_triangle(u):
    """Barycentric warp; returns (b1, b2) with b0 = 1-b1-b2 (sqrt trick)."""
    t = m.safe_sqrt(u[..., 0])
    return m.vec2(1.0 - t, t * u[..., 1])


def interval_to_tent(u):
    """[0,1) -> [-1,1] tent-distributed (used by the tent rfilter importance
    sampling and PSSMLT small-step mutations)."""
    u2 = 2.0 * u - 1.0
    return jnp.where(
        u2 >= 0.0, 1.0 - jnp.sqrt(jnp.maximum(1.0 - u2, 0.0)),
        jnp.sqrt(jnp.maximum(1.0 + u2, 0.0)) - 1.0,
    )


def square_to_ggx(u, alpha):
    """Sample GGX normal distribution (isotropic); returns half-vector (..., 3).
    pdf = D(m) cos(theta_m)."""
    c2 = (1.0 - u[..., 0]) / (u[..., 0] * (alpha * alpha - 1.0) + 1.0)
    cos_t = jnp.sqrt(jnp.clip(c2, 0.0, 1.0))
    sin_t = m.safe_sqrt(1.0 - c2)
    ph = 2.0 * m.PI * u[..., 1]
    return m.vec3(sin_t * jnp.cos(ph), sin_t * jnp.sin(ph), cos_t)
