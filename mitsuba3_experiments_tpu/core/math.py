"""Vector math, frames and numeric helpers.

JAX replacement for the Dr.Jit array layer's vector types
(``mi.Vector3f``, ``mi.Frame3f``, ``dr.dot`` / ``dr.cross`` / ``dr.normalize``)
used throughout the reference (e.g. /root/reference/path-mis.py:24-155).
Vectors are plain ``jnp`` arrays of shape ``(..., 3)`` — structure-of-arrays
over the wavefront axis, which XLA lays out well for vector units.
"""
from __future__ import annotations

import jax.numpy as jnp

# fp32 everywhere for parity renders (the reference's Dr.Jit variants are fp32);
# bf16 is reserved for the neural components (models/).
Float = jnp.float32

EPS = 1e-6
RAY_EPS = 1e-4          # spawn-ray offset along the normal (shadow-acne guard)
INF = jnp.inf
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
INV_TWO_PI = 1.0 / TWO_PI
INV_FOUR_PI = 1.0 / (4.0 * PI)


def vec3(x, y, z, dtype=Float):
    """Stack three same-shaped arrays into a (..., 3) vector."""
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)],
        axis=-1,
    )


def vec2(x, y, dtype=Float):
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype)], axis=-1
    )


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def abs_dot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def squared_norm(a):
    return jnp.sum(a * a, axis=-1)


def norm(a):
    return jnp.sqrt(squared_norm(a))


def normalize(a):
    return a * jnp.expand_dims(jax_rsqrt_safe(squared_norm(a)), -1)


def jax_rsqrt_safe(x):
    """1/sqrt(x) that returns 0 for x == 0 instead of inf."""
    r = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, 1.0 / jnp.sqrt(r), 0.0)


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_div(a, b, fill=0.0):
    """a/b with `fill` where b == 0 (matches dr.select(b!=0, a/b, 0) idiom)."""
    denom = jnp.where(b != 0, b, 1.0)
    return jnp.where(b != 0, a / denom, fill)


def safe_rcp(x):
    return safe_div(jnp.asarray(1.0, x.dtype), x)


def lerp(a, b, t):
    return a + (b - a) * t


def sign_not_zero(x):
    return jnp.where(x >= 0.0, 1.0, -1.0)


def luminance(rgb):
    """ITU-R BT.709 luminance — mirrors mi.luminance (/root/reference/pssmlt.py:137)."""
    return (
        rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
    )


def max_component(rgb):
    return jnp.max(rgb, axis=-1)


def coordinate_system(n):
    """Build an orthonormal basis (s, t) around unit normal n.

    Branchless Duff et al. 2017 construction — the branch-free analog of
    mi.Frame3f's constructor; no data-dependent control flow.
    Returns (s, t) with s x t = n.
    """
    z = n[..., 2]
    sign = sign_not_zero(z)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = vec3(1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0])
    t = vec3(b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return s, t


def to_local(s, t, n, v_world):
    """World -> frame-local coordinates (mi.Frame3f.to_local)."""
    return vec3(dot(v_world, s), dot(v_world, t), dot(v_world, n))


def to_world(s, t, n, v_local):
    """Frame-local -> world coordinates (mi.Frame3f.to_world)."""
    return (
        s * v_local[..., 0:1] + t * v_local[..., 1:2] + n * v_local[..., 2:3]
    )


# --- Frame-local trig helpers (mi.Frame3f statics) -------------------------

def cos_theta(v):
    return v[..., 2]


def cos2_theta(v):
    return v[..., 2] * v[..., 2]


def abs_cos_theta(v):
    return jnp.abs(v[..., 2])


def sin2_theta(v):
    return jnp.maximum(0.0, 1.0 - cos2_theta(v))


def sin_theta(v):
    return jnp.sqrt(sin2_theta(v))


def tan2_theta(v):
    return safe_div(sin2_theta(v), cos2_theta(v), fill=jnp.inf)


def tan_theta(v):
    return safe_div(sin_theta(v), cos_theta(v), fill=jnp.inf)


def phi(v):
    return jnp.arctan2(v[..., 1], v[..., 0])


def reflect(wi):
    """Specular reflection about the local +z normal: (-x, -y, z)."""
    return vec3(-wi[..., 0], -wi[..., 1], wi[..., 2])


def reflect_about(wi, m):
    """Reflection of wi about arbitrary unit vector m (half-vector)."""
    return 2.0 * jnp.expand_dims(dot(wi, m), -1) * m - wi


def refract(wi, cos_theta_t, eta_ti):
    """Refraction through local +z interface.

    cos_theta_t: cosine of transmitted angle (signed, opposite hemisphere of wi)
    eta_ti: relative IOR (incident / transmitted side) == 1/eta for entry.
    Mirrors mi.refract(wi, cos_theta_t, eta_ti).
    """
    return vec3(
        -eta_ti * wi[..., 0], -eta_ti * wi[..., 1], cos_theta_t
    )


# --- 4x4 homogeneous transforms (mi.Transform4f) ---------------------------

# The 3x3 products are written as elementwise multiply-adds, not einsum:
# XLA may run an f32 dot in TF32 on the GPU (~3 significant digits), and
# camera/instance transforms need full f32.


def transform_point(m, p):
    """Apply 4x4 matrix (broadcastable (...,4,4)) to points (...,3)."""
    return transform_vector(m, p) + m[..., :3, 3]


def transform_vector(m, v):
    return jnp.sum(m[..., :3, :3] * v[..., None, :], axis=-1)


def transform_normal(m, n):
    """Normals transform by the inverse-transpose of the upper 3x3."""
    inv = jnp.linalg.inv(m[..., :3, :3])
    return jnp.sum(inv * n[..., :, None], axis=-2)


def look_at(origin, target, up):
    """Camera-to-world matrix with Mitsuba's convention (+Z = view direction,
    +Y = up, +X = left).  Matches mi.ScalarTransform4f.look_at."""
    import numpy as np

    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    dirv = target - origin
    dirv = dirv / np.linalg.norm(dirv)
    left = np.cross(up / np.linalg.norm(up), dirv)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dirv, left)
    m = np.eye(4)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = dirv
    m[:3, 3] = origin
    return m.astype(np.float32)


def translate(v):
    import numpy as np

    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def scale_mat(v):
    import numpy as np

    v = np.broadcast_to(np.asarray(v, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg):
    """Rotation matrix about `axis` by `angle_deg` degrees (mi.Transform4f.rotate)."""
    import numpy as np

    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    m = np.eye(4)
    m[:3, :3] = R
    return m.astype(np.float32)


def matmul4(*ms):
    import numpy as np

    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ m
    return out


def erfinv(x):
    """Inverse error function (dr.erfinv analog, used by gaussian warps)."""
    import jax.scipy.special as jsp

    return jsp.erfinv(x)
