"""Perspective sensor: camera ray generation + world->film projection.

Replaces mi.Sensor.sample_ray_differential (/root/reference/path.py:60) and
sample_direction reprojection (/root/reference/restirgi.py:374-378,
reproject.py:9-21).  Mitsuba camera convention: local +Z = viewing direction,
+Y = up, +X = left; fov measured on the x axis unless fov_axis says otherwise
(handled at scene compile, scene/build.py)."""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.records import Ray
from ..scene.types import Camera


def sample_ray(camera: Camera, pos_film, active=None) -> Ray:
    """pos_film: (N, 2) continuous pixel coordinates in [0,W)x[0,H).

    Returns world-space rays through those film positions."""
    w, h = camera.resolution
    sx = pos_film[..., 0] / w
    sy = pos_film[..., 1] / h
    # film x to the right => camera-local -x (Mitsuba's +X points left);
    # film y down => camera-local -y.
    d_cam = m.vec3(
        (1.0 - 2.0 * sx) * camera.tan_half_fov[0],
        (1.0 - 2.0 * sy) * camera.tan_half_fov[1],
        jnp.ones_like(sx),
    )
    d_world = m.normalize(m.transform_vector(camera.to_world, d_cam))
    o = jnp.broadcast_to(camera.to_world[:3, 3], d_world.shape)
    return Ray.make(o, d_world)


def perspective_projection(camera: Camera, near: float = 0.01,
                           far: float = 1000.0):
    """World -> clip-space 4x4 matrix (mi.perspective_projection analog,
    /root/reference/reproject.py:9-21): maps world points to NDC where
    x,y in [0,1] cover the film."""
    tx, ty = camera.tan_half_fov[0], camera.tan_half_fov[1]
    # camera space -> NDC: x_ndc = 0.5 (1 - x/(z tx)), same for y
    proj = jnp.array(
        [
            [-0.5, 0.0, 0.5, 0.0],
            [0.0, -0.5, 0.5, 0.0],
            [0.0, 0.0, far / (far - near), -near * far / (far - near)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        m.Float,
    )
    scale = jnp.diag(jnp.array([1.0 / tx, 1.0 / ty, 1.0, 1.0], m.Float))
    world_to_cam = jnp.linalg.inv(camera.to_world)
    hi = jax.lax.Precision.HIGHEST  # no TF32: see core/math.py transforms
    return jnp.matmul(jnp.matmul(proj, scale, precision=hi), world_to_cam,
                      precision=hi)


def sample_direction(camera: Camera, p_world):
    """Project world points onto the film.

    Returns (pos_film (N,2), dist (N,), valid (N,)) — the reprojection used
    by ReSTIR temporal reuse and PSSMLT splatting."""
    tw = camera.to_world
    R = tw[:3, :3]
    t = tw[:3, 3]
    p_cam = jnp.sum((p_world - t)[..., :, None] * R, axis=-2)  # R^T p
    z = p_cam[..., 2]
    valid = z > 1e-6
    x = m.safe_div(p_cam[..., 0], z)
    y = m.safe_div(p_cam[..., 1], z)
    w, h = camera.resolution
    sx = 0.5 * (1.0 - x / camera.tan_half_fov[0])
    sy = 0.5 * (1.0 - y / camera.tan_half_fov[1])
    pos = jnp.stack([sx * w, sy * h], axis=-1)
    valid &= (sx >= 0.0) & (sx < 1.0) & (sy >= 0.0) & (sy < 1.0)
    dist = m.norm(p_world - t)
    return pos, dist, valid
