"""Area emitters: evaluation, next-event estimation sampling, MIS pdfs.

Replaces scene.sample_emitter_direction / pdf_emitter_direction / emitter
eval (used by every integrator: /root/reference/path.py:247-292,
path-mis.py:96-117).  Emissive geometry is flattened to a global set of
emissive faces with a power-weighted discrete distribution (scene/types.py
EmitterTable); direction sampling = face pick + uniform triangle point,
converted to solid-angle density.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import warp
from ..core.records import DirectionSample, Ray
from ..scene.types import Scene


def eval_emitter(scene: Scene, si, active=None):
    """Radiance of the emitter at si towards the viewer (si.wi.z > 0 side).

    Mirrors `si.emitter(scene).eval(si)` — area lights emit from their front
    (geometric normal) side only.
    """
    has_em = si.emitter_id >= 0
    if active is not None:
        has_em = has_em & active
    front = si.wi[..., 2] > 0.0
    rad = jnp.take(
        scene.emitters.radiance, jnp.maximum(si.emitter_id, 0), axis=0
    )
    return jnp.where((has_em & front)[:, None], rad, 0.0)


def _dir_to_uv(d):
    """World direction -> equirect (u, v), Y-up: v = theta/pi from +Y,
    u = phi/2pi with phi = atan2(x, -z).  Self-consistent with _uv_to_dir."""
    theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 0], -d[..., 2])
    return phi * (0.5 / m.PI) + 0.5, theta * (1.0 / m.PI), theta


def _uv_to_dir(u, v):
    theta = v * m.PI
    phi = (u - 0.5) * (2.0 * m.PI)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack(
        [st * jnp.sin(phi), ct, -st * jnp.cos(phi)], axis=-1
    ), theta


def _env_bilinear(em, u, v):
    """Bilinear equirect fetch (wrap in u, clamp in v), flat row gathers."""
    he, we = em.env_map.shape[:2]
    x = u * we - 0.5
    y = v * he - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    xi0 = jnp.mod(x0.astype(jnp.int32), we)
    xi1 = jnp.mod(x0.astype(jnp.int32) + 1, we)
    yi0 = jnp.clip(y0.astype(jnp.int32), 0, he - 1)
    yi1 = jnp.clip(y0.astype(jnp.int32) + 1, 0, he - 1)
    flat = em.env_map.reshape(-1, 3)
    c00 = jnp.take(flat, yi0 * we + xi0, axis=0)
    c01 = jnp.take(flat, yi0 * we + xi1, axis=0)
    c10 = jnp.take(flat, yi1 * we + xi0, axis=0)
    c11 = jnp.take(flat, yi1 * we + xi1, axis=0)
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def eval_environment(scene: Scene, active, d=None):
    """Environment radiance for escaped rays (mi `constant`/`envmap`;
    scene.environment() gate at /root/reference/path-mis.py:41).  `d` may be
    omitted for constant environments (the (1,1) map is direction-free)."""
    em = scene.emitters
    env = em.env_radiance
    if em.env_map.shape[:2] == (1, 1) or d is None:
        rgb = env[None, :] * em.env_map[0, 0][None, :]
        return jnp.where(active[:, None], rgb, 0.0)
    u, v, _ = _dir_to_uv(d)
    rgb = _env_bilinear(em, u, v) * env[None, :]
    return jnp.where(active[:, None], rgb, 0.0)


def pdf_environment_direction(scene: Scene, d, active=None):
    """Solid-angle pdf that env-NEE would have sampled direction d,
    *including* the env-vs-area selection probability — for MIS weighting of
    BSDF-sampled rays that escape (path.py loop).  Zero for constant/absent
    environments (those are never NEE-sampled; escape MIS weight stays 1)."""
    em = scene.emitters
    he, we = em.env_map.shape[:2]
    if (he, we) == (1, 1):
        return jnp.zeros(d.shape[:-1], m.Float)
    u, v, theta = _dir_to_uv(d)
    x = jnp.clip((u * we).astype(jnp.int32), 0, we - 1)
    y = jnp.clip((v * he).astype(jnp.int32), 0, he - 1)
    pmf = jnp.take(em.env_dist.weights.reshape(-1), y * we + x)
    pmf = pmf / em.env_dist.total
    # d_omega = 2 pi^2 sin(theta) du dv
    pdf = m.safe_div(
        pmf * (he * we), 2.0 * m.PI * m.PI * jnp.sin(theta)
    ) * em.env_select_p
    if active is not None:
        pdf = jnp.where(active, pdf, 0.0)
    return pdf


def _sample_env_direction(scene: Scene, u2):
    """Importance-sample the equirect map (luminance * sin theta texel dist
    + in-texel jitter).  Returns (d, pdf_sa WITHOUT the selection prob,
    radiance)."""
    em = scene.emitters
    he, we = em.env_map.shape[:2]
    x, y, ux, uy, pmf = em.env_dist.sample_reuse(u2)
    u = (x.astype(m.Float) + ux) / we
    v = (y.astype(m.Float) + uy) / he
    d, theta = _uv_to_dir(u, v)
    pdf_sa = m.safe_div(
        pmf * (he * we), 2.0 * m.PI * m.PI * jnp.sin(theta)
    )
    rad = _env_bilinear(em, u, v) * em.env_radiance[None, :]
    return d, pdf_sa, rad


def sample_emitter_direction(scene: Scene, si_ref, u2, test_visibility=True,
                             active=None):
    """NEE: sample a direction towards an emitter from si_ref.

    When the scene has a textured environment map, NEE is a mixture: with
    probability env_select_p importance-sample the equirect map, else a
    power-weighted area-light face.  The reported pdf includes the selection
    probability (the two techniques are MIS-combined independently against
    BSDF sampling — unbiased per-technique weighting).

    Returns (DirectionSample, weight = Le * visibility / pdf)."""
    from ..intersect import ray_test

    em = scene.emitters
    n = si_ref.p.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)

    has_env = em.env_map.shape[:2] != (1, 1)
    if has_env:
        # split u2[...,0] into (selection bit, fresh uniform)
        p_env = em.env_select_p
        sel_env = u2[..., 0] < p_env
        u0 = jnp.where(
            sel_env,
            m.safe_div(u2[..., 0], p_env),
            m.safe_div(u2[..., 0] - p_env, 1.0 - p_env),
        )
        u0 = jnp.clip(u0, 0.0, 1.0 - 1e-7)
    else:
        sel_env = jnp.zeros((n,), bool)
        u0 = u2[..., 0]

    # pick emissive face (power-weighted); ONE packed row gather then
    # fetches triangle, area, prob, CDF bin, and emitter id together
    # (em_face_packed — the take() chain it replaces was 4 dependent
    # gathers deep).  u-reuse rescales within the CDF bin exactly as
    # DiscreteDistribution.sample_reuse.
    slot = em.face_dist.sample(u0)
    row = jnp.take(em.em_face_packed, slot, axis=0)      # (N, 16)
    lo, hi = row[:, 11], row[:, 12]
    u_re = jnp.clip(
        m.safe_div(u0 * em.face_dist.total - lo, hi - lo), 0.0, 1.0 - 1e-7
    )
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]

    b = warp.square_to_uniform_triangle(
        jnp.stack([u_re, u2[..., 1]], axis=-1)
    )
    p = v0 + e1 * b[..., 0:1] + e2 * b[..., 1:2]
    ng = m.normalize(m.cross(e1, e2))

    d_un = p - si_ref.p
    dist2 = m.squared_norm(d_un)
    dist = jnp.sqrt(dist2)
    d = d_un * m.safe_rcp(dist)[..., None]

    cos_l = m.dot(ng, -d)          # emitter front side faces the receiver
    area = row[:, 9]
    pmf = row[:, 10]
    pdf_sa = m.safe_div(pmf * dist2, cos_l * area)
    valid = active & (cos_l > 0.0) & (dist2 > 0.0) & (pdf_sa > 0.0)

    em_id = jax.lax.bitcast_convert_type(row[:, 13], jnp.int32)
    rad = jnp.take(em.radiance, em_id, axis=0)

    if has_env:
        d_env, pdf_env, rad_env = _sample_env_direction(
            scene, jnp.stack([u0, u2[..., 1]], axis=-1)
        )
        valid_env = active & (pdf_env > 0.0)
        pdf_sa = jnp.where(
            sel_env, pdf_env * p_env, pdf_sa * (1.0 - p_env)
        )
        valid = jnp.where(sel_env, valid_env, valid)
        d = jnp.where(sel_env[:, None], d_env, d)
        rad = jnp.where(sel_env[:, None], rad_env, rad)
        far = 2.0 * _scene_radius(scene)
        p = jnp.where(sel_env[:, None], si_ref.p + d * far, p)
        ng = jnp.where(sel_env[:, None], -d, ng)
        dist = jnp.where(sel_env, far, dist)
        em_id = jnp.where(sel_env, -2, em_id)   # -2 = environment

    weight = jnp.where(
        valid[:, None], rad * m.safe_rcp(pdf_sa)[:, None], 0.0
    )

    if test_visibility:
        shadow_ray = si_ref.spawn_ray_to(p)
        occluded = ray_test(scene, shadow_ray, valid)
        valid &= ~occluded
        weight = jnp.where(valid[:, None], weight, 0.0)

    ds = DirectionSample(
        p=p,
        n=ng,
        d=d,
        dist=dist,
        pdf=jnp.where(valid, pdf_sa, 0.0),
        delta=jnp.zeros((n,), bool),
        emitter_id=jnp.where(valid, em_id, -1),
    )
    return ds, weight


def _scene_radius(scene: Scene):
    """Conservative world-bounding radius (distance for env shadow rays)."""
    v = scene.geometry.vertices
    return jnp.max(jnp.abs(v)) * 2.0 + 1.0


def sample_emitter_ray(scene: Scene, u_pos2, u_dir2, active=None):
    """Sample a ray leaving an emitter (scene.sample_emitter_ray,
    /root/reference/bdpt02.py:86-88): power-weighted face pick, uniform
    position, cosine-weighted direction about the face normal.

    Returns (ray, weight, emitter_id) with
    weight = Le * pi / p_area  (the cosine direction pdf cancels cos theta).
    """
    em = scene.emitters
    u0 = u_pos2[..., 0]
    slot = em.face_dist.sample(u0)
    row = jnp.take(em.em_face_packed, slot, axis=0)      # (N, 16)
    lo, hi = row[:, 11], row[:, 12]
    u_re = jnp.clip(
        m.safe_div(u0 * em.face_dist.total - lo, hi - lo), 0.0, 1.0 - 1e-7
    )
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    b = warp.square_to_uniform_triangle(
        jnp.stack([u_re, u_pos2[..., 1]], axis=-1)
    )
    p = v0 + e1 * b[..., 0:1] + e2 * b[..., 1:2]
    ng = m.normalize(m.cross(e1, e2))

    d_local = warp.square_to_cosine_hemisphere(u_dir2)
    s, t = m.coordinate_system(ng)
    d = m.to_world(s, t, ng, d_local)

    area = row[:, 9]
    pmf = row[:, 10]
    p_area = m.safe_div(pmf, area)
    em_id = jax.lax.bitcast_convert_type(row[:, 13], jnp.int32)
    rad = jnp.take(em.radiance, em_id, axis=0)
    weight = rad * (m.PI * m.safe_rcp(p_area))[:, None]

    o = p + ng * m.RAY_EPS
    ray = Ray.make(o, d)
    return ray, weight, em_id


def pdf_emitter_direction_packed(scene: Scene, si_ref, si_hit, em_pmf,
                                 em_area, active=None):
    """pdf_emitter_direction computed from the NEE-pdf columns folded into
    the face row (_make_si(return_row=True): row[:, 27] = pmf, [28] = area)
    — identical floats to the EmitterTable path, but ZERO extra large-table
    gathers (face_to_slot is (F,)-sized).  Used by the persistent transition and the replay
    bounce; other integrators keep the table path."""
    em = scene.emitters
    has = (si_hit.prim_idx >= 0) & (si_hit.emitter_id >= 0) & (em_pmf > 0.0)
    if active is not None:
        has = has & active
    d_un = si_hit.p - si_ref.p
    dist2 = m.squared_norm(d_un)
    d = d_un * m.jax_rsqrt_safe(dist2)[..., None]
    cos_l = m.dot(si_hit.n, -d)
    pdf = m.safe_div(em_pmf * dist2, cos_l * em_area)
    if em.env_map.shape[:2] != (1, 1):
        pdf = pdf * (1.0 - em.env_select_p)   # NEE technique-selection prob
    return jnp.where(has & (cos_l > 0.0), pdf, 0.0)


def pdf_emitter_direction(scene: Scene, si_ref, si_hit, active=None):
    """Solid-angle pdf that NEE from si_ref would have sampled the emissive
    face hit at si_hit (for MIS of BSDF-sampled rays, path.py:288)."""
    em = scene.emitters
    slot = jnp.take(em.face_to_slot, jnp.maximum(si_hit.prim_idx, 0))
    has = (si_hit.prim_idx >= 0) & (slot >= 0)
    if active is not None:
        has = has & active
    slot_s = jnp.maximum(slot, 0)

    d_un = si_hit.p - si_ref.p
    dist2 = m.squared_norm(d_un)
    d = d_un * m.jax_rsqrt_safe(dist2)[..., None]
    cos_l = m.dot(si_hit.n, -d)
    row = jnp.take(em.em_face_packed, slot_s, axis=0)
    area, pmf = row[:, 9], row[:, 10]
    pdf = m.safe_div(pmf * dist2, cos_l * area)
    if em.env_map.shape[:2] != (1, 1):
        pdf = pdf * (1.0 - em.env_select_p)   # NEE technique-selection prob
    return jnp.where(has & (cos_l > 0.0), pdf, 0.0)
