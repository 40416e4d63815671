"""ReSTIR GI: streaming reservoir resampling with temporal reprojection and
spatial reuse.

JAX re-design of /root/reference/restirgi.py (RestirSample
:106-115, RestirReservoir.update/merge :118-148, render :182-259,
sample_initial :412-457, temporal_resampling :365-410, spatial_resampling
:274-363, RTXDI-style Jacobian :42-53, bias correction :336-350).

Differences from the reference are purely structural: the cross-frame state
(reservoirs, previous-frame samples, search radius, previous camera) lives in
an explicit `RestirState` pytree threaded through a jitted `render_frame`
step (donate-friendly) instead of Python object attributes; reservoir
update/merge are pure functions over pytrees; the 9 spatial taps unroll
statically.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import warp
from ..core.records import Ray
from ..core.rng import Sampler
from ..core.struct import jstruct, tgather, twhere, tzeros_like
from ..intersect import ray_intersect, ray_test
from ..render import bsdf as bsdflib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter
from .common import register_integrator
from .path import PathIntegrator


@jstruct
class RestirSample:
    x_v: jnp.ndarray   # (N, 3) visible point
    n_v: jnp.ndarray   # (N, 3) visible normal
    x_s: jnp.ndarray   # (N, 3) sample (second-bounce) point
    n_s: jnp.ndarray   # (N, 3) sample normal
    L_o: jnp.ndarray   # (N, 3) outgoing radiance at x_s towards x_v
    p_q: jnp.ndarray   # (N,) source pdf of the initial direction
    valid: jnp.ndarray  # (N,) bool

    @staticmethod
    def zeros(n):
        z3 = jnp.zeros((n, 3), m.Float)
        return RestirSample(
            x_v=z3, n_v=z3, x_s=z3, n_s=z3, L_o=z3,
            p_q=jnp.zeros((n,), m.Float), valid=jnp.zeros((n,), bool),
        )


@jstruct
class RestirReservoir:
    z: RestirSample
    w: jnp.ndarray   # (N,) weight sum
    W: jnp.ndarray   # (N,) contribution weight
    M: jnp.ndarray   # (N,) uint32 stream length

    @staticmethod
    def zeros(n):
        return RestirReservoir(
            z=RestirSample.zeros(n),
            w=jnp.zeros((n,), m.Float),
            W=jnp.zeros((n,), m.Float),
            M=jnp.zeros((n,), jnp.uint32),
        )


def p_hat(L):
    return m.norm(L)


def reservoir_update(res, sampler, snew, wnew, active):
    """Streaming reservoir update (restirgi.py:125-140), functional."""
    wnew = jnp.where(active, wnew, 0.0)
    w = res.w + wnew
    M = res.M + jnp.where(active, 1, 0).astype(jnp.uint32)
    sampler, u = sampler.next_1d()
    take = active & (u < m.safe_div(wnew, w))
    z = twhere(take, snew, res.z)
    return dataclasses.replace(res, z=z, w=w, M=M), sampler


def reservoir_merge(res, sampler, other, phat, active):
    """Merge reservoir `other` weighted by phat (restirgi.py:142-148)."""
    M0 = res.M
    res, sampler = reservoir_update(
        res, sampler, other.z, phat * other.W * other.M.astype(m.Float), active
    )
    M = jnp.where(active, M0 + other.M, M0)
    return dataclasses.replace(res, M=M), sampler


def jacobian_J(receiver_pos, neighbor_res):
    """Solid-angle reuse Jacobian (restirgi.py:42-53)."""
    v_new = receiver_pos - neighbor_res.z.x_s
    d_new = m.norm(v_new)
    cos_new = jnp.clip(m.safe_div(m.dot(v_new, neighbor_res.z.n_s), d_new), 0, 1)
    v_old = neighbor_res.z.x_v - neighbor_res.z.x_s
    d_old = m.norm(v_old)
    cos_old = jnp.clip(m.safe_div(m.dot(v_old, neighbor_res.z.n_s), d_old), 0, 1)
    div = cos_old * d_new * d_new
    jac = jnp.where(div > 0, cos_new * d_old * d_old / jnp.maximum(div, 1e-20), 0.0)
    return jnp.where(jnp.isfinite(jac), jac, 0.0)


@jstruct
class RestirState:
    temporal: RestirReservoir
    spatial: RestirReservoir
    search_radius: jnp.ndarray     # (N,)
    prev_sample: RestirSample
    prev_to_world: jnp.ndarray     # (4, 4) previous camera
    frame: jnp.ndarray             # () int32


@dataclasses.dataclass(frozen=True)
class RestirGI:
    """props mirror restirgi.py:155-166."""

    max_depth: int = 8
    rr_depth: int = 2
    bias_correction: bool = True
    jacobian: bool = True
    bsdf_sampling: bool = True
    max_M_temporal: int | None = 30
    max_M_spatial: int | None = 500
    initial_search_radius: float = 10.0
    minimal_search_radius: float = 3.0
    spatial_spatial_reuse: bool = False
    dist_threshold: float = 0.1
    angle_threshold: float = 25.0 * 3.14159265 / 180.0
    n_spatial_taps: int = 9  # 9 in the reference loop (restirgi.py:301)
    # Reference behavior (restirgi.py:301-307) taps only random neighbors;
    # the guaranteed self-tap (spatial_resampling tap 0) is this repo's
    # documented improvement for low-res similarity-gate starvation.  Off by
    # default so A/B parity runs match the reference; enable explicitly.
    include_self_tap: bool = False

    # ------------------------------------------------------------------
    def init_state(self, scene) -> RestirState:
        w, h = scene.camera.resolution
        n = w * h
        return RestirState(
            temporal=RestirReservoir.zeros(n),
            spatial=RestirReservoir.zeros(n),
            search_radius=jnp.full((n,), self.initial_search_radius, m.Float),
            prev_sample=RestirSample.zeros(n),
            prev_to_world=scene.camera.to_world,
            frame=jnp.zeros((), jnp.int32),
        )

    def similar(self, s1, s2):
        dist = m.norm(s1.x_v - s2.x_v)
        ok = dist < self.dist_threshold
        ok &= m.dot(s1.n_v, s2.n_v) > jnp.cos(self.angle_threshold)
        return ok

    # ------------------------------------------------------------------
    def sample_initial(self, scene, sampler, pos_film):
        """restirgi.py:412-457: primary hit + one sampled bounce + path L_o."""
        ray = sensorlib.sample_ray(scene.camera, pos_film)
        si = ray_intersect(scene, ray)
        emittance = eval_emitter(scene, si)

        sampler, u1 = sampler.next_1d()
        sampler, u2 = sampler.next_2d()
        if self.bsdf_sampling:
            bs, _ = bsdflib.sample(
                scene.materials, scene.textures, si, u1, u2, si.valid
            )
            wo, pdf = bs.wo, bs.pdf
        else:
            wo = warp.square_to_uniform_hemisphere(u2)
            pdf = warp.square_to_uniform_hemisphere_pdf(wo)

        ray2 = si.spawn_ray(si.to_world(wo))
        inner = PathIntegrator(
            max_depth=self.max_depth, rr_depth=self.rr_depth
        )
        L_o, _, sampler = inner.sample(
            scene, sampler, ray2, active=si.valid & (pdf > 0)
        )
        si2 = ray_intersect(scene, ray2, si.valid)

        S = RestirSample(
            x_v=si.p, n_v=si.n, x_s=si2.p, n_s=si2.n,
            L_o=L_o, p_q=pdf, valid=si.valid,
        )
        return S, si, emittance, sampler

    # ------------------------------------------------------------------
    def temporal_resampling(self, scene, prev_sample, temporal_prev,
                            prev_to_world, frame, sampler, S):
        """restirgi.py:365-410.

        `prev_sample` is the FULL previous-frame sample buffer (gathered at
        the reprojected pixel); `temporal_prev` / `S` are this chunk's lanes
        (the reference reads the temporal reservoir at the current lane,
        restirgi.py:388)."""
        w, h = scene.camera.resolution
        prev_cam = dataclasses.replace(
            scene.camera, to_world=prev_to_world
        )
        pos_prev, _, vis = sensorlib.sample_direction(prev_cam, S.x_v)
        idx = self.to_idx(pos_prev, w, h)
        Sprev = tgather(prev_sample, idx)
        valid = vis & self.similar(S, Sprev) & (frame > 0)

        zero_r = RestirReservoir.zeros(S.p_q.shape[0])
        R = twhere(valid, temporal_prev, zero_r)

        Rnew = zero_r
        phat_s = p_hat(S.L_o)
        w_s = jnp.where(S.p_q > 0, m.safe_div(phat_s, S.p_q), 0.0)
        Rnew, sampler = reservoir_update(
            Rnew, sampler, S, w_s, jnp.ones_like(valid)
        )
        Rnew, sampler = reservoir_merge(
            Rnew, sampler, R, p_hat(R.z.L_o), jnp.ones_like(valid)
        )
        phat = p_hat(Rnew.z.L_o)
        W = jnp.where(
            phat * Rnew.M > 0,
            m.safe_div(Rnew.w, Rnew.M.astype(m.Float) * phat),
            0.0,
        )
        M = Rnew.M
        if self.max_M_temporal is not None:
            M = jnp.minimum(M, jnp.uint32(self.max_M_temporal))
        return dataclasses.replace(Rnew, W=W, M=M), sampler

    @staticmethod
    def to_idx(pos, w, h):
        x = jnp.clip(pos[..., 0].astype(jnp.int32), 0, w - 1)
        y = jnp.clip(pos[..., 1].astype(jnp.int32), 0, h - 1)
        return y * w + x

    # ------------------------------------------------------------------
    def spatial_resampling(self, scene, S_full, temporal_full, spatial_prev,
                           search_radius, sampler, S, pos_pix):
        """restirgi.py:274-363 (9 unrolled taps, adaptive radius, bias Z).

        Neighbor taps gather from the FULL current-frame buffers (`S_full`,
        `temporal_full`); `spatial_prev`/`search_radius`/`S`/`pos_pix` are
        this chunk's lanes."""
        w, h = scene.camera.resolution
        n = S.p_q.shape[0]
        Rs = spatial_prev
        Rnew = RestirReservoir.zeros(n)
        Z = jnp.zeros((n,), jnp.uint32)

        if self.spatial_spatial_reuse:
            Rnew, sampler = reservoir_merge(
                Rnew, sampler, Rs, p_hat(Rs.z.L_o), jnp.ones((n,), bool)
            )
            Z = Z + Rs.M

        if self.max_M_spatial is not None:
            max_iter = jnp.where(
                Rs.M < self.max_M_spatial / 2, self.n_spatial_taps, 3
            )
        else:
            max_iter = jnp.full((n,), self.n_spatial_taps, jnp.int32)

        any_reused = jnp.zeros((n,), bool)
        taps = []  # (M, p, n, active) per tap for bias correction

        # tap 0 is the pixel's own temporal reservoir (offset 0).  The
        # reference only taps random neighbors (restirgi.py:301-307), which
        # starves pixels whose neighborhood fails the similarity gate (the
        # world-space dist_threshold makes that common at low resolutions);
        # a guaranteed self-tap removes that failure mode and is otherwise
        # statistically identical — it flows through the same merge and
        # bias-correction Z accounting as every other tap.
        for s in range(self.n_spatial_taps + self.include_self_tap):
            if self.include_self_tap and s == 0:
                active = jnp.ones((n,), bool)
                offset = jnp.zeros((n, 2), m.Float)
            else:
                active = jnp.asarray(s, jnp.int32) < max_iter
                sampler, u2 = sampler.next_2d()
                offset = warp.square_to_uniform_disk_concentric(u2) * (
                    search_radius[:, None]
                )
            p = pos_pix + offset
            idx = self.to_idx(p, w, h)
            qn = tgather(S_full, idx)
            active &= self.similar(qn, S)
            Rn = tgather(temporal_full, idx)
            Rn = twhere(active, Rn, RestirReservoir.zeros(n))

            # visibility of the neighbor's sample point from our visible point
            shadow_ray = _spawn_to(S.x_v, S.n_v, Rn.z.x_s)
            shadowed = ray_test(scene, shadow_ray, active)

            jac = jnp.clip(jacobian_J(S.x_v, Rn), 0.0, 1000.0) if self.jacobian else 1.0
            phat_n = jnp.where(
                (~active) | shadowed, 0.0, p_hat(Rn.z.L_o) * jac
            )
            Rnew, sampler = reservoir_merge(Rnew, sampler, Rn, phat_n, active)
            taps.append((Rn.M, Rn.z.x_v, Rn.z.n_v, active))
            any_reused |= active

        phat = p_hat(Rnew.z.L_o)
        if self.bias_correction:
            for M_i, p_i, n_i, act_i in taps:
                ray = _spawn_to(Rnew.z.x_s, Rnew.z.n_s, p_i)
                unshadowed = ~ray_test(scene, ray, act_i)
                Z = Z + jnp.where(act_i & unshadowed, M_i, 0).astype(jnp.uint32)
            W = jnp.where(
                Z.astype(m.Float) * phat > 0,
                m.safe_div(Rnew.w, Z.astype(m.Float) * phat),
                0.0,
            )
        else:
            W = jnp.where(
                phat * Rnew.M > 0,
                m.safe_div(Rnew.w, Rnew.M.astype(m.Float) * phat),
                0.0,
            )
        search_radius = jnp.maximum(
            jnp.where(any_reused, search_radius, search_radius / 2),
            self.minimal_search_radius,
        )
        M = Rnew.M
        if self.max_M_spatial is not None:
            M = jnp.minimum(M, jnp.uint32(self.max_M_spatial))
        return dataclasses.replace(Rnew, W=W, M=M), search_radius, sampler

    # ------------------------------------------------------------------
    # -------- per-chunk stage programs (pix = chunk of pixel lanes) ------
    def stage_initial(self, scene, seed, pix):
        px = (pix % scene.camera.resolution[0]).astype(m.Float)
        py = (pix // scene.camera.resolution[0]).astype(m.Float)
        sampler = Sampler.create(seed, lane=pix).fork(1)
        sampler, jitter = sampler.next_2d()
        pos_film = jnp.stack([px, py], axis=-1) + jitter
        S, si_v, emittance, _ = self.sample_initial(scene, sampler, pos_film)
        return S, si_v, emittance

    def stage_temporal(self, scene, state_chunk_and_full, seed, pix, S):
        prev_sample_full, temporal_prev, prev_to_world, frame = (
            state_chunk_and_full
        )
        sampler = Sampler.create(seed, lane=pix).fork(2)
        temporal, _ = self.temporal_resampling(
            scene, prev_sample_full, temporal_prev, prev_to_world, frame,
            sampler, S,
        )
        return temporal

    def stage_spatial(self, scene, S_full, temporal_full, spatial_prev,
                      search_radius, seed, pix, S):
        w = scene.camera.resolution[0]
        px = (pix % w).astype(m.Float)
        py = (pix // w).astype(m.Float)
        pos_pix = jnp.stack([px, py], axis=-1)
        sampler = Sampler.create(seed, lane=pix).fork(3)
        return self.spatial_resampling(
            scene, S_full, temporal_full, spatial_prev, search_radius,
            sampler, S, pos_pix,
        )[:2]

    @staticmethod
    def stage_shade(scene, spatial, si_v, emittance):
        """final shading (restirgi.py:261-272)"""
        R = spatial
        dir_to_s = m.normalize(R.z.x_s - si_v.p)
        f_val, _ = bsdflib.eval_pdf(
            scene.materials, scene.textures, si_v, si_v.to_local(dir_to_s),
            si_v.valid,
        )
        result = f_val * R.z.L_o * R.W[:, None] + emittance
        return jnp.where(jnp.isfinite(result), result, 0.0)

    def render_frame(self, scene, state: RestirState, seed):
        """One full ReSTIR frame (restirgi.py:182-259); returns (img, state')."""
        w, h = scene.camera.resolution
        n = w * h
        pix = jnp.arange(n, dtype=jnp.uint32)
        S, si_v, emittance = self.stage_initial(scene, seed, pix)
        temporal = self.stage_temporal(
            scene,
            (state.prev_sample, state.temporal, state.prev_to_world,
             state.frame),
            seed, pix, S,
        )
        spatial, search_radius = self.stage_spatial(
            scene, S, temporal, state.spatial, state.search_radius,
            seed, pix, S,
        )
        img = self.stage_shade(scene, spatial, si_v, emittance).reshape(
            h, w, 3
        )
        new_state = RestirState(
            temporal=temporal,
            spatial=spatial,
            search_radius=search_radius,
            prev_sample=S,
            prev_to_world=scene.camera.to_world,
            frame=state.frame + 1,
        )
        return img, new_state

    def render_frame_chunked(self, scene, state: RestirState, seed,
                             chunk: int = 32768):
        """Stage-banded frame for resolutions whose whole-frame program is
        too large for one launch: each stage runs as fixed-size pixel-band launches with full-frame buffers
        as gather inputs, with host barriers between stages (the dr.eval
        barriers of restirgi.py:232,236,238).  Stage RNG streams are keyed
        by (pixel, stage), not by band, so both paths draw identical
        samples and agree to XLA float-contraction noise."""
        w, h = scene.camera.resolution
        n = w * h
        chunk = min(chunk, n)
        seed = jnp.uint32(seed)

        def bands(stage_fn):
            outs = []
            for off in range(0, n, chunk):
                idx = jnp.arange(off, off + chunk, dtype=jnp.uint32)
                idx = jnp.minimum(idx, jnp.uint32(n - 1))  # pad tail band
                outs.append(stage_fn(idx, off))
            return jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0)[:n], *outs
            )

        S, si_v, emittance = bands(
            lambda idx, off: _stage_initial_jit(self, scene, seed, idx)
        )

        def pad_band(tree, off):
            """slice [off, off+chunk) with tail clamped to the last lane"""
            idx = jnp.minimum(
                jnp.arange(off, off + chunk, dtype=jnp.uint32),
                jnp.uint32(n - 1),
            )
            return tgather(tree, idx)

        temporal = bands(
            lambda idx, off: _stage_temporal_jit(
                self, scene, state.prev_sample, pad_band(state.temporal, off),
                state.prev_to_world, state.frame, seed, idx,
                pad_band(S, off),
            )
        )

        spatial, search_radius = bands(
            lambda idx, off: _stage_spatial_jit(
                self, scene, S, temporal, pad_band(state.spatial, off),
                pad_band(state.search_radius, off), seed, idx,
                pad_band(S, off),
            )
        )

        img = bands(
            lambda idx, off: _stage_shade_jit(
                scene, pad_band(spatial, off), pad_band(si_v, off),
                pad_band(emittance, off),
            )
        ).reshape(h, w, 3)

        new_state = RestirState(
            temporal=temporal,
            spatial=spatial,
            search_radius=search_radius,
            prev_sample=S,
            prev_to_world=scene.camera.to_world,
            frame=state.frame + 1,
        )
        return img, new_state


# stable module-level jitted stage programs for the chunked frame (a jit
# created inside render_frame_chunked would retrace every frame)
@partial(jax.jit, static_argnames=("integ",))
def _stage_initial_jit(integ, scene, seed, pix):
    return integ.stage_initial(scene, seed, pix)


@partial(jax.jit, static_argnames=("integ",))
def _stage_temporal_jit(integ, scene, prev_sample, temporal_prev,
                        prev_to_world, frame, seed, pix, S):
    return integ.stage_temporal(
        scene, (prev_sample, temporal_prev, prev_to_world, frame), seed,
        pix, S,
    )


@partial(jax.jit, static_argnames=("integ",))
def _stage_spatial_jit(integ, scene, S_full, temporal_full, spatial_prev,
                       search_radius, seed, pix, S):
    return integ.stage_spatial(
        scene, S_full, temporal_full, spatial_prev, search_radius, seed,
        pix, S,
    )


@jax.jit
def _stage_shade_jit(scene, spatial, si_v, emittance):
    return RestirGI.stage_shade(scene, spatial, si_v, emittance)


def _spawn_to(p, n_vec, target):
    d = target - p
    dist = m.norm(d)
    d = d * m.safe_rcp(dist)[:, None]
    sign = m.sign_not_zero(m.dot(n_vec, d))
    o = p + n_vec * (sign * m.RAY_EPS)[:, None]
    return Ray(o=o, d=d, maxt=dist * (1.0 - 1e-3) - m.RAY_EPS)


register_integrator("restirgi", RestirGI)
