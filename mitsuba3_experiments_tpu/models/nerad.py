"""Neural radiosity: hash-grid + SH-encoded MLP radiance field trained on a
one-bounce residual (LHS = field, RHS = NEE+MIS estimate + field at the next
bounce).

JAX re-design of /root/reference/nerad.py:
  Field (:54-106)          -> hashgrid_encode + sh_eval(order 3) + 4x64 MLP
                              (bf16 matmuls; fp32 master params — the
                              fp16/fp32 AMP + GradScaler of :336-347 is
                              unnecessary in bf16)
  sample_rhs (:174-233)    -> M=32 fan-out via trepeat + block_sum reduction
  next_smooth_si (:123-164)-> fori_loop specular walk
  IntersectionSampler (:275-310) -> area-CDF face pick + sphere directions
  training_step (:363-375) -> value_and_grad + optax.adam
  eval integrator (:235-254)-> field query at first non-delta hit
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import math as m
from ..core import warp
from ..core.distributions import DiscreteDistribution
from ..core.records import BSDFFlags, SurfaceInteraction, has_flag
from ..core.rng import Sampler
from ..core.sh import sh_eval
from ..core.struct import trepeat
from ..intersect import ray_intersect
from ..ops import block_sum
from ..render import bsdf as bsdflib
from ..render.emitter import (
    eval_emitter,
    pdf_emitter_direction,
    sample_emitter_direction,
)
from ..integrators.common import mis_weight, register_integrator
from .hashgrid_enc import HashGridConfig, hashgrid_encode, init_hashgrid
from .mlp import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    grid: HashGridConfig = HashGridConfig()
    sh_order: int = 3
    width: int = 64
    depth: int = 4


def init_field(key, cfg: FieldConfig):
    k1, k2 = jax.random.split(key)
    in_dim = cfg.grid.out_dim + (cfg.sh_order + 1) ** 2
    sizes = [in_dim] + [cfg.width] * (cfg.depth - 1) + [3]
    return {
        "grid": init_hashgrid(k1, cfg.grid),
        "mlp": init_mlp(k2, sizes),
    }


def field_eval(params, cfg: FieldConfig, p_norm, wi_world):
    """L(x, omega): nerad.py:91-106.  p_norm in [0,1]^3; exp output for
    nonnegative radiance (the reference uses an Exp output layer)."""
    feat_p = hashgrid_encode(params["grid"], p_norm, cfg.grid)
    feat_d = sh_eval(wi_world, cfg.sh_order)
    h = jnp.concatenate([feat_p, feat_d.astype(feat_p.dtype)], axis=-1)
    out = apply_mlp(params["mlp"], h, hidden_act="leaky_relu", out_act="none")
    return jnp.exp(out.astype(jnp.float32)) - 1.0  # expm1: signed-safe


@dataclasses.dataclass(frozen=True)
class NeradTrainer:
    field_cfg: FieldConfig = FieldConfig()
    batch_size: int = 1 << 14
    m_rhs: int = 32          # RHS fan-out (nerad.py:258)
    lr: float = 1e-3

    # ---------------- scene-space normalization -----------------------
    @staticmethod
    def scene_bounds(scene):
        lo = jnp.min(scene.geometry.vertices, axis=0)
        hi = jnp.max(scene.geometry.vertices, axis=0)
        return lo, hi - lo

    # ---------------- surface sampling (nerad.py:275-310) -------------
    @staticmethod
    def make_area_dist(scene):
        v = np.asarray(scene.geometry.vertices)
        f = np.asarray(scene.geometry.faces)
        tri = v[f]
        areas = 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
        )
        return DiscreteDistribution.create(jnp.asarray(areas.astype(np.float32)))

    def sample_surface(self, scene, area_dist, sampler):
        """Area-weighted surface point + uniform-sphere wi -> synthetic si."""
        sampler, u_f = sampler.next_1d()
        face, u_re = area_dist.sample_reuse(u_f)
        sampler, u_b = sampler.next_1d()
        fidx = jnp.take(scene.geometry.faces, face, axis=0)
        v0 = jnp.take(scene.geometry.vertices, fidx[:, 0], axis=0)
        v1 = jnp.take(scene.geometry.vertices, fidx[:, 1], axis=0)
        v2 = jnp.take(scene.geometry.vertices, fidx[:, 2], axis=0)
        b = warp.square_to_uniform_triangle(jnp.stack([u_re, u_b], axis=-1))
        p = v0 + (v1 - v0) * b[..., :1] + (v2 - v0) * b[..., 1:2]
        ng = m.normalize(m.cross(v1 - v0, v2 - v0))
        sampler, u_d = sampler.next_2d()
        wi_w = warp.square_to_uniform_sphere(u_d)
        # flip to the outside hemisphere
        wi_w = jnp.where(
            m.dot(wi_w, ng)[:, None] < 0, -wi_w, wi_w
        )
        s, t = m.coordinate_system(ng)
        n = p.shape[0]
        si = SurfaceInteraction(
            t=jnp.ones((n,), m.Float),
            p=p, n=ng, sh_n=ng, sh_s=s, sh_t=t,
            uv=jnp.zeros((n, 2), m.Float),
            wi=m.to_local(s, t, ng, wi_w),
            prim_idx=face.astype(jnp.int32),
            mat_id=jnp.take(scene.geometry.face_mat, face),
            emitter_id=jnp.take(scene.geometry.face_emitter, face),
        )
        return si, sampler

    # ---------------- specular walk (nerad.py:123-164) ----------------
    def next_smooth_si(self, scene, sampler, si, active):
        """Walk through delta lobes until a Smooth surface (bounded 4)."""
        n = si.p.shape[0]
        f = jnp.ones((n, 3), m.Float)

        def body(d, carry):
            sampler, si, f, active = carry
            flags = bsdflib.bsdf_flags(scene.materials, si.mat_id)
            delta_only = ~has_flag(flags, BSDFFlags.Smooth) & si.valid
            walk = active & delta_only
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, w = bsdflib.sample(
                scene.materials, scene.textures, si, u1, u2, walk
            )
            ray = si.spawn_ray(si.to_world(bs.wo))
            si2 = ray_intersect(scene, ray, walk)
            si = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    walk.reshape(walk.shape + (1,) * (a.ndim - 1)), a, b
                ), si2, si,
            )
            f = jnp.where(walk[:, None], f * w, f)
            return (sampler, si, f, active)

        sampler, si, f, active = jax.lax.fori_loop(
            0, 4, body, (sampler, si, f, active)
        )
        return si, f, sampler

    # ---------------- RHS (nerad.py:174-233) ---------------------------
    def sample_rhs(self, scene, params, sampler, si, lo, extent):
        """One-bounce estimate at si: NEE+MIS + BSDF bounce into the field;
        M-fold fan-out then block-mean."""
        M = self.m_rhs
        si_r = trepeat(si, M)
        nM = si_r.p.shape[0]
        sampler_r = dataclasses.replace(
            sampler.fork(99), lane=jnp.arange(nM, dtype=jnp.uint32)
        )

        L = eval_emitter(scene, si_r)

        # NEE
        sampler_r, u_em = sampler_r.next_2d()
        flags = bsdflib.bsdf_flags(scene.materials, si_r.mat_id)
        active_em = has_flag(flags, BSDFFlags.Smooth) & si_r.valid
        ds, em_w = sample_emitter_direction(scene, si_r, u_em, True, active_em)
        wo_l = si_r.to_local(ds.d)
        f_em, pdf_em = bsdflib.eval_pdf(
            scene.materials, scene.textures, si_r, wo_l, active_em
        )
        mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_em))
        L = L + jnp.where(
            active_em[:, None], f_em * em_w * mis_em[:, None], 0.0
        )

        # BSDF bounce -> field at next smooth si (+ MIS emitter hit)
        sampler_r, u1 = sampler_r.next_1d()
        sampler_r, u2 = sampler_r.next_2d()
        bs, bw = bsdflib.sample(
            scene.materials, scene.textures, si_r, u1, u2, si_r.valid
        )
        ray = si_r.spawn_ray(si_r.to_world(bs.wo))
        si2 = ray_intersect(scene, ray, si_r.valid)

        bsdf_delta = has_flag(bs.sampled_type, BSDFFlags.Delta)
        em_pdf = pdf_emitter_direction(scene, si_r, si2, ~bsdf_delta)
        mis_b = mis_weight(bs.pdf, em_pdf)
        L = L + jnp.where(
            (si_r.valid & si2.valid)[:, None],
            bw * eval_emitter(scene, si2) * mis_b[:, None],
            0.0,
        )

        si2, f_spec, sampler_r = self.next_smooth_si(
            scene, sampler_r, si2, si_r.valid & si2.valid
        )
        p_norm = jnp.clip((si2.p - lo) / extent, 0.0, 1.0)
        wi2_w = si2.wi_world
        L_field = field_eval(params, self.field_cfg, p_norm, wi2_w)
        # exclude re-counting emitters hit by the bounce: field models
        # *outgoing* radiance incl. emission, so mask field where emitter
        # (the emitter contribution was already MIS-added above)
        field_ok = si2.valid & (si2.emitter_id < 0)
        L = L + jnp.where(
            field_ok[:, None], bw * f_spec * L_field, 0.0
        )
        # trepeat is [a a b b ...]-ordered, so the M fan-out of sample k sits
        # in rows [k*M, (k+1)*M) — dr.block_sum(L, M)/M (nerad.py:231)
        return block_sum(L, M) / M

    # ---------------- training step (nerad.py:363-375) -----------------
    def make_train_step(self, scene):
        area_dist = self.make_area_dist(scene)
        lo, extent = self.scene_bounds(scene)
        opt = optax.adam(self.lr)

        def loss_fn(params, sampler):
            si, sampler = self.sample_surface(scene, area_dist, sampler)
            p_norm = jnp.clip((si.p - lo) / extent, 0.0, 1.0)
            lhs = field_eval(params, self.field_cfg, p_norm, si.wi_world)
            rhs = self.sample_rhs(scene, params, sampler, si, lo, extent)
            # residual: grads flow through both sides (neural radiosity norm)
            return jnp.mean((lhs - rhs) ** 2)

        @jax.jit
        def step(params, opt_state, seed):
            sampler = Sampler.create(
                seed, lane=jnp.arange(self.batch_size, dtype=jnp.uint32)
            )
            loss, grads = jax.value_and_grad(loss_fn)(params, sampler)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        def init(key):
            params = init_field(key, self.field_cfg)
            return params, opt.init(params)

        return init, step

    def train(self, scene, n_iters=200, seed=0, log_every=50):
        init, step = self.make_train_step(scene)
        params, opt_state = init(jax.random.PRNGKey(seed))
        losses = []
        for i in range(n_iters):
            params, opt_state, loss = step(params, opt_state, jnp.uint32(i))
            if (i + 1) % log_every == 0:
                losses.append(float(loss))
        return params, losses


@dataclasses.dataclass(frozen=True, eq=False)
class NeradIntegrator:
    """Render by querying the trained field at the first non-delta hit
    (nerad.py:235-254).

    eq=False (identity hash): the params pytree is baked into the compiled
    render as constants; see NRCIntegrator for the jit-cache rationale.
    """

    trainer: NeradTrainer
    params: dict = None

    def sample(self, scene, sampler, ray, active=None):
        n = ray.o.shape[0]
        if active is None:
            active = jnp.ones((n,), bool)
        si = ray_intersect(scene, ray, active)
        si, f_spec, sampler = self.trainer.next_smooth_si(
            scene, sampler, si, active & si.valid
        )
        lo, extent = self.trainer.scene_bounds(scene)
        p_norm = jnp.clip((si.p - lo) / extent, 0.0, 1.0)
        L_field = field_eval(
            self.params, self.trainer.field_cfg, p_norm, si.wi_world
        )
        # emitters render their own radiance
        L_emit = eval_emitter(scene, si)
        use_field = si.valid & (si.emitter_id < 0)
        L = jnp.where(use_field[:, None], f_spec * L_field, L_emit)
        return jnp.maximum(L, 0.0), si.valid, sampler


register_integrator("nerad", NeradIntegrator)
