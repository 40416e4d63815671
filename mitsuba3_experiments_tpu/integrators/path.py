"""Wavefront unidirectional path tracer with NEE + MIS + Russian roulette.

JAX re-design of the reference's flagship integrator
(/root/reference/path.py:194-302, path-mis.py:24-155): the same
si-first loop formulation — estimate outgoing radiance at the current
surface interaction, MIS-combining the emitter sample with the BSDF
bounce — but the per-lane-masked `@dr.syntax` while loop becomes a
`lax.while_loop` (forward, early-exits when the whole wavefront dies) or a
bounded `lax.scan` (differentiable path; reverse-mode checkpoints each
bounce).  Sampling stays detached (dr.detach discipline of path.py:18,274,294)
so pixel gradients flow only through eval paths — matching Mitsuba's AD
estimator rather than naive full-graph AD (SURVEY.md hard part #3).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.records import BSDFFlags, has_flag
from ..core.struct import twhere
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render.emitter import (
    eval_emitter,
    eval_environment,
    pdf_emitter_direction,
    pdf_environment_direction,
    sample_emitter_direction,
)
from .common import mis_weight, register_integrator


@dataclasses.dataclass(frozen=True)
class PathIntegrator:
    """props: max_depth / rr_depth with Mitsuba defaults (path.py:23-24)."""

    max_depth: int = 16
    rr_depth: int = 4
    differentiable: bool = False  # scan (AD-capable) vs while_loop (fast)

    def sample(self, scene, sampler, ray, active=None):
        n = ray.o.shape[0]
        if active is None:
            active = jnp.ones((n,), bool)

        L = jnp.zeros((n, 3), m.Float)
        f = jnp.ones((n, 3), m.Float)
        eta = jnp.ones((n,), m.Float)
        depth = jnp.ones((n,), jnp.int32)
        active = active & (depth < self.max_depth + 1)

        # ------------------- primary hit + its emission -------------------
        si = ray_intersect(scene, ray, active)
        L = L + eval_emitter(scene, si, active)
        L = L + eval_environment(scene, active & ~si.valid, ray.d)
        active = active & si.valid & (depth < self.max_depth)

        state = (L, f, eta, depth, active, si, sampler)

        def body(state):
            L, f, eta, depth, active, si, sampler = state
            mats, tex = scene.materials, scene.textures

            # ---------------------- emitter sampling ----------------------
            flags = bsdflib.bsdf_flags(mats, si.mat_id)
            active_em = active & has_flag(flags, BSDFFlags.Smooth)

            sampler, u_em = sampler.next_2d()
            ds, em_weight = sample_emitter_direction(
                scene, si, u_em, True, active_em
            )
            active_em &= ds.pdf != 0.0
            wo = si.to_local(ds.d)

            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bsdf_val, bsdf_pdf, bs, bsdf_weight = bsdflib.eval_pdf_sample(
                mats, tex, si, wo, u1, u2, active
            )

            mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
            L = L + jnp.where(
                active_em[:, None], f * bsdf_val * em_weight * mis_em[:, None], 0.0
            )

            # ----------------- next surface interaction -------------------
            f = f * bsdf_weight
            eta = eta * bs.eta

            # --------------------- stopping criterion ---------------------
            fmax = m.max_component(f)
            rr_prob = jnp.minimum(fmax * eta * eta, 0.95)
            rr_active = depth >= self.rr_depth
            sampler, u_rr = sampler.next_1d()
            rr_continue = u_rr < rr_prob
            f = jnp.where(
                rr_active[:, None],
                f * m.safe_rcp(jax.lax.stop_gradient(rr_prob))[:, None],
                f,
            )
            active &= fmax != 0.0
            active &= ~rr_active | rr_continue

            # ---------------------- direct emission -----------------------
            ray2 = si.spawn_ray(si.to_world(bs.wo))
            si2 = ray_intersect(scene, ray2, active)

            bsdf_delta = has_flag(bs.sampled_type, BSDFFlags.Delta)
            em_pdf = pdf_emitter_direction(scene, si, si2, ~bsdf_delta)
            mis_bsdf = mis_weight(bs.pdf, em_pdf)
            L = L + jnp.where(
                (active & (bs.pdf > 0.0))[:, None],
                f * eval_emitter(scene, si2, active) * mis_bsdf[:, None],
                0.0,
            )
            # escaped bounce rays collect the environment, MIS-weighted
            # against env-NEE (pdf 0 for constant/absent envs -> weight 1)
            esc = active & ~si2.valid & (bs.pdf > 0.0)
            env_pdf = pdf_environment_direction(
                scene, ray2.d, esc & ~bsdf_delta
            )
            mis_env = mis_weight(bs.pdf, env_pdf)
            L = L + jnp.where(
                esc[:, None],
                f * eval_environment(scene, esc, ray2.d) * mis_env[:, None],
                0.0,
            )

            si = jax.lax.stop_gradient(si2)
            depth = jnp.where(active, depth + 1, depth)
            active &= (depth < self.max_depth) & si.valid
            return (L, f, eta, depth, active, si, sampler)

        if self.differentiable:
            # bounded scan: fixed trip count, rematerialized per bounce
            def scan_body(state, _):
                return jax.checkpoint(body)(state), None

            state, _ = jax.lax.scan(
                scan_body, state, None, length=max(self.max_depth - 1, 0)
            )
        else:
            state = jax.lax.while_loop(
                lambda s: jnp.any(s[4]), body, state
            )

        L, f, eta, depth, active, si, sampler = state
        return L, depth > 0, sampler


register_integrator("path", PathIntegrator)
register_integrator("mypath", PathIntegrator)
