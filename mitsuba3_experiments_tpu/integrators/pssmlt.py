"""Primary-sample-space Metropolis light transport (PSSMLT).

JAX re-design of /root/reference/pssmlt.py + pssmltpath.py +
pssmltsimple.py.  Round 2 replaces the reference's structure-faithful but
*biased* scheme (direction-lerp mutations, current-state-only cumulative
splat) with the textbook Kelemen et al. 2002
formulation, which is what the reference was approximating:

  * The chain state is the **primary sample vector** — the screen position
    plus every uniform random number the path tracer consumes (per-bounce
    BSDF lobe/direction uniforms, NEE emitter-sample uniforms, and the
    Russian-roulette decisions).  The path is a *deterministic* function of
    this vector, so the target density lum(L(u)) is well-defined (the
    reference's pssmltpath.py:170-190 mutated `wo` directly with a lerp
    toward a fresh BSDF sample — an asymmetric proposal whose Metropolis
    ratio was never corrected).
  * Small steps are **wrapped gaussians** on every component (symmetric on
    the torus [0,1)^d); large steps resample the whole vector uniformly —
    an independence proposal.  Both give accept prob a = min(1, lum'/lum).
  * Chains roam the **whole image** (reference: per-pixel-lane chains,
    pssmlt.py:180) so the normalization constant b = E[lum] is *global*,
    estimated from bootstrap_count * n_chains uniform samples — millions of
    samples, so the b-induced bias is negligible (a per-pixel b from ~40
    samples carries O(CV^2/K) ~ 10% bias; this was round 1's residual
    error).
  * Splatting is the Kelemen **expected-value / MIS** estimator: each
    iteration splats the *current* state with weight (1-a)/(lum/b + pL) and
    the *proposed* state with weight (a + 1{large})/(lum'/b + pL), which
    MIS-combines the chain with the plain-MC large-step estimator
    (pL = large-step probability).  The image is the splat sum divided by
    the number of sampling iterations (chains == pixels, so the (w*h)
    measure factors cancel).

Structure: the (max_depth, N) AoS vertex buffer (reference pssmlt.py:27-67)
becomes (max_depth, N, k) uniform arrays in a chain-state pytree; the
host-driven kernel rounds (pssmlt.py:208) remain a host loop over one jitted
`step` with donated state.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.records import BSDFFlags, SurfaceInteraction, has_flag
from ..core.rng import pcg_hash, tea32, uint_to_float01
from ..core.struct import jstruct
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render import sensor as sensorlib
from ..render.emitter import (
    eval_emitter,
    pdf_emitter_direction,
    sample_emitter_direction,
)
from .common import mis_weight, register_integrator

_U32 = jnp.uint32


def _uniform_grid(seed, it, tag: int, shape) -> jnp.ndarray:
    """Counter-based uniforms of arbitrary static shape for mutation draws.

    Pure function of (seed, iteration, tag, flat index) — the wavefront
    analog of the reference's sampler.seed(seed, wavefront) per round
    (pssmlt.py:186)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = jnp.arange(n, dtype=_U32)
    k0, k1 = tea32(seed, jnp.asarray(it, _U32) * _U32(0x9E3779B9) + _U32(tag))
    bits = pcg_hash(pcg_hash(idx ^ k0) + k1)
    return uint_to_float01(bits).reshape(shape)


def _mutate(old, u, large, sigma):
    """Symmetric wrapped-gaussian small step / uniform large step.

    The same uniform `u` drives both branches: as the fresh value for large
    steps and (via the inverse CDF) as the gaussian perturbation otherwise.
    Wrapping mod 1 keeps the proposal symmetric on the torus (a clipped
    gaussian — round 1 / reference pssmlt.py:251 — piles mass at the
    boundary and violates detailed balance)."""
    g = jnp.sqrt(2.0) * m.erfinv(jnp.clip(2.0 * u - 1.0, -0.999999, 0.999999))
    return jnp.where(large, u, (old + sigma * g) % 1.0)


@jstruct
class PssmltState:
    """Per-chain Markov state: the primary sample vector + cached value."""

    pos: jnp.ndarray       # (N, 2) screen position in [0,1)^2
    u_bsdf: jnp.ndarray    # (D, N, 3) per-bounce BSDF uniforms (u1, u2)
    u_em: jnp.ndarray      # (D, N, 2) per-bounce NEE emitter uniforms
    u_rr: jnp.ndarray      # (D, N) per-bounce RR decisions
    L: jnp.ndarray         # (N, 3) radiance of current chain state
    b_sum: jnp.ndarray     # () running sum of bootstrap luminances


@dataclasses.dataclass(frozen=True)
class Pssmlt:
    """mode="path": full NEE+MIS chain integrator registered as "pssmlt"
    (reference pssmltpath.py); mode="simple": BSDF-sampling only — the
    reference's "pssmlt_simple" (pssmltsimple.py:16-142)."""

    max_depth: int = 8
    rr_depth: int = 4
    mode: str = "path"            # "path" | "simple"
    p_large: float = 0.3          # large-step probability (sampling phase)
    sigma_pos: float = 1.0 / 64.0  # screen small-step stddev (screen frac)
    sigma_u: float = 1.0 / 32.0    # primary-space small-step stddev
    bootstrap_count: int = 40      # all-large-step iterations estimating b

    def init_state(self, n: int) -> PssmltState:
        d = self.max_depth
        return PssmltState(
            pos=jnp.full((n, 2), 0.5, m.Float),
            u_bsdf=jnp.full((d, n, 3), 0.5, m.Float),
            u_em=jnp.full((d, n, 2), 0.5, m.Float),
            u_rr=jnp.full((d, n), 0.5, m.Float),
            L=jnp.zeros((n, 3), m.Float),
            b_sum=jnp.zeros((), m.Float),
        )

    # -- deterministic path eval from a primary sample vector ---------------
    def sample(self, scene, ray, u_bsdf, u_em, u_rr):
        """Trace the path encoded by the uniform arrays; returns (N,3) L.

        Same NEE+MIS wavefront loop as integrators/path.py (reference
        path.py:194-302), but every random draw is read from the supplied
        primary-sample arrays instead of a sampler — the path is a pure
        function of (ray, u)."""
        n = ray.o.shape[0]
        L = jnp.zeros((n, 3), m.Float)
        f = jnp.ones((n, 3), m.Float)
        eta = jnp.ones((n,), m.Float)
        depth = jnp.zeros((n,), jnp.int32)
        active = jnp.ones((n,), bool)
        prev_si = SurfaceInteraction.invalid(n)
        prev_bsdf_pdf = jnp.ones((n,), m.Float)
        prev_bsdf_delta = jnp.ones((n,), bool)
        mats, tex = scene.materials, scene.textures

        def body(d, carry):
            (L, f, eta, depth, active, ray, prev_si, prev_bsdf_pdf,
             prev_bsdf_delta) = carry

            si = ray_intersect(scene, ray, active)

            # direct emission with MIS vs previous bounce's NEE
            if self.mode == "path":
                em_pdf = pdf_emitter_direction(
                    scene, prev_si, si, ~prev_bsdf_delta
                )
            else:  # simple: BSDF sampling is the only strategy
                em_pdf = jnp.zeros((n,), m.Float)
            mis_b = mis_weight(prev_bsdf_pdf, em_pdf)
            L = L + jnp.where(
                (active & (prev_bsdf_pdf > 0))[:, None],
                f * eval_emitter(scene, si, active) * mis_b[:, None],
                0.0,
            )

            active_next = active & ((depth + 1) < self.max_depth) & si.valid

            u1 = u_bsdf[d, :, 0]
            u2 = u_bsdf[d, :, 1:3]
            bs, bsdf_weight = bsdflib.sample(mats, tex, si, u1, u2, active_next)
            ray = si.spawn_ray(si.to_world(bs.wo))

            # NEE with the chain's emitter sample (path mode only)
            if self.mode == "path":
                flags = bsdflib.bsdf_flags(mats, si.mat_id)
                active_em = active_next & has_flag(flags, BSDFFlags.Smooth)
                ds, em_weight = sample_emitter_direction(
                    scene, si, u_em[d], True, active_em
                )
                wo_l = si.to_local(ds.d)
                nee_val, nee_pdf = bsdflib.eval_pdf(
                    mats, tex, si, wo_l, active_em
                )
                mi_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, nee_pdf))
                L = L + jnp.where(
                    active_em[:, None],
                    f * nee_val * em_weight * mi_em[:, None], 0.0,
                )

            f = f * bsdf_weight
            eta = eta * bs.eta
            prev_si = si
            prev_bsdf_pdf = bs.pdf
            prev_bsdf_delta = has_flag(bs.sampled_type, BSDFFlags.Delta)
            depth = jnp.where(active & si.valid, depth + 1, depth)

            fmax = m.max_component(f)
            rr_prob = jnp.minimum(fmax * eta * eta, 0.95)
            rr_active = depth >= self.rr_depth
            f = jnp.where(
                rr_active[:, None], f * m.safe_rcp(rr_prob)[:, None], f
            )
            active = (
                active_next & (~rr_active | (u_rr[d] < rr_prob)) & (fmax != 0.0)
            )
            return (L, f, eta, depth, active, ray, prev_si, prev_bsdf_pdf,
                    prev_bsdf_delta)

        carry = (L, f, eta, depth, active, ray, prev_si, prev_bsdf_pdf,
                 prev_bsdf_delta)
        carry = jax.lax.fori_loop(0, self.max_depth, body, carry)
        return carry[0]

    # -- one MCMC round over all chains --------------------------------------
    @partial(jax.jit, static_argnames=("self",), donate_argnums=(2, 3))
    def step(self, scene, state: PssmltState, accum, seed, it, bootstrap):
        """Mutate, evaluate, Kelemen-splat, accept/reject.  `bootstrap` is a
        traced bool: bootstrap rounds force large steps, accumulate b, and
        skip splatting."""
        w, h = scene.camera.resolution
        n = state.L.shape[0]
        d = self.max_depth

        u_large = _uniform_grid(seed, it, 0, (n,))
        large = jnp.where(bootstrap, True, u_large < self.p_large)

        pos_p = _mutate(
            state.pos, _uniform_grid(seed, it, 1, (n, 2)),
            large[:, None], self.sigma_pos,
        )
        u_bsdf_p = _mutate(
            state.u_bsdf, _uniform_grid(seed, it, 2, (d, n, 3)),
            large[None, :, None], self.sigma_u,
        )
        u_em_p = _mutate(
            state.u_em, _uniform_grid(seed, it, 3, (d, n, 2)),
            large[None, :, None], self.sigma_u,
        )
        u_rr_p = _mutate(
            state.u_rr, _uniform_grid(seed, it, 4, (d, n)),
            large[None, :], self.sigma_u,
        )

        res = jnp.asarray([w, h], m.Float)
        ray = sensorlib.sample_ray(scene.camera, pos_p * res[None, :])
        L_prop = self.sample(scene, ray, u_bsdf_p, u_em_p, u_rr_p)
        L_prop = jnp.where(jnp.isfinite(L_prop), L_prop, 0.0)
        lum_prop = m.luminance(L_prop)
        lum_cur = m.luminance(state.L)

        a = jnp.clip(m.safe_div(lum_prop, lum_cur, fill=1.0), 0.0, 1.0)
        accept = _uniform_grid(seed, it, 5, (n,)) < a

        # Kelemen expected-value + large-step MIS splatting.  b is the global
        # mean luminance from the bootstrap phase (unit-uniform samples).
        b = state.b_sum / jnp.asarray(self.bootstrap_count * n, m.Float)
        b = jnp.where(b > 0, b, 1.0)
        pl = jnp.asarray(self.p_large, m.Float)
        w_prop = (a + large.astype(m.Float)) / (lum_prop / b + pl)
        w_cur = (1.0 - a) / (lum_cur / b + pl)
        gate = jnp.where(bootstrap, 0.0, 1.0)

        def splat(accum, pos01, val, wgt):
            px = jnp.clip((pos01[:, 0] * w).astype(jnp.int32), 0, w - 1)
            py = jnp.clip((pos01[:, 1] * h).astype(jnp.int32), 0, h - 1)
            return accum.at[py * w + px].add(val * (wgt * gate)[:, None])

        accum = splat(accum, pos_p, L_prop, w_prop)
        accum = splat(accum, state.pos, state.L, w_cur)

        new_state = PssmltState(
            pos=jnp.where(accept[:, None], pos_p, state.pos),
            u_bsdf=jnp.where(accept[None, :, None], u_bsdf_p, state.u_bsdf),
            u_em=jnp.where(accept[None, :, None], u_em_p, state.u_em),
            u_rr=jnp.where(accept[None, :], u_rr_p, state.u_rr),
            L=jnp.where(accept[:, None], L_prop, state.L),
            b_sum=state.b_sum
            + jnp.where(bootstrap, jnp.sum(lum_prop), 0.0),
        )
        return new_state, accum

    # -- full render ----------------------------------------------------------
    def render(self, scene, seed: int = 0, n_iterations: int = 200):
        w, h = scene.camera.resolution
        n = w * h
        state = self.init_state(n)
        accum = jnp.zeros((n, 3), m.Float)
        n_sampling = max(n_iterations - self.bootstrap_count, 1)
        for i in range(n_iterations):
            state, accum = self.step(
                scene, state, accum, jnp.uint32(seed), jnp.uint32(i),
                jnp.asarray(i < self.bootstrap_count),
            )
        return (accum / n_sampling).reshape(h, w, 3)


register_integrator("pssmlt", Pssmlt)
