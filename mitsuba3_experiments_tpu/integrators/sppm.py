"""Stochastic progressive photon mapping.

JAX re-design of /root/reference/sppm.py: the camera pass collects
visible points through a specular-only walk (sample_visible_point
sppm.py:199-234), a hash grid buckets them (sppm.py:98-178 — here the
sort-based ops/hashgrid.py instead of the scatter-reduce collision loops),
and the photon pass — which the reference left unfinished (sppm.py:274 is a
literal `...`) — is completed here: emitter-ray photon walks deposit flux
onto nearby visible points through the grid, with the standard SPPM radius /
flux progressive update (Hachisuka & Jensen 2009, alpha=2/3).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.records import BSDFFlags, has_flag
from ..core.rng import Sampler
from ..core.struct import jstruct
from ..intersect import ray_intersect
from ..ops.hashgrid import HashGrid
from ..render import bsdf as bsdflib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter, sample_emitter_ray
from .common import register_integrator

ALPHA = 2.0 / 3.0


@jstruct
class SPPMState:
    radius2: jnp.ndarray   # (N,) current search radius^2 per pixel
    n_photons: jnp.ndarray  # (N,) accumulated photon count (tau N)
    tau: jnp.ndarray       # (N, 3) accumulated (normalized) flux
    direct: jnp.ndarray    # (N, 3) accumulated direct+emitted radiance
    frames: jnp.ndarray    # () int32


@dataclasses.dataclass(frozen=True)
class SPPM:
    max_depth: int = 8
    photon_count: int = 1 << 16
    initial_radius: float = 0.05
    max_per_cell: int = 32
    grid_cells: int = 1 << 16

    def init_state(self, scene) -> SPPMState:
        w, h = scene.camera.resolution
        n = w * h
        return SPPMState(
            radius2=jnp.full((n,), self.initial_radius**2, m.Float),
            n_photons=jnp.zeros((n,), m.Float),
            tau=jnp.zeros((n, 3), m.Float),
            direct=jnp.zeros((n, 3), m.Float),
            frames=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------------
    def sample_visible_point(self, scene, sampler, ray):
        """sppm.py:199-234: walk through delta interactions only; stop at the
        first smooth (Diffuse/Glossy) surface — that's the visible point."""
        n = ray.o.shape[0]
        f = jnp.ones((n, 3), m.Float)
        L_direct = jnp.zeros((n, 3), m.Float)
        found = jnp.zeros((n,), bool)
        si_vp = None

        si = ray_intersect(scene, ray)
        L_direct = L_direct + eval_emitter(scene, si)
        state = (sampler, si, f, L_direct, jnp.ones((n,), bool), si)

        def body(d, state):
            sampler, si, f, L_direct, walking, si_vp = state
            flags = bsdflib.bsdf_flags(scene.materials, si.mat_id)
            smooth = has_flag(flags, BSDFFlags.Smooth) & si.valid
            # lanes that just arrived at a smooth surface store their VP
            arrive = walking & smooth
            si_vp = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    arrive.reshape(arrive.shape + (1,) * (a.ndim - 1)), a, b
                ),
                si, si_vp,
            )
            walking = walking & ~smooth & si.valid
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, w = bsdflib.sample(
                scene.materials, scene.textures, si, u1, u2, walking
            )
            f = jnp.where(walking[:, None], f * w, f)
            ray2 = si.spawn_ray(si.to_world(bs.wo))
            si2 = ray_intersect(scene, ray2, walking)
            L_direct = L_direct + jnp.where(
                walking[:, None], f * eval_emitter(scene, si2, walking), 0.0
            )
            return (sampler, si2, f, L_direct, walking, si_vp)

        sampler, si, f, L_direct, walking, si_vp = jax.lax.fori_loop(
            0, 4, body, state
        )
        vp_valid = si_vp.valid & has_flag(
            bsdflib.bsdf_flags(scene.materials, si_vp.mat_id), BSDFFlags.Smooth
        )
        return si_vp, f, L_direct, vp_valid, sampler

    # ------------------------------------------------------------------
    def photon_pass(self, scene, sampler, vp_si, vp_beta, vp_valid, radius2):
        """Trace photons; deposit flux on visible points within radius."""
        npho = self.photon_count
        psampler = sampler.fork(777)
        psampler = dataclasses.replace(
            psampler, lane=jnp.arange(npho, dtype=jnp.uint32)
        )
        psampler, u_pos = psampler.next_2d()
        psampler, u_dir = psampler.next_2d()
        ray, power, _ = sample_emitter_ray(scene, u_pos, u_dir)
        power = power / npho

        n_vp = vp_si.p.shape[0]
        max_r = jnp.sqrt(jnp.max(jnp.where(vp_valid, radius2, 0.0)))
        cell = jnp.maximum(2.0 * max_r, 1e-4)  # build_expanded contract
        vp_pos = jnp.where(vp_valid[:, None], vp_si.p, 1e10)
        grid = HashGrid.build_expanded(
            vp_pos, jnp.sqrt(radius2), cell, self.grid_cells
        )

        tau_add = jnp.zeros((n_vp, 3), m.Float)
        count_add = jnp.zeros((n_vp,), m.Float)

        def bounce(d, carry):
            psampler, ray, power, active, tau_add, count_add = carry
            si = ray_intersect(scene, ray, active)
            active = active & si.valid

            # deposit: photons on smooth surfaces contribute to nearby VPs
            # in their own cell and the 8 neighbor cells would be ideal;
            # reference grid expands samples by radius instead — here VP
            # cell size == max radius, and we check the photon's cell plus
            # it relies on VP-centric cell membership (photon must land in
            # the VP's cell): one-cell lookup, radius test exact.
            neigh = grid.gather_neighbors(si.p, self.max_per_cell)  # (P, K)
            ok = (neigh >= 0) & active[:, None]
            vps = jnp.maximum(neigh, 0)                       # (P, K)
            d2 = m.squared_norm(
                si.p[:, None, :] - jnp.take(vp_pos, vps, axis=0)
            )
            ok &= d2 <= jnp.take(radius2, vps)
            # one flattened deterministic scatter-add for all K taps
            flat = jnp.where(ok, vps, n_vp).reshape(-1)
            contrib = jnp.broadcast_to(
                power[:, None, :], ok.shape + (3,)
            ).reshape(-1, 3)
            tau_add = tau_add.at[flat].add(
                jnp.where(ok.reshape(-1, 1), contrib, 0.0), mode="drop"
            )
            count_add = count_add.at[flat].add(
                ok.reshape(-1).astype(m.Float), mode="drop"
            )

            psampler, u1 = psampler.next_1d()
            psampler, u2 = psampler.next_2d()
            bs, w = bsdflib.sample(
                scene.materials, scene.textures, si, u1, u2, active
            )
            power = power * w
            ray = si.spawn_ray(si.to_world(bs.wo))
            psampler, u_rr = psampler.next_1d()
            pmax = m.max_component(w)
            keep = u_rr < jnp.minimum(pmax, 0.95)
            power = power * m.safe_rcp(
                jnp.minimum(jnp.maximum(pmax, 1e-6), 0.95)
            )[:, None]
            active = active & keep & (pmax > 0)
            return (psampler, ray, power, active, tau_add, count_add)

        carry = (
            psampler, ray, power, jnp.ones((npho,), bool), tau_add, count_add
        )
        carry = jax.lax.fori_loop(0, self.max_depth, bounce, carry)
        _, _, _, _, tau_add, count_add = carry
        return tau_add, count_add

    # ------------------------------------------------------------------
    def render_frame(self, scene, state: SPPMState, seed):
        """One SPPM iteration: camera pass + photon pass + radius update."""
        w, h = scene.camera.resolution
        n = w * h
        pix = jnp.arange(n, dtype=jnp.uint32)
        px = (pix % w).astype(m.Float)
        py = (pix // w).astype(m.Float)
        sampler = Sampler.create(seed, lane=pix)
        sampler, jitter = sampler.next_2d()
        pos = jnp.stack([px, py], axis=-1) + jitter
        ray = sensorlib.sample_ray(scene.camera, pos)

        vp_si, vp_beta, L_direct, vp_valid, sampler = (
            self.sample_visible_point(scene, sampler, ray)
        )
        tau_add, count_add = self.photon_pass(
            scene, sampler, vp_si, vp_beta, vp_valid, state.radius2
        )
        # apply the VP BRDF (diffuse albedo / pi) to the gathered flux
        f_vp, _ = bsdflib.eval_pdf(
            scene.materials, scene.textures, vp_si,
            jnp.tile(jnp.array([[0.0, 0.0, 1.0]], m.Float), (n, 1)),
            vp_valid,
        )
        # eval returns f*cos with wo=+n (cos=1) -> lambertian rho/pi
        tau_add = tau_add * vp_beta * f_vp

        # progressive radius/flux update (Hachisuka 2009)
        N = state.n_photons
        Mn = count_add
        shrink = m.safe_div(N + ALPHA * Mn, N + Mn, fill=1.0)
        radius2 = jnp.where(Mn > 0, state.radius2 * shrink, state.radius2)
        tau = jnp.where(
            Mn[:, None] > 0,
            (state.tau + tau_add) * shrink[:, None],
            state.tau,
        )
        n_photons = N + ALPHA * Mn
        direct = state.direct + L_direct
        frames = state.frames + 1

        # estimate: direct/frames + tau / (pi r^2 * total photons emitted)
        # (power was already divided by photon_count per pass)
        img = (
            direct / frames.astype(m.Float)
            + m.safe_div(tau, (m.PI * radius2 * frames.astype(m.Float))[:, None])
        )
        img = img.reshape(h, w, 3)
        return img, SPPMState(
            radius2=radius2, n_photons=n_photons, tau=tau,
            direct=direct, frames=frames,
        )


register_integrator("sppm", SPPM)
