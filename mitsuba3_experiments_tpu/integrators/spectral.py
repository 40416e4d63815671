"""Hero-wavelength spectral path tracer — the `cuda_ad_spectral` variant.

The reference's one spectral experiment (/root/reference/patch.py:10) runs a
diffuse scene under Mitsuba's spectral variant; Mitsuba supplies wavelength
sampling, RGB upsampling, and the CIE film.  This module is that variant
in JAX (machinery in core/spectrum.py):

  * each lane carries K=4 hero-rotated wavelengths (Wilkie et al. 2014) —
    throughput/radiance are (N, K) rows, pure elementwise work, static shapes;
  * RGB scene data (albedo, emitter radiance) upsamples to smooth spectra
    via a partition-of-unity band basis, exact for gray (furnace-safe);
  * the film accumulates CIE XYZ (Monte-Carlo CMF weights) and develops to
    linear sRGB.

BSDF-sampling-only transport (the reference's simple.py structure,
/root/reference/simple.py:27-74).  Round 5 broadened the lobe coverage:
every BSDF's RGB sample weight — diffuse albedo (textured
included), GGX-conductor Fresnel tint, plastic, dielectric — upsamples to
a smooth spectrum through the same partition-of-unity band basis.
Upsampling is linear in RGB, so for diffuse this is exactly the old
upsample(albedo)-ratio formula, and gray data still upsamples to the
EXACT constant spectrum (furnace tests stay exact).  `strict=True` now
gates only BSDF kinds the RGB renderer itself doesn't know.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core import spectrum as sp
from ..core.rng import Sampler
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..render.emitter import eval_emitter, eval_environment
from ..scene.types import BSDFKind, Scene
from .common import register_integrator


@dataclasses.dataclass(frozen=True)
class SpectralIntegrator:
    max_depth: int = 8
    rr_depth: int = 4
    k: int = 4            # wavelengths per lane
    strict: bool = True   # raise if the scene has unknown BSDF kinds

    def check_scene(self, scene: Scene):
        if not self.strict:
            return
        kinds = getattr(scene.materials, "kinds_present", None)
        ok = set(range(BSDFKind.COUNT))
        if kinds is not None and not set(int(k) for k in kinds) <= ok:
            raise ValueError(
                "spectral integrator: scene has BSDF kinds outside the "
                f"known set ({sorted(set(int(x) for x in kinds) - ok)})"
            )

    def sample(self, scene: Scene, sampler: Sampler, ray, active=None):
        """Returns (xyz (N, 3), sampler): CIE XYZ estimate per lane."""
        n = ray.o.shape[0]
        if active is None:
            active = jnp.ones((n,), bool)

        sampler, u_lam = sampler.next_1d()
        lam, pdf = sp.sample_wavelengths(u_lam, self.k)   # (N, K)
        f = jnp.ones((n, self.k), m.Float)
        L = jnp.zeros((n, self.k), m.Float)

        si = ray_intersect(scene, ray, active)
        L = L + f * sp.upsample_rgb(eval_emitter(scene, si, active), lam)
        esc = active & ~si.valid
        L = L + f * sp.upsample_rgb(
            eval_environment(scene, esc, ray.d), lam
        )
        act = active & si.valid

        for depth in range(1, self.max_depth):
            sampler, u1 = sampler.next_1d()
            sampler, u2 = sampler.next_2d()
            bs, weight = bsdflib.sample(
                scene.materials, scene.textures, si, u1, u2, act
            )
            # spectral weight: upsample the RGB sample weight itself
            # (round 5) — upsampling is LINEAR in rgb, so for diffuse
            # (weight = albedo * scalar) this equals the old
            # upsample(albedo) * lum-ratio formula exactly, and it
            # extends unchanged to conductor Fresnel tints, plastic,
            # textured reflectance, and colorless dielectrics; gray
            # weights upsample to the exact constant (furnace-safe)
            w_spec = sp.upsample_rgb(weight, lam)
            f = f * jnp.where(act[:, None], w_spec, 1.0)

            # Russian roulette on the hero throughput
            fmax = jnp.max(f, axis=-1)
            rr_prob = jnp.minimum(fmax, 0.95)
            rr_active = jnp.full((n,), depth) >= self.rr_depth
            sampler, u_rr = sampler.next_1d()
            keep = ~rr_active | (u_rr < rr_prob)
            f = jnp.where(
                rr_active[:, None], f * m.safe_rcp(rr_prob)[:, None], f
            )
            act = act & keep & (fmax > 0.0)

            ray = si.spawn_ray(si.to_world(bs.wo))
            si = ray_intersect(scene, ray, act)
            L = L + jnp.where(
                act[:, None],
                f * sp.upsample_rgb(eval_emitter(scene, si, act), lam),
                0.0,
            )
            esc = act & ~si.valid
            L = L + jnp.where(
                esc[:, None],
                f * sp.upsample_rgb(eval_environment(scene, esc, ray.d),
                                    lam),
                0.0,
            )
            act = act & si.valid

        # CIE XYZ Monte-Carlo estimate over the K wavelengths
        wxyz = sp.spectrum_to_xyz_weight(lam, pdf, self.k)  # (N, K, 3)
        return jnp.sum(L[..., None] * wxyz, axis=1), sampler


register_integrator("spectral", SpectralIntegrator)


def render_spectral(scene: Scene, integrator=None, seed: int = 0,
                    spp: int = 16, chunk: int | None = None):
    """Full spectral render -> linear sRGB image (equal-energy white
    balance; see core/spectrum.py)."""
    integ = integrator or SpectralIntegrator()
    integ.check_scene(scene)
    w, h = scene.camera.resolution
    n = w * h * spp

    @partial(jax.jit, static_argnames=("n_lanes",))
    def pass_fn(scene, seed, off, film, *, n_lanes: int):
        idx = off + jnp.arange(n_lanes, dtype=jnp.uint32)
        valid = idx < jnp.uint32(n)
        pix = idx // jnp.uint32(spp)
        px = (pix % jnp.uint32(w)).astype(m.Float)
        py = (pix // jnp.uint32(w)).astype(m.Float)
        sampler = Sampler.create(seed, lane=idx)
        sampler, jit2 = sampler.next_2d()
        pos = jnp.stack([px, py], axis=-1) + jit2
        ray = sensorlib.sample_ray(scene.camera, pos)
        xyz, _ = integ.sample(scene, sampler, ray, valid)
        return filmlib.put(
            film, pos, jnp.where(jnp.isfinite(xyz), xyz, 0.0),
            active=valid, rfilter="box",
        )

    film = filmlib.new_film(w, h)
    c = chunk or n
    for off in range(0, n, c):
        film = pass_fn(scene, jnp.uint32(seed), jnp.uint32(off), film,
                       n_lanes=c)
    xyz_img = filmlib.develop(film)
    return jnp.clip(sp.xyz_to_srgb(xyz_img), 0.0, None)
