"""Integrator protocol + render driver.

The Mitsuba integrator contract (`sample(scene, sampler, ray, active) ->
(L, valid, aovs)` + `render(...)`, /root/reference/path.py:194-302 and the
commented render port at path.py:103-192) becomes: an integrator is a config
dataclass with a pure `sample` function; `render` is the wavefront driver —
one jitted pass per spp batch, film threaded functionally (donated), all
bounces compiled into one XLA program per pass.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.rng import Sampler
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..scene.types import Scene

_REGISTRY: dict[str, type] = {}


def register_integrator(name: str, cls):
    """mi.register_integrator analog (/root/reference/path.py:305)."""
    _REGISTRY[name] = cls
    return cls


def make_integrator(props: dict):
    """mi.load_dict({'type': name, ...}) analog for integrators."""
    props = dict(props)
    t = props.pop("type")
    cls = _REGISTRY[t]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in props.items() if k in fields})


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta=2) — mirrors path.py:10-18 incl. the
    finite-guard and detach."""
    a2 = pdf_a * pdf_a
    w = m.safe_div(a2, a2 + pdf_b * pdf_b)
    return jax.lax.stop_gradient(jnp.where(jnp.isfinite(w), w, 0.0))


@functools.partial(
    jax.jit,
    static_argnames=("integrator", "spp_per_pass", "rfilter", "chunk"),
    donate_argnums=(4,),
)
def render_pass(scene: Scene, integrator, seed, pass_idx, film,
                spp_per_pass: int = 1, rfilter: str = "box",
                chunk: int | None = None, lane_offset=0):
    """One wavefront launch: `chunk` camera rays starting at `lane_offset`
    (default: the whole W*H*spp_per_pass wavefront) -> film splats.

    Chunking bounds the per-launch memory; a fixed chunk compiles once and
    is reused for every chunk of every pass (lane_offset is traced, chunk
    is static).
    """
    w, h = scene.camera.resolution
    n = w * h * spp_per_pass
    if chunk is None:
        chunk = n
    lane = jnp.arange(chunk, dtype=jnp.uint32) + jnp.uint32(lane_offset)
    in_range = lane < n
    pix = lane // spp_per_pass
    px = (pix % w).astype(m.Float)
    py = (pix // w).astype(m.Float)

    sampler = Sampler.create(seed, lane=lane + jnp.uint32(n) * pass_idx)
    sampler, jitter = sampler.next_2d()
    pos = jnp.stack([px, py], axis=-1) + jitter

    ray = sensorlib.sample_ray(scene.camera, pos)
    L, valid, sampler = integrator.sample(scene, sampler, ray, in_range)
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    return filmlib.put(film, pos, L, active=in_range, rfilter=rfilter)


def render(scene: Scene, integrator, seed: int = 0, spp: int = 16,
           rfilter: str | None = None, spp_per_pass: int | None = None,
           chunk: int | None = None):
    """Full render: loops passes (and optionally fixed-size lane chunks) on
    the host — the reference's n_passes loop, path.py:172-179."""
    w, h = scene.camera.resolution
    if spp_per_pass is None:
        # keep the wavefront around <= 2^21 lanes
        spp_per_pass = max(1, min(spp, (1 << 21) // max(w * h, 1)))
    while spp % spp_per_pass:
        spp_per_pass -= 1
    n_passes = spp // spp_per_pass
    rfilter = rfilter or "box"
    n = w * h * spp_per_pass

    film = filmlib.new_film(w, h)
    for p in range(n_passes):
        if chunk is None:
            film = render_pass(
                scene, integrator, jnp.uint32(seed), jnp.uint32(p), film,
                spp_per_pass=spp_per_pass, rfilter=rfilter,
            )
        else:
            for off in range(0, n, chunk):
                film = render_pass(
                    scene, integrator, jnp.uint32(seed), jnp.uint32(p), film,
                    spp_per_pass=spp_per_pass, rfilter=rfilter,
                    chunk=chunk, lane_offset=jnp.uint32(off),
                )
    return filmlib.develop(film)
