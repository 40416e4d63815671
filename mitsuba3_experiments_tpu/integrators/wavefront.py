"""Staged wavefront path tracer: per-bounce launches + ray regeneration.

The single-program design — `lax.while_loop` over bounces, all lanes
lockstep until the LAST one dies — is divergence-bound: most lanes idle
behind the longest path.  This module is the classic *wavefront*
formulation (SURVEY.md §7 north star; the reference's analog is
`dr.reorder_threads` coherence sorting in its hot loop,
/root/reference/nerad.py:225):

  * one **bounce program** advances every lane exactly one bounce
    (trace -> emission MIS -> NEE+shadow -> BSDF sample -> RR), splatting
    lanes that die to the film inside the launch;
  * between launches, dead lanes are **regenerated** with fresh camera rays
    from the global ray stream (prefix-sum ranked refill, fixed shapes) so
    the wavefront stays full — no lane ever waits out another lane's path;
  * optionally the resident state is **sorted by a coherence key**
    (depth, direction octant) so each fixed-size chunk launch traverses
    like-minded rays, cutting the lockstep max of the inner traversal loop.

The integrator semantics are the ray-first MIS formulation
(/root/reference/path-mis.py:24-155): the state caches the previous bounce's
BSDF pdf/delta flag, and emitter hits are MIS-weighted against it.  RNG
dimensions are assigned per (camera ray, surface depth) exactly as
`PathIntegrator.sample` consumes them, so this renderer reproduces
`render()`'s per-ray estimates.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.records import BSDFFlags, Ray, has_flag
from ..core.rng import Sampler
from ..core.struct import jstruct
from ..intersect import ray_intersect
from ..render import bsdf as bsdflib
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..render.emitter import (
    eval_emitter,
    eval_environment,
    pdf_emitter_direction,
    pdf_environment_direction,
    sample_emitter_direction,
)
from ..scene.types import Scene
from .common import mis_weight


@jstruct
class WavefrontState:
    """Per-lane resident path state between bounce launches."""

    ray_o: jnp.ndarray      # (N, 3) current ray origin
    ray_d: jnp.ndarray      # (N, 3) current ray direction
    prev_p: jnp.ndarray     # (N, 3) surface point the ray left (MIS pdf ref)
    L: jnp.ndarray          # (N, 3) accumulated radiance
    f: jnp.ndarray          # (N, 3) path throughput
    eta: jnp.ndarray        # (N,)   relative refractive index product
    depth: jnp.ndarray      # (N,)   int32: depth of the surface this ray hits
    prev_pdf: jnp.ndarray   # (N,)   solid-angle pdf of the prev BSDF sample
    prev_delta: jnp.ndarray  # (N,)  bool: prev sample was a delta lobe
    idx: jnp.ndarray        # (N,)   uint32 global camera-ray index (RNG lane)
    pos: jnp.ndarray        # (N, 2) film position of the path's pixel sample
    alive: jnp.ndarray      # (N,)   bool

    @staticmethod
    def empty(n: int):
        def z3():
            # distinct buffers: donated arguments may not alias
            return jnp.zeros((n, 3), m.Float)

        return WavefrontState(
            ray_o=z3(), ray_d=z3(), prev_p=z3(), L=z3(),
            f=jnp.ones((n, 3), m.Float),
            eta=jnp.ones((n,), m.Float), depth=jnp.ones((n,), jnp.int32),
            prev_pdf=jnp.ones((n,), m.Float),
            prev_delta=jnp.ones((n,), bool),
            idx=jnp.zeros((n,), jnp.uint32), pos=jnp.zeros((n, 2), m.Float),
            alive=jnp.zeros((n,), bool),
        )


def _rand(seed, idx, dim_vec, n_draw: int):
    """Counter-based uniforms with a PER-LANE dimension counter.

    Same construction as core.rng.Sampler._draw_bits (tea32 over (seed, dim)
    then pcg over the lane) so a wavefront lane at surface depth d draws
    bit-identical values to the lockstep integrator's sampler, whose scalar
    dim advances uniformly per bounce iteration.
    """
    from ..core.rng import pcg_hash, tea32

    outs = []
    for k in range(n_draw):
        k0, k1 = tea32(seed, dim_vec + jnp.uint32(k))
        bits = pcg_hash(pcg_hash(idx ^ k0) + k1)
        outs.append((bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24)))
    return outs[0] if n_draw == 1 else jnp.stack(outs, axis=-1)


def _refill_impl(scene: Scene, st: WavefrontState, film, next_ray,
                 seed, *, spp: int, n_total: int):
    """Replace dead lanes with fresh camera rays from the global stream.

    Dead lanes are ranked by an exclusive prefix sum; rank r takes ray index
    `next_ray + r` while it is < n_total.  Fixed shapes, fully vectorized.
    Returns (state, film, new_next_ray) — film is untouched (threaded for
    donation symmetry); the cursor lives on device so the render loop never
    syncs per round.
    """
    dead = ~st.alive
    rank = jnp.cumsum(dead.astype(jnp.int32)) - dead.astype(jnp.int32)
    new_idx = next_ray + rank.astype(jnp.uint32)
    take = dead & (new_idx < jnp.uint32(n_total))

    w, h = scene.camera.resolution
    pix = new_idx // jnp.uint32(spp)
    px = (pix % jnp.uint32(w)).astype(m.Float)
    py = (pix // jnp.uint32(w)).astype(m.Float)
    jitter = _rand(seed, new_idx, jnp.zeros_like(new_idx), 2)
    pos = jnp.stack([px, py], axis=-1) + jitter
    ray = sensorlib.sample_ray(scene.camera, pos)

    def sel(a, b):
        t = take
        if a.ndim > 1:
            t = take[:, None]
        return jnp.where(t, a, b)

    n = st.alive.shape[0]
    st = WavefrontState(
        ray_o=sel(ray.o, st.ray_o),
        ray_d=sel(ray.d, st.ray_d),
        prev_p=sel(ray.o, st.prev_p),
        L=sel(jnp.zeros((n, 3), m.Float), st.L),
        f=sel(jnp.ones((n, 3), m.Float), st.f),
        eta=sel(jnp.ones((n,), m.Float), st.eta),
        depth=sel(jnp.ones((n,), jnp.int32), st.depth),
        prev_pdf=sel(jnp.ones((n,), m.Float), st.prev_pdf),
        prev_delta=sel(jnp.ones((n,), bool), st.prev_delta),
        idx=sel(new_idx, st.idx),
        pos=sel(pos, st.pos),
        alive=st.alive | take,
    )
    # the stream cursor advances on device: no host sync per round
    return st, film, next_ray + jnp.sum(take.astype(jnp.uint32))


def _sort_impl(st: WavefrontState):
    """Coherence sort of the resident wavefront.

    Key (major to minor): dead lanes last, surface depth, direction octant —
    so each fixed-size chunk launch processes rays of the same generation
    heading the same way (the reorder_threads analog, nerad.py:225).
    """
    octant = (
        (st.ray_d[:, 0] > 0).astype(jnp.uint32)
        | ((st.ray_d[:, 1] > 0).astype(jnp.uint32) << 1)
        | ((st.ray_d[:, 2] > 0).astype(jnp.uint32) << 2)
    )
    key = (
        (~st.alive).astype(jnp.uint32) << 31
        | (jnp.minimum(st.depth, 255).astype(jnp.uint32) << 23)
        | (octant << 20)
    )
    order = jnp.argsort(key)
    return jax.tree_util.tree_map(
        lambda a: jnp.take(a, order, axis=0), st
    )


def _bounce_impl(scene: Scene, st: WavefrontState, film, seed, *,
                 max_depth: int, rr_depth: int, rfilter: str,
                 chunk: int | None = None, offset=0):
    """Advance `chunk` lanes (all by default) by exactly one bounce.

    trace -> emission MIS (vs cached prev bounce pdf, path-mis.py:44-47)
    -> NEE with shadow ray -> BSDF sample -> RR -> next ray; lanes that die
    splat their L to the film in this launch.
    """
    full = st
    if chunk is not None:
        st = jax.tree_util.tree_map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, offset, chunk, 0), st
        )

    mats, tex = scene.materials, scene.textures
    alive = st.alive
    ray = Ray.make(st.ray_o, st.ray_d)
    si = ray_intersect(scene, ray, alive)
    hit = alive & si.valid

    # ---------------- emission at the hit (ray-first MIS) ----------------
    ref = SimpleNamespace(p=st.prev_p)
    gate = alive & (st.prev_pdf > 0.0)
    em_pdf = pdf_emitter_direction(scene, ref, si, gate & ~st.prev_delta)
    mis_hit = jnp.where(st.prev_delta, 1.0, mis_weight(st.prev_pdf, em_pdf))
    L = st.L + jnp.where(
        (gate & hit)[:, None],
        st.f * eval_emitter(scene, si, hit) * mis_hit[:, None], 0.0,
    )
    esc = alive & ~si.valid & (st.prev_pdf > 0.0)
    env_pdf = pdf_environment_direction(scene, st.ray_d, esc & ~st.prev_delta)
    mis_env = jnp.where(st.prev_delta, 1.0, mis_weight(st.prev_pdf, env_pdf))
    L = L + jnp.where(
        esc[:, None],
        st.f * eval_environment(scene, esc, st.ray_d) * mis_env[:, None], 0.0,
    )

    # ------------------------- NEE at the surface ------------------------
    cont = hit & (st.depth < max_depth)
    base = jnp.uint32(2) + jnp.uint32(6) * (st.depth - 1).astype(jnp.uint32)
    flags = bsdflib.bsdf_flags(mats, si.mat_id)
    active_em = cont & has_flag(flags, BSDFFlags.Smooth)

    u_em = _rand(seed, st.idx, base, 2)
    ds, em_weight = sample_emitter_direction(scene, si, u_em, True, active_em)
    active_em &= ds.pdf != 0.0
    wo = si.to_local(ds.d)

    u1 = _rand(seed, st.idx, base + jnp.uint32(2), 1)
    u2 = _rand(seed, st.idx, base + jnp.uint32(3), 2)
    bsdf_val, bsdf_pdf, bs, bsdf_weight = bsdflib.eval_pdf_sample(
        mats, tex, si, wo, u1, u2, cont
    )
    mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
    L = L + jnp.where(
        active_em[:, None],
        st.f * bsdf_val * em_weight * mis_em[:, None], 0.0,
    )

    # ------------------- BSDF bounce + Russian roulette ------------------
    f = st.f * bsdf_weight
    eta = st.eta * bs.eta
    fmax = m.max_component(f)
    rr_prob = jnp.minimum(fmax * eta * eta, 0.95)
    rr_active = st.depth >= rr_depth
    u_rr = _rand(seed, st.idx, base + jnp.uint32(5), 1)
    rr_continue = u_rr < rr_prob
    f = jnp.where(
        rr_active[:, None],
        f * m.safe_rcp(jax.lax.stop_gradient(rr_prob))[:, None], f,
    )
    cont2 = cont & (fmax != 0.0) & (~rr_active | rr_continue)

    ray2 = si.spawn_ray(si.to_world(bs.wo))

    # ----------------------- retire / splat the dead ----------------------
    died = alive & ~cont2
    film = filmlib.put(film, st.pos, jnp.where(jnp.isfinite(L), L, 0.0),
                       active=died, rfilter=rfilter)

    st = WavefrontState(
        ray_o=jnp.where(cont2[:, None], ray2.o, st.ray_o),
        ray_d=jnp.where(cont2[:, None], ray2.d, st.ray_d),
        prev_p=jnp.where(cont2[:, None], si.p, st.prev_p),
        L=L,
        f=jnp.where(cont2[:, None], f, st.f),
        eta=jnp.where(cont2, eta, st.eta),
        depth=jnp.where(cont2, st.depth + 1, st.depth),
        prev_pdf=jnp.where(cont2, bs.pdf, st.prev_pdf),
        prev_delta=jnp.where(
            cont2, has_flag(bs.sampled_type, BSDFFlags.Delta), st.prev_delta
        ),
        idx=st.idx,
        pos=st.pos,
        alive=cont2,
    )

    if chunk is not None:
        st = jax.tree_util.tree_map(
            lambda full_a, a: jax.lax.dynamic_update_slice_in_dim(
                full_a, a, offset, 0
            ),
            full, st,
        )
    return st, film


# thin jitted wrappers for the individual stages (kept for the per-stage
# launch mode and unit tests)
_refill = partial(jax.jit, static_argnames=("spp", "n_total"),
                  donate_argnums=(1, 2))(_refill_impl)
_sort_state = partial(jax.jit, donate_argnums=(0,))(_sort_impl)
_bounce = partial(
    jax.jit, static_argnames=("max_depth", "rr_depth", "rfilter", "chunk"),
    donate_argnums=(1, 2),
)(_bounce_impl)


@partial(
    jax.jit,
    static_argnames=(
        "spp", "n_total", "max_depth", "rr_depth", "rfilter", "chunk",
        "sort", "n_rounds",
    ),
    donate_argnums=(1, 2, 3),
)
def _run_rounds(scene: Scene, st: WavefrontState, film, next_ray, seed, *,
                spp: int, n_total: int, max_depth: int, rr_depth: int,
                rfilter: str, chunk: int | None, sort: bool, n_rounds: int):
    """n_rounds fused rounds in ONE dispatch: (sort ->) refill -> bounce
    over all chunks, scanned on device.

    The per-stage mode costs ~4-7 host dispatches per round.  Fusing a
    round into one program and scanning n_rounds of them cuts dispatch
    overhead by n_rounds x dispatches-per-round.

    Exhausted wavefronts make every stage a no-op (refill takes nothing,
    the traversal while_loop exits on entry, dead lanes splat nothing), so
    overshooting the needed round count is cheap and bias-free.
    """
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rfilter=rfilter)
    n_lanes = st.alive.shape[0]

    def one_round(carry, _):
        st, film, next_ray = carry
        if sort:
            st = _sort_impl(st)
        st, film, next_ray = _refill_impl(
            scene, st, film, next_ray, seed, spp=spp, n_total=n_total
        )
        if chunk is None:
            st, film = _bounce_impl(scene, st, film, seed, **kw)
        else:
            def chunk_body(i, sf):
                st, film = sf
                return _bounce_impl(
                    scene, st, film, seed, chunk=chunk, offset=i * chunk,
                    **kw,
                )

            st, film = jax.lax.fori_loop(
                0, n_lanes // chunk, chunk_body, (st, film)
            )
        return (st, film, next_ray), None

    (st, film, next_ray), _ = jax.lax.scan(
        one_round, (st, film, next_ray), None, length=n_rounds
    )
    return st, film, next_ray


@jax.jit
def _poll(st: WavefrontState, next_ray):
    return jnp.sum(st.alive.astype(jnp.int32)), next_ray


def render_wavefront(scene: Scene, seed: int = 0, spp: int = 16,
                     max_depth: int = 16, rr_depth: int = 4,
                     rfilter: str = "box", n_lanes: int = 32768,
                     chunk: int | None = None, sort_every: int = 1,
                     poll_every: int = 24, rounds_per_launch: int = 1):
    """Full-frame render with a persistent, regenerating wavefront.

    n_lanes resident lanes advance one bounce per round; dead lanes refill
    from the global (pixel x spp) ray stream each round.  `chunk` splits the
    bounce into fixed-size sub-launches (compile-size control + coherence
    payoff when `sort_every` > 0 re-sorts the resident state — sorting puts
    fresh camera rays in one contiguous coherent block and groups survivors
    by depth/octant).  `rounds_per_launch` > 1 fuses that many rounds into
    one device dispatch via lax.scan (_run_rounds) — the host only syncs a
    cursor poll between launches.  With rounds_per_launch == 1 the stages
    launch individually (useful for debugging / stage timing).
    """
    w, h = scene.camera.resolution
    n_total = w * h * spp
    n_lanes = min(n_lanes, n_total)
    if chunk is not None:
        chunk = min(chunk, n_lanes)
        n_lanes = (n_lanes // chunk) * chunk

    seed_u = jnp.uint32(seed)
    film = filmlib.new_film(w, h)
    st = WavefrontState.empty(n_lanes)
    next_ray = jnp.zeros((), jnp.uint32)
    rounds = 0
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rfilter=rfilter)

    if rounds_per_launch > 1:
        if sort_every not in (0, 1):
            raise ValueError(
                "fused mode supports sort_every in {0, 1} only"
            )
        while True:
            st, film, next_ray = _run_rounds(
                scene, st, film, next_ray, seed_u,
                spp=spp, n_total=n_total, chunk=chunk,
                sort=bool(sort_every), n_rounds=rounds_per_launch, **kw,
            )
            n_alive, cursor = jax.device_get(_poll(st, next_ray))
            if int(cursor) >= n_total and int(n_alive) == 0:
                break
        return filmlib.develop(film)

    # expected rounds if the wavefront stayed perfectly full; used to size
    # the first poll so typical renders sync only a handful of times
    while True:
        if sort_every and rounds and rounds % sort_every == 0:
            st = _sort_state(st)
        st, film, next_ray = _refill(
            scene, st, film, next_ray, seed_u, spp=spp, n_total=n_total,
        )
        if chunk is None:
            st, film = _bounce(scene, st, film, seed_u, **kw)
        else:
            for off in range(0, n_lanes, chunk):
                st, film = _bounce(
                    scene, st, film, seed_u, chunk=chunk, offset=off, **kw
                )
        rounds += 1
        if rounds % poll_every == 0:
            n_alive, cursor = jax.device_get(_poll(st, next_ray))
            if int(cursor) >= n_total and int(n_alive) == 0:
                break
    return filmlib.develop(film)
