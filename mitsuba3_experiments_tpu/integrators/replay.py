"""Path-replay differentiable rendering: record fast, differentiate cheap.

BASELINE.md's primary metric is forward+backward rays/s, and the plain
grad path differentiates a rematerialized lockstep scan — every backward
pass re-runs BVH traversal inside the AD graph.  But the sampling is
DETACHED (stop-gradient discipline, as the reference's detached-sampling
path tracer, /root/reference/path.py:238-300): the path geometry — hit
points, sampled directions, RR decisions — is constant w.r.t. the
differentiated parameters (material tables, emitter radiance).  So the
traversal never needs to be inside the AD graph at all:

  1. RECORD (non-differentiable, persistent state machine): trace one
     camera ray per lane with integrators/persistent.py (no refill) and
     record, per (lane, path depth): the hit primitive id + barycentrics,
     and the NEE shadow ray's occlusion bit.  Everything else — camera
     jitter, emitter pick, BSDF sample, RR — reconstructs from the
     counter-based RNG (core/rng.py) keyed by (camera index, depth).
  2. REPLAY (differentiable, no traversal): a lax.scan over depth rebuilds
     the estimator exactly as the forward did — _make_si from the recorded
     (prim, u, v), emission MIS, NEE with the recorded visibility, BSDF
     throughput, RR reweighting — with gradients flowing through the
     material/emitter table reads only.

The replayed radiance is bit-comparable to render() (same arithmetic, same
RNG dims — tested), and grads match the scan-AD integrator (tested).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.records import BSDFFlags, Ray, has_flag
from ..core.struct import jstruct
from ..intersect.bvh_jax import _make_si
from ..render import bsdf as bsdflib
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..render.emitter import (
    eval_emitter,
    eval_environment,
    pdf_emitter_direction_packed,
    pdf_environment_direction,
    sample_emitter_direction,
)
from ..scene.types import Scene
from .common import mis_weight
from .wavefront import _rand
from . import persistent as pp


def _prim_encode(prim):
    """int32 prim id -> f32 whose BIT PATTERN is a normal float.

    Raw bitcast prim ids are subnormal patterns (ids < 2^23) and the -1
    miss marker is a NaN payload — a float datapath that flushes
    subnormals or canonicalizes NaNs corrupts them (the accelerator this
    system was first built for did so on 0.77% of flagship rays).  On the
    GPU the tag is kept; the on-device record-vs-render checks
    (validation/checks.py) guard it.  (prim+1) | 0x40000000 maps
    every id (and -1 -> 0) into [2.0, 4.0)-ish normal floats, immune to
    flush-to-zero and NaN canonicalization, for face counts < ~10^9."""
    return jax.lax.bitcast_convert_type(
        (prim + 1) | jnp.int32(0x40000000), jnp.float32
    )


def _prim_decode(f):
    return (jax.lax.bitcast_convert_type(f, jnp.int32)
            & jnp.int32(0x3FFFFFFF)) - 1


@jstruct
class PathRecord:
    """Per-(lane, depth) traced-path facts the replay cannot reconstruct."""

    prim: jnp.ndarray  # (N, D) i32 hit face id, -1 = miss/not traced
    u: jnp.ndarray     # (N, D) f32 barycentric
    v: jnp.ndarray     # (N, D) f32
    occl: jnp.ndarray  # (N, D) bool NEE shadow ray occluded

    @staticmethod
    def empty(n: int, d: int):
        return PathRecord(
            prim=jnp.full((n, d), -1, jnp.int32),
            u=jnp.zeros((n, d), jnp.float32),
            v=jnp.zeros((n, d), jnp.float32),
            occl=jnp.zeros((n, d), bool),
        )


def _retire_record(st: pp.PersistentState, occl, sh_depth, colD):
    """pp._retire for the recorder: resolve shadow completions from the
    round's LAST stepper iteration (recording their occlusion bit), advance
    or retire — no film (the replay splats)."""
    import dataclasses

    finB = st.alive & (st.phase == pp.P_SHADOW) & (st.tr_cur == pp.DONE)
    occluded = st.tr_face >= 0
    occl = occl | (
        (colD == (sh_depth - 1)[:, None]) & (finB & occluded)[:, None]
    )
    L = st.L + jnp.where((finB & ~occluded)[:, None], st.nee_L, 0.0)
    advance = finB & st.cont
    retire = (st.alive & (st.phase == pp.P_RETIRE)) | (finB & ~st.cont)
    st = dataclasses.replace(
        st,
        L=jnp.where(finB[:, None], L, st.L),
        alive=st.alive & ~retire,
        phase=jnp.where(advance, pp.P_TRACE, st.phase),
    )
    st = pp._start_traversal(
        st, advance, st.next_o, st.next_d, jnp.full_like(st.tr_t, jnp.inf)
    )
    return st, occl


@partial(
    jax.jit,
    static_argnames=("n_nodes", "max_depth", "rr_depth", "steps",
                     "n_rounds"),
    donate_argnums=(1, 2, 3),
)
def _run_record(scene: Scene, st: pp.PersistentState, rec: PathRecord,
                sh_depth, seed, unified, *, n_nodes: int, max_depth: int,
                rr_depth: int, steps: int, n_rounds: int):
    colD = jnp.arange(rec.prim.shape[1], dtype=jnp.int32)[None, :]

    def one_round(carry, _):
        import dataclasses

        st, rec, sh_depth = carry
        st, occl = _retire_record(st, rec.occl, sh_depth, colD)
        doneA = st.alive & (st.phase == pp.P_TRACE) & (st.tr_cur == pp.DONE)
        sel = (colD == (st.depth - 1)[:, None]) & doneA[:, None]
        rec = dataclasses.replace(
            rec,
            prim=jnp.where(sel, st.tr_face[:, None], rec.prim),
            u=jnp.where(sel, st.tr_u[:, None], rec.u),
            v=jnp.where(sel, st.tr_v[:, None], rec.v),
            occl=occl,
        )
        sh_depth = jnp.where(doneA, st.depth, sh_depth)
        st = pp._transition_trace(
            scene, st, seed, max_depth=max_depth, rr_depth=rr_depth
        )
        st, occl = pp._trav_steps(
            unified, n_nodes, st, steps, occl=rec.occl, sh_depth=sh_depth,
            layout=scene.bvh.layout,
        )
        rec = dataclasses.replace(rec, occl=occl)
        return (st, rec, sh_depth), None

    (st, rec, sh_depth), _ = jax.lax.scan(
        one_round, (st, rec, sh_depth), None, length=n_rounds
    )
    return st, rec, sh_depth


def record_chunk(scene: Scene, seed, idx0: int, n: int, *, spp: int,
                 max_depth: int, rr_depth: int, steps: int = 16,
                 rounds_per_launch: int = 8, ray_end=None):
    """Trace camera rays [idx0, idx0+n) — one per lane, no refill — and
    return their PathRecord."""
    st = pp.PersistentState.empty(
        n, stack_depth=None if scene.bvh.layout is None
        else scene.bvh.layout.stack)
    seed_u = jnp.uint32(seed)
    if ray_end is None:
        ray_end = idx0 + n
    # arm lane i with camera ray idx0 + i (all lanes dead -> rank = lane)
    st, _ = pp._refill_persistent(
        scene, st, jnp.uint32(idx0), seed_u, spp=spp,
        ray_end=jnp.uint32(ray_end),
    )
    rec = PathRecord.empty(n, max_depth)
    sh_depth = jnp.ones((n,), jnp.int32)
    unified, n_nodes = pp.unify_tables(scene.bvh)
    while True:
        st, rec, sh_depth = _run_record(
            scene, st, rec, sh_depth, seed_u, unified, n_nodes=n_nodes,
            max_depth=max_depth, rr_depth=rr_depth, steps=steps,
            n_rounds=rounds_per_launch,
        )
        if int(jax.device_get(jnp.sum(st.alive.astype(jnp.int32)))) == 0:
            break
    return rec


@partial(
    jax.jit,
    static_argnames=("n_nodes", "max_depth", "rr_depth", "steps",
                     "n_rounds", "spp"),
    donate_argnums=(1, 2, 3, 4, 5),
)
def _run_record_full(scene: Scene, st: pp.PersistentState, loc: PathRecord,
                     glob: PathRecord, sh_depth, next_ray, seed, ray_end,
                     unified, idx0=0, *, n_nodes: int, max_depth: int,
                     rr_depth: int, steps: int, n_rounds: int, spp: int):
    """Full-frame recorder rounds: the persistent machine WITH refill.

    record_chunk records one camera ray per lane and runs until the LAST
    lane finishes — a straggler-bound launch repeated n_rays/n_lanes times
    per frame.  Here lanes record into lane-local rows (exactly as
    _run_record) and, on retire, FLUSH the finished ray's rows into the
    frame-sized PACKED record (one (N, D, 4) f32 scatter per round) at its
    camera-ray index, so the lane immediately refills with a fresh ray.
    Recording then proceeds at the forward renderer's full rate.
    `glob` is the packed (rows+1, D, 4) array; record_full unpacks it.
    `idx0` is the camera-ray index of glob row 0 (device slice offset when
    sharded — parallel/mesh.sharded_replay_grad)."""
    import dataclasses

    colD = jnp.arange(loc.prim.shape[1], dtype=jnp.int32)[None, :]
    n_pad = glob.shape[0] - 1  # dummy row absorbing non-flush writes

    def one_round(carry, _):
        st, loc, glob, sh_depth, next_ray = carry
        was_alive = st.alive
        st, occl = _retire_record(st, loc.occl, sh_depth, colD)
        loc = dataclasses.replace(loc, occl=occl)

        # flush rays that just retired into their global rows — the four
        # record fields are packed into ONE (N, D, 4) f32 row scatter
        # (prim bitcast, occl as 0/1): one wide scatter instead of four
        # narrow ones.
        # INVARIANT: channel 0 of `packed`/`glob` holds int32
        # prim ids bit-cast to f32 — subnormal bit patterns for ids < 2^23
        # and NaN for the -1 miss marker.  Every op touching these arrays
        # must remain pure data movement (stack/scatter/slice/bitcast):
        # any arithmetic or select-with-math on channel 0 would flush
        # subnormals to zero or canonicalize the NaN, silently
        # corrupting prim ids.  tests/test_replay.py::
        # test_record_full_matches_record_chunk guards this bit-exactly.
        flush = was_alive & ~st.alive
        dst = jnp.where(flush, st.idx - jnp.uint32(idx0), jnp.uint32(n_pad))
        packed = jnp.stack(
            [
                _prim_encode(loc.prim),
                loc.u,
                loc.v,
                loc.occl.astype(jnp.float32),
            ],
            axis=-1,
        )
        glob = glob.at[dst].set(packed)

        # record the closest hit for lanes entering shading
        doneA = st.alive & (st.phase == pp.P_TRACE) & (st.tr_cur == pp.DONE)
        sel = (colD == (st.depth - 1)[:, None]) & doneA[:, None]
        loc = dataclasses.replace(
            loc,
            prim=jnp.where(sel, st.tr_face[:, None], loc.prim),
            u=jnp.where(sel, st.tr_u[:, None], loc.u),
            v=jnp.where(sel, st.tr_v[:, None], loc.v),
        )
        sh_depth = jnp.where(doneA, st.depth, sh_depth)
        st = pp._transition_trace(
            scene, st, seed, max_depth=max_depth, rr_depth=rr_depth
        )

        # refill dead lanes; clear their local record rows
        alive_before = st.alive
        st, next_ray = pp._refill_persistent(
            scene, st, next_ray, seed, spp=spp, ray_end=ray_end
        )
        took = st.alive & ~alive_before
        t = took[:, None]
        loc = PathRecord(
            prim=jnp.where(t, -1, loc.prim),
            u=jnp.where(t, 0.0, loc.u),
            v=jnp.where(t, 0.0, loc.v),
            occl=jnp.where(t, False, loc.occl),
        )
        sh_depth = jnp.where(took, 1, sh_depth)

        st, occl = pp._trav_steps(
            unified, n_nodes, st, steps, occl=loc.occl, sh_depth=sh_depth,
            layout=scene.bvh.layout,
        )
        loc = dataclasses.replace(loc, occl=occl)
        return (st, loc, glob, sh_depth, next_ray), None

    (st, loc, glob, sh_depth, next_ray), _ = jax.lax.scan(
        one_round, (st, loc, glob, sh_depth, next_ray), None,
        length=n_rounds,
    )
    return st, loc, glob, sh_depth, next_ray


def record_full(scene: Scene, seed, n_rays: int, *, spp: int,
                max_depth: int, rr_depth: int, steps: int = 16,
                rounds_per_launch: int = 8, n_lanes: int = 32768,
                pad_to: int | None = None):
    """Record ALL camera rays [0, n_rays) in one refilled persistent pass.

    Returns a PathRecord of `pad_to` rows (>= n_rays; rows past n_rays stay
    empty: prim=-1 -> replay treats them as misses and `ray_end` gates
    their film contribution to zero)."""
    n_lanes = min(n_lanes, n_rays)
    rows = max(pad_to or n_rays, n_rays)
    st = pp.PersistentState.empty(
        n_lanes, stack_depth=None if scene.bvh.layout is None
        else scene.bvh.layout.stack)
    loc = PathRecord.empty(n_lanes, max_depth)
    # packed global record (+1 dummy flush row); channel 0 carries
    # _prim_encode'd ids (normal-float bit patterns; see _prim_encode)
    glob = jnp.tile(
        jnp.concatenate([
            _prim_encode(jnp.full((1,), -1, jnp.int32)),
            jnp.zeros((3,), jnp.float32),
        ]),
        (rows + 1, max_depth, 1),
    )
    sh_depth = jnp.ones((n_lanes,), jnp.int32)
    next_ray = jnp.zeros((), jnp.uint32)
    seed_u = jnp.uint32(seed)
    unified, n_nodes = pp.unify_tables(scene.bvh)
    while True:
        st, loc, glob, sh_depth, next_ray = _run_record_full(
            scene, st, loc, glob, sh_depth, next_ray, seed_u,
            jnp.uint32(n_rays), unified, n_nodes=n_nodes,
            max_depth=max_depth, rr_depth=rr_depth, steps=steps,
            n_rounds=rounds_per_launch, spp=spp,
        )
        n_alive, cursor = jax.device_get(pp._poll(st, next_ray))
        if int(cursor) >= n_rays and int(n_alive) == 0:
            break
    glob = glob[:rows]
    return PathRecord(
        prim=_prim_decode(glob[:, :, 0]),
        u=glob[:, :, 1],
        v=glob[:, :, 2],
        occl=glob[:, :, 3] != 0.0,
    )


def replay_grads_full(scene: Scene, params: dict, update_fn, target,
                      seed, rec: PathRecord, n_rays: int, *, chunk: int,
                      spp: int, max_depth: int, rr_depth: int,
                      rfilter: str = "box", fused: bool = True):
    """Grad accumulation over a full-frame PathRecord in uniform chunks
    (rec must be padded to a multiple of `chunk` — see record_full).

    fused=True runs the whole chunk loop as ONE jitted lax.scan over the
    (n_chunks, chunk, D)-reshaped record: identical math, but the host
    dispatch is paid once instead of once per chunk (29 chunks on the
    flagship frame).  fused=False keeps the per-chunk dispatch loop for
    A/B."""
    rows = rec.prim.shape[0]
    assert rows % chunk == 0, (rows, chunk)
    if fused:
        n_chunks = rows // chunk
        rec3 = jax.tree_util.tree_map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), rec
        )
        offs = jnp.arange(n_chunks, dtype=jnp.uint32) * jnp.uint32(chunk)
        ends = jnp.minimum(offs + jnp.uint32(chunk), jnp.uint32(n_rays))
        return _replay_grads_fused(
            scene, params, rec3, target, jnp.uint32(seed), offs, ends,
            update_fn=update_fn, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, rfilter=rfilter,
        )
    acc = None
    for off in range(0, rows, chunk):
        sl = jax.tree_util.tree_map(lambda a: a[off:off + chunk], rec)
        g = _replay_grad_jit(
            scene, params, sl, target, jnp.uint32(seed), jnp.uint32(off),
            jnp.uint32(min(off + chunk, n_rays)), update_fn=update_fn,
            spp=spp, max_depth=max_depth, rr_depth=rr_depth,
            rfilter=rfilter,
        )
        acc = g if acc is None else jax.tree_util.tree_map(
            jnp.add, acc, g
        )
    return acc


@partial(
    jax.jit,
    static_argnames=("update_fn", "spp", "max_depth", "rr_depth",
                     "rfilter"),
)
def _replay_grads_fused(scene, params, rec3, target, seed, offs, ends, *,
                        update_fn, spp: int, max_depth: int, rr_depth: int,
                        rfilter: str):
    """lax.scan of the per-chunk grad (exactly _replay_grad_jit's body)
    over the chunked record, accumulating grads on device."""

    def one_chunk(acc, xs):
        sl, idx0, ray_end = xs
        g = _replay_grad_impl(
            scene, params, sl, target, seed, idx0, ray_end,
            update_fn=update_fn, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, rfilter=rfilter,
        )
        return jax.tree_util.tree_map(jnp.add, acc, g), None

    acc0 = jax.tree_util.tree_map(jnp.zeros_like, params)
    acc, _ = jax.lax.scan(one_chunk, acc0, (rec3, offs, ends))
    return acc


def path_lengths(rec: PathRecord):
    """(rows,) i32: exact scan-prefix length that replays row i bit-equal.

    A ray whose last recorded hit is at depth d (column d-1) needs d+1 scan
    steps: step d+1 consumes the prim=-1 column for the environment-escape
    contribution (or is already an act=False no-op if RR terminated the
    path).  Every later step is gated to zero by the carried `act` mask, so
    truncating the scan there is exact, not approximate."""
    D = rec.prim.shape[1]
    has = rec.prim >= 0
    depth_ix = jnp.arange(1, D + 1, dtype=jnp.int32)[None, :]
    last_hit = jnp.max(jnp.where(has, depth_ix, 0), axis=1)
    return jnp.minimum(last_hit + 1, D)


def _depth_classes(D: int):
    """Doubling ladder of scan lengths {1, 2, 4, ..., D} (compile count is
    log D; each chunk replays at the smallest class >= its longest path)."""
    cs = []
    c = 1
    while c < D:
        cs.append(c)
        c *= 2
    cs.append(D)
    return cs


@partial(
    jax.jit,
    static_argnames=("spp", "max_depth", "rr_depth", "rfilter", "n_steps"),
    donate_argnums=(1,),
)
def _replay_fwd_chunk(scene, film, rec, order_j, target_unused, seed,
                      ray_end, *, spp: int, max_depth: int, rr_depth: int,
                      rfilter: str, n_steps: int):
    sl = jax.tree_util.tree_map(lambda a: a[order_j], rec)
    L, pos, act0 = replay_radiance(
        scene, sl, seed, 0, spp=spp, max_depth=max_depth,
        rr_depth=rr_depth, ray_end=ray_end, idx=order_j, n_steps=n_steps,
    )
    return filmlib.put(
        film, pos, jnp.where(jnp.isfinite(L), L, 0.0), active=act0,
        rfilter=rfilter,
    )


@partial(
    jax.jit,
    static_argnames=("update_fn", "spp", "max_depth", "rr_depth",
                     "rfilter", "n_steps"),
)
def _replay_adj_chunk(scene, params, adj, rec, order_j, seed, ray_end, *,
                      update_fn, spp: int, max_depth: int, rr_depth: int,
                      rfilter: str, n_steps: int):
    w, h = scene.camera.resolution
    sl = jax.tree_util.tree_map(lambda a: a[order_j], rec)

    def scalar(p):
        s = update_fn(scene, p)
        L, pos, act0 = replay_radiance(
            s, sl, seed, 0, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, ray_end=ray_end, idx=order_j,
            n_steps=n_steps,
        )
        film = filmlib.put(
            filmlib.new_film(w, h), pos,
            jnp.where(jnp.isfinite(L), L, 0.0), active=act0,
            rfilter=rfilter,
        )
        return jnp.sum(adj * film[..., :3])

    return jax.grad(scalar)(params)


@partial(
    jax.jit,
    static_argnames=("spp", "max_depth", "rr_depth", "rfilter", "n_steps"),
    donate_argnums=(1,),
)
def _replay_fwd_class(scene, film, rec, orders, seed, ray_end, *,
                      spp: int, max_depth: int, rr_depth: int,
                      rfilter: str, n_steps: int):
    """All same-depth-class chunks' forward splats as ONE lax.scan — the
    host dispatch is paid once per CLASS instead of once per chunk."""

    def one(film, oj):
        sl = jax.tree_util.tree_map(lambda a: a[oj], rec)
        L, pos, act0 = replay_radiance(
            scene, sl, seed, 0, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, ray_end=ray_end, idx=oj, n_steps=n_steps,
        )
        film = filmlib.put(
            film, pos, jnp.where(jnp.isfinite(L), L, 0.0), active=act0,
            rfilter=rfilter,
        )
        return film, None

    film, _ = jax.lax.scan(one, film, orders)
    return film


@partial(
    jax.jit,
    static_argnames=("update_fn", "spp", "max_depth", "rr_depth",
                     "rfilter", "n_steps"),
    donate_argnums=(2,),
)
def _replay_adj_class(scene, params, acc, adj, rec, orders, seed,
                      ray_end, *, update_fn, spp: int, max_depth: int,
                      rr_depth: int, rfilter: str, n_steps: int):
    """All same-class chunks' adjoint grads as ONE lax.scan (see
    _replay_fwd_class)."""
    w, h = scene.camera.resolution

    def one(acc, oj):
        def scalar(p):
            s = update_fn(scene, p)
            L, pos, act0 = replay_radiance(
                s, jax.tree_util.tree_map(lambda a: a[oj], rec), seed, 0,
                spp=spp, max_depth=max_depth, rr_depth=rr_depth,
                ray_end=ray_end, idx=oj, n_steps=n_steps,
            )
            film = filmlib.put(
                filmlib.new_film(w, h), pos,
                jnp.where(jnp.isfinite(L), L, 0.0), active=act0,
                rfilter=rfilter,
            )
            return jnp.sum(adj * film[..., :3])

        g = jax.grad(scalar)(params)
        return jax.tree_util.tree_map(jnp.add, acc, g), None

    acc, _ = jax.lax.scan(one, acc, orders)
    return acc


def replay_grads_sorted(scene: Scene, params: dict, update_fn, target,
                        seed, rec: PathRecord, n_rays: int, *, chunk: int,
                        spp: int, max_depth: int, rr_depth: int,
                        rfilter: str = "box", fused: bool = True,
                        film=None):
    """Grad accumulation over a full-frame PathRecord, rows sorted by
    recorded path length so each chunk's depth scan runs only as long as
    its LONGEST path (classes on a doubling ladder -> log D compiles).
    Measured on the flagship at max_depth 65 (the reference bedroom spec,
    /root/reference/data/bedroom/scene.xml:6): RR kills most paths at 5-8
    bounces (p95 = 11), so uniform replay wastes ~85% of its scan steps.

    Exactness despite sorting: chunks no longer partition pixels, so the
    per-chunk-MSE decomposition of replay_grads_full would be wrong (the
    square is nonlinear across chunks sharing a pixel).  Instead the loss
    gradient is decomposed through the film ADJOINT: with develop = S/w
    (w = filter-weight channel, independent of params),
      dLoss/dS = 2 (S/w - target) / w  on covered pixels  (:= adj)
    is computed ONCE from a forward-only bucketed pass, and each chunk then
    contributes grad of <adj, S_chunk> — linear in the chunk splats, so the
    sum over chunks equals the whole-frame gradient exactly (standard
    adjoint/VJP decomposition; tested against replay_grads_full).

    fused=True additionally batches chunks into ascending pow2-sized RUNS,
    one lax.scan per run per pass (~2 log(n_chunks) dispatches per frame
    instead of 2 n_chunks — the round-4 fix for the per-chunk dispatch
    tax that made the sorted replay LOSE at depth 8 despite winning at
    65); run sizes depend only on n_chunks, so shapes are stable across
    frames.

    `film` (optional): a precomputed forward film (weight channel intact,
    same rfilter) — e.g. the free byproduct of
    record_full_pipelined(return_film=True).  The forward bucketed pass is
    skipped entirely and the adjoint is computed from the given film,
    halving the sorted replay's forward work (the recorder's film is the
    same estimator on the same rays/RNG dims as the replayed one)."""
    rows = rec.prim.shape[0]
    assert rows % chunk == 0, (rows, chunk)
    D = rec.prim.shape[1]
    lens = path_lengths(rec)
    order = jnp.argsort(-lens).astype(jnp.uint32)
    n_chunks = rows // chunk
    # chunk j's longest path = lens[order[j*chunk]] (rows sorted descending)
    chunk_max = jax.device_get(
        jnp.take(lens, order[:: chunk].astype(jnp.int32))
    )
    classes = _depth_classes(D)
    cls = [min(c for c in classes if c >= int(mx)) for mx in chunk_max]

    w, h = scene.camera.resolution
    have_film = film is not None
    if not have_film:
        film = filmlib.new_film(w, h)
    seed_u = jnp.uint32(seed)
    end_u = jnp.uint32(n_rays)
    kw = dict(spp=spp, max_depth=max_depth, rr_depth=rr_depth,
              rfilter=rfilter)

    if fused:
        # RUN decomposition: ascending pow2-sized runs over the class-
        # sorted chunk list, the remainder (the bulk of short paths) as
        # one big tail run.  Run SIZES depend only on n_chunks — fixed per
        # workload — so compiled shapes are stable across frames; each
        # run's scan length is its first (deepest) chunk's ladder class,
        # exact for every chunk in the run (longer scans are no-ops past a
        # path's recorded length).  The deep heavy-tail chunks get fine
        # run granularity (sizes 1, 2, 4...), so one depth-65 chunk never
        # drags the short-path mass through a 65-step scan.
        sizes = []
        rem, s = n_chunks, 1
        while rem > 2 * s:
            sizes.append(s)
            rem -= s
            s *= 2
        sizes.append(rem)
        runs = []  # (offset, size, n_steps)
        off = 0
        for s in sizes:
            runs.append((off, s, cls[off]))
            off += s
        order2 = order.reshape(n_chunks, chunk)

        if not have_film:
            for off, s, c in runs:
                film = _replay_fwd_class(
                    scene, film, rec, order2[off:off + s], seed_u, end_u,
                    n_steps=c, **kw,
                )
    elif not have_film:
        for j in range(n_chunks):
            oj = jax.lax.dynamic_slice_in_dim(order, j * chunk, chunk)
            film = _replay_fwd_chunk(
                scene, film, rec, oj, None, seed_u, end_u,
                n_steps=cls[j], **kw,
            )
    img = filmlib.develop(film)
    wgt = film[..., 3:4]
    adj = jnp.where(
        wgt > 0.0,
        2.0 * (img - target) / jnp.where(wgt > 0.0, wgt, 1.0),
        0.0,
    )
    adj = jax.lax.stop_gradient(adj)

    acc = jax.tree_util.tree_map(jnp.zeros_like, params)
    if fused:
        for off, s, c in runs:
            acc = _replay_adj_class(
                scene, params, acc, adj, rec, order2[off:off + s],
                seed_u, end_u, update_fn=update_fn, n_steps=c, **kw,
            )
    else:
        for j in range(n_chunks):
            oj = jax.lax.dynamic_slice_in_dim(order, j * chunk, chunk)
            g = _replay_adj_chunk(
                scene, params, adj, rec, oj, seed_u, end_u,
                update_fn=update_fn, n_steps=cls[j], **kw,
            )
            acc = jax.tree_util.tree_map(jnp.add, acc, g)
    return acc


@partial(
    jax.jit,
    static_argnames=("update_fn", "spp", "max_depth", "rr_depth",
                     "rfilter", "n_steps"),
    donate_argnums=(2,),
)
def _replay_mse_run(scene, params, acc, target, rec, orders, seed,
                    ray_end, *, update_fn, spp: int, max_depth: int,
                    rr_depth: int, rfilter: str, n_steps: int):
    """One run of whole chunks through the per-chunk-MSE grad at a
    truncated scan length (replay_grads_trunc)."""
    w, h = scene.camera.resolution

    def one(acc, oj):
        def loss(p):
            s = update_fn(scene, p)
            L, pos, act0 = replay_radiance(
                s, jax.tree_util.tree_map(lambda a: a[oj], rec), seed, 0,
                spp=spp, max_depth=max_depth, rr_depth=rr_depth,
                ray_end=ray_end, idx=oj, n_steps=n_steps,
            )
            film = filmlib.put(
                filmlib.new_film(w, h), pos,
                jnp.where(jnp.isfinite(L), L, 0.0), active=act0,
                rfilter=rfilter,
            )
            img = filmlib.develop(film)
            msk = (film[..., 3] > 0.0)[..., None]
            return jnp.sum(jnp.where(msk, (img - target) ** 2, 0.0))

        g = jax.grad(loss)(params)
        return jax.tree_util.tree_map(jnp.add, acc, g), None

    acc, _ = jax.lax.scan(one, acc, orders)
    return acc


def replay_grads_trunc(scene: Scene, params: dict, update_fn, target,
                       seed, rec: PathRecord, n_rays: int, *, chunk: int,
                       spp: int, max_depth: int, rr_depth: int,
                       rfilter: str = "box"):
    """ONE-pass per-chunk-truncated replay — dominates both prior modes.

    replay_grads_full pays one grad pass but scans every chunk to the full
    max_depth; replay_grads_sorted truncates per chunk but needs TWO
    passes (forward film + adjoint) because row sorting breaks the
    pixel partition.  This keeps rows in natural order (chunks stay
    pixel-disjoint, so the per-chunk-MSE decomposition of the one-pass
    grad remains exact for the box filter), computes each chunk's depth
    class from its own longest recorded path (path lengths correlate
    spatially, so chunk maxima sit far below max_depth on deep specs),
    and batches chunks CLASS-SORTED into ascending pow2-sized runs (sizes
    fixed by n_chunks -> stable compiled shapes, as the sorted mode)."""
    rows = rec.prim.shape[0]
    assert rows % chunk == 0, (rows, chunk)
    D = rec.prim.shape[1]
    n_chunks = rows // chunk
    lens = path_lengths(rec)
    cmax = jax.device_get(jnp.max(lens.reshape(n_chunks, chunk), axis=1))
    classes = _depth_classes(D)
    cls = [min(c for c in classes if c >= int(mx)) for mx in cmax]
    if all(c == D for c in cls):
        # nothing to truncate (shallow specs: every chunk holds a
        # max-length path) — the single fused uniform scan avoids this
        # path's extra per-run dispatches
        return replay_grads_full(
            scene, params, update_fn, target, seed, rec, n_rays,
            chunk=chunk, spp=spp, max_depth=max_depth, rr_depth=rr_depth,
            rfilter=rfilter,
        )
    order_c = sorted(range(n_chunks), key=lambda j: -cls[j])

    sizes = []
    rem, s = n_chunks, 1
    while rem > 2 * s:
        sizes.append(s)
        rem -= s
        s *= 2
    sizes.append(rem)

    row_ids = jnp.arange(rows, dtype=jnp.uint32).reshape(n_chunks, chunk)
    acc = jax.tree_util.tree_map(jnp.zeros_like, params)
    kw = dict(update_fn=update_fn, spp=spp, max_depth=max_depth,
              rr_depth=rr_depth, rfilter=rfilter)
    off = 0
    for sz in sizes:
        js = order_c[off:off + sz]
        off += sz
        orders = row_ids[jnp.asarray(js, jnp.int32)]
        acc = _replay_mse_run(
            scene, params, acc, target, rec, orders, jnp.uint32(seed),
            jnp.uint32(n_rays), n_steps=cls[js[0]], **kw,
        )
    return acc


def replay_grads(scene: Scene, params: dict, update_fn, target, seed,
                 rec: PathRecord, n_rays: int, *, chunk: int, spp: int,
                 max_depth: int, rr_depth: int, rfilter: str = "box",
                 mode: str = "auto", film=None):
    """Production fwd+bwd replay dispatcher.

    mode='auto': 'sorted' when max_depth >= 16 (deep specs like the
    reference bedroom's 65 — RR kills most paths early and row-level
    sorting lets buckets scan shallow), else 'full' (one fused uniform
    scan).  That split was measured on the accelerator this system was
    first built for; on the GPU it is a hypothesis (ROADMAP queue 1, item
    4).  'trunc' (one-pass per-chunk truncation) is a NEGATIVE for deep
    specs: per-chunk maxima are extreme-value statistics, so at depth 65
    every 131k-ray chunk contains a >32-bounce path and truncation
    degenerates to 'full' — length homogeneity requires the row sort,
    which in turn forces sorted's two-pass adjoint decomposition."""
    if mode == "auto":
        mode = "sorted" if max_depth >= 16 else "full"
    fn = {"sorted": replay_grads_sorted, "full": replay_grads_full,
          "trunc": replay_grads_trunc}[mode]
    extra = {"film": film} if mode == "sorted" else {}
    return fn(
        scene, params, update_fn, target, seed, rec, n_rays, chunk=chunk,
        spp=spp, max_depth=max_depth, rr_depth=rr_depth, rfilter=rfilter,
        **extra,
    )


def replay_radiance(scene: Scene, rec: PathRecord, seed, idx0, *, spp: int,
                    max_depth: int, rr_depth: int, ray_end=None,
                    idx=None, n_steps: int | None = None):
    """Differentiable per-lane radiance from a PathRecord.

    Mirrors pp._transition_trace / the inline shadow resolve bounce for
    bounce — same formulas, same RNG dimensions — with ray_intersect
    replaced by the recorded (prim, u, v) and ray_test by the recorded
    occlusion bit.  Returns (L (N,3), film pos (N,2)).

    `idx` (optional, (N,) uint32) overrides the contiguous idx0+arange
    camera-ray assignment — the sorted-bucketed replay feeds permuted rows.
    `n_steps` (static) truncates the depth scan: rows whose recorded path
    needs <= n_steps scan steps (see path_lengths) replay EXACTLY — all
    later steps are act=False no-ops by construction."""
    n = rec.prim.shape[0]
    mats, tex = scene.materials, scene.textures
    seed_u = jnp.uint32(seed)
    if idx is None:
        idx = jnp.uint32(idx0) + jnp.arange(n, dtype=jnp.uint32)
    act0 = (
        jnp.ones((n,), bool) if ray_end is None
        else idx < jnp.uint32(ray_end)
    )

    # camera ray (exactly pp._refill_persistent, same idx->pixel order)
    pos = pp.ray_positions(scene.camera, seed_u, idx, spp)
    ray0 = sensorlib.sample_ray(scene.camera, pos)

    class Ref:  # si_ref stand-in for pdf_emitter_direction
        __slots__ = ("p",)

        def __init__(self, p):
            self.p = p

    def bounce(carry, xs):
        L, f, eta, prev_p, prev_pdf, prev_delta, o, d, act, depth = carry
        prim, uu, vv, occluded = xs

        si, si_row = _make_si(scene, Ray.make(o, d),
                              jnp.where(prim >= 0, 1.0, jnp.inf), prim,
                              uu, vv, return_row=True)
        hit = act & si.valid

        # emission at the hit / environment escape (ray-first MIS)
        ref = Ref(prev_p)
        gate = act & (prev_pdf > 0.0)
        em_pdf = pdf_emitter_direction_packed(
            scene, ref, si, si_row[:, 27], si_row[:, 28],
            gate & ~prev_delta,
        )
        mis_hit = jnp.where(prev_delta, 1.0, mis_weight(prev_pdf, em_pdf))
        L = L + jnp.where(
            (gate & hit)[:, None],
            f * eval_emitter(scene, si, hit) * mis_hit[:, None], 0.0,
        )
        esc = act & ~si.valid & (prev_pdf > 0.0)
        env_pdf = pdf_environment_direction(scene, d, esc & ~prev_delta)
        mis_env = jnp.where(prev_delta, 1.0, mis_weight(prev_pdf, env_pdf))
        L = L + jnp.where(
            esc[:, None],
            f * eval_environment(scene, esc, d) * mis_env[:, None], 0.0,
        )

        # NEE with recorded visibility
        cont = hit & (depth < max_depth)
        base = jnp.uint32(2) + jnp.uint32(6) * (depth - 1).astype(jnp.uint32)
        flags = bsdflib.bsdf_flags(mats, si.mat_id)
        active_em = cont & has_flag(flags, BSDFFlags.Smooth)
        u_em = _rand(seed_u, idx, base, 2)
        ds, em_weight = sample_emitter_direction(
            scene, si, u_em, False, active_em
        )
        active_em &= ds.pdf != 0.0
        wo = si.to_local(ds.d)
        u1 = _rand(seed_u, idx, base + jnp.uint32(2), 1)
        u2 = _rand(seed_u, idx, base + jnp.uint32(3), 2)
        bsdf_val, bsdf_pdf, bs, bsdf_weight = bsdflib.eval_pdf_sample(
            mats, tex, si, wo, u1, u2, cont
        )
        mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
        L = L + jnp.where(
            (active_em & ~occluded)[:, None],
            f * bsdf_val * em_weight * mis_em[:, None], 0.0,
        )

        # BSDF bounce + RR (identical reweighting/decisions as forward)
        f2 = f * bsdf_weight
        eta2 = eta * bs.eta
        fmax = m.max_component(f2)
        rr_prob = jnp.minimum(fmax * eta2 * eta2, 0.95)
        rr_active = depth >= rr_depth
        u_rr = _rand(seed_u, idx, base + jnp.uint32(5), 1)
        rr_continue = u_rr < jax.lax.stop_gradient(rr_prob)
        f2 = jnp.where(
            rr_active[:, None],
            f2 * m.safe_rcp(jax.lax.stop_gradient(rr_prob))[:, None], f2,
        )
        cont2 = cont & (jax.lax.stop_gradient(fmax) != 0.0) & (
            ~rr_active | rr_continue
        )
        ray2 = si.spawn_ray(si.to_world(bs.wo))

        adv = act & cont2
        carry = (
            L,
            jnp.where(adv[:, None], f2, f),
            jnp.where(adv, eta2, eta),
            jnp.where(act[:, None], si.p, prev_p),
            jnp.where(act, bs.pdf, prev_pdf),
            jnp.where(act, has_flag(bs.sampled_type, BSDFFlags.Delta),
                      prev_delta),
            jnp.where(adv[:, None], ray2.o, o),
            jnp.where(adv[:, None], ray2.d, d),
            adv,
            jnp.where(adv, depth + 1, depth),
        )
        return carry, None

    init = (
        jnp.zeros((n, 3), m.Float), jnp.ones((n, 3), m.Float),
        jnp.ones((n,), m.Float), ray0.o, jnp.ones((n,), m.Float),
        jnp.ones((n,), bool), ray0.o, ray0.d, act0,
        jnp.ones((n,), jnp.int32),
    )
    d_use = rec.prim.shape[1] if n_steps is None else min(
        n_steps, rec.prim.shape[1]
    )
    xs = (rec.prim[:, :d_use].T, rec.u[:, :d_use].T, rec.v[:, :d_use].T,
          rec.occl[:, :d_use].T)
    (L, *_), _ = jax.lax.scan(bounce, init, xs)
    return L, pos, act0


def replay_render_grad(scene: Scene, params: dict, update_fn, target,
                       seed, idx0, n: int, *, spp: int, max_depth: int,
                       rr_depth: int, rfilter: str = "box",
                       steps: int = 16, rounds_per_launch: int = 8,
                       ray_end=None):
    """One chunk of the fwd+bwd workload: record (fast, no AD), then
    grad-of-replay w.r.t. `params`.  `update_fn(scene, params) -> scene`
    rebinds the differentiated tables (scene/params.py::update)."""
    rec = record_chunk(
        scene, seed, idx0, n, spp=spp, max_depth=max_depth,
        rr_depth=rr_depth, steps=steps, rounds_per_launch=rounds_per_launch,
        ray_end=ray_end,
    )
    return _replay_grad_jit(
        scene, params, rec, target, jnp.uint32(seed), jnp.uint32(idx0),
        jnp.uint32(idx0 + n if ray_end is None else ray_end),
        update_fn=update_fn, spp=spp, max_depth=max_depth,
        rr_depth=rr_depth, rfilter=rfilter,
    )


@partial(
    jax.jit,
    static_argnames=("update_fn", "spp", "max_depth", "rr_depth",
                     "rfilter"),
)
def _replay_grad_jit(scene, params, rec, target, seed, idx0, ray_end, *,
                     update_fn, spp: int, max_depth: int, rr_depth: int,
                     rfilter: str):
    return _replay_grad_impl(
        scene, params, rec, target, seed, idx0, ray_end,
        update_fn=update_fn, spp=spp, max_depth=max_depth,
        rr_depth=rr_depth, rfilter=rfilter,
    )


def _replay_grad_impl(scene, params, rec, target, seed, idx0, ray_end, *,
                      update_fn, spp: int, max_depth: int, rr_depth: int,
                      rfilter: str):
    w, h = scene.camera.resolution

    def loss(p):
        s = update_fn(scene, p)
        L, pos, act0 = replay_radiance(
            s, rec, seed, idx0, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, ray_end=ray_end,
        )
        film = filmlib.new_film(w, h)
        film = filmlib.put(
            film, pos, jnp.where(jnp.isfinite(L), L, 0.0),
            active=act0, rfilter=rfilter,
        )
        img = filmlib.develop(film)
        msk = (film[..., 3] > 0.0)[..., None]
        return jnp.sum(jnp.where(msk, (img - target) ** 2, 0.0))

    return jax.grad(loss)(params)
