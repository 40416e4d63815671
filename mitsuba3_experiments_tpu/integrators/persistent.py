"""Persistent-wavefront path tracer: incremental traversal, no lockstep max.

Why this exists: a `lax.while_loop` traversal launch runs (max iterations
over all lanes) steps, so one 300-iteration straggler idles every other
lane; chunking shrinks the max but gives up the width a big launch has.
The design assumes an iteration's cost is dominated by its row gathers and
barely depends on lane count — measured on the accelerator this system was
first built for; on the GPU it is a hypothesis (ROADMAP queue 1, item 3).

This renderer removes the lockstep max instead of shrinking the launch: the
BVH traversal is *incremental*.  Each round advances EVERY lane by at most
`steps` traversal iterations (a fixed-trip fori_loop — gather cost K x c per
round, full stop); lanes whose query completed transition through a small
per-lane state machine:

    P_TRACE  closest-hit of the path ray   -> shade: emission MIS, NEE
             sample (pending contribution), BSDF sample, RR -> P_SHADOW
    P_SHADOW any-hit of the NEE shadow ray -> resolve pending contribution,
             continue with the stored next path ray (P_TRACE) or retire
             (splat + refill as a fresh camera ray)

Lanes at different traversal progress, phases, and path depths coexist in
one launch; a straggler costs only its own iterations.  Masked-idle lanes
are ~free in the gather-latency regime.  The whole round (stepper + both
transitions + refill) is one program, scanned `rounds_per_launch` times per
dispatch (same dispatch-amortization as wavefront._run_rounds).

RNG dimensions are assigned per (camera ray, surface depth) exactly as
`PathIntegrator.sample` / wavefront._bounce consume them, so estimates are
ray-for-ray identical to `render()` (tested).

Reference lineage: the wavefront formulation is SURVEY.md section 7's north
star; the state-machine scheduling replaces OptiX's hardware scheduler
(/root/reference/path.py:238,281 `scene.ray_intersect` inside megakernels).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from types import SimpleNamespace

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
from ..scene.bvh8 import DEFAULT_LAYOUT, BVHLayout
from ..scene.types import Scene
from .common import mis_weight
from .wavefront import _rand

import os

DONE = jnp.int32(-1)
P_TRACE = 0
P_SHADOW = 1
P_RETIRE = 2


@dataclasses.dataclass(frozen=True)
class StepperConfig:
    """Scheduling knobs of the persistent machine as one hashable value
    (round-4 config consolidation — formerly M3T_* module globals).
    Hashable, so it rides jit static args; A/Bs run in one process.

    idle_spread  spread idle lanes' discarded gather rows across the table
                 instead of a shared dummy row — the round-3 gather probe
                 measured duplicate indices 1.45x SLOWER than random (bank
                 conflicts serialize), so a shared dummy row makes idle
                 lanes actively expensive rather than free.  Default ON.
    ray_order    camera-ray index -> pixel order: 'row' (reference
                 row-major) or 'tile' (tile-major, see ray_pixel).
                 Measured neutral on the flagship (round 3); 'row' keeps
                 reference parity.

    Removed (measured-negative machinery, see git history): the windowed
    t-stack culled-pop skip (M3T_DROP_SCAN) cost more in shift-variant
    traffic than its 9-13% iteration savings.
    """

    idle_spread: bool = True
    ray_order: str = "row"

    @staticmethod
    def from_env() -> "StepperConfig":
        return StepperConfig(
            idle_spread=os.environ.get("M3T_IDLE_SPREAD", "1") == "1",
            ray_order=os.environ.get("M3T_RAY_ORDER", "row"),
        )


DEFAULT_STEPPER = StepperConfig.from_env()


@jstruct
class PersistentState:
    """Per-lane path + in-flight traversal state."""

    # path state
    L: jnp.ndarray          # (N, 3) accumulated radiance
    f: jnp.ndarray          # (N, 3) throughput at the NEXT ray
    eta: jnp.ndarray        # (N,)
    depth: jnp.ndarray      # (N,) i32 depth of the surface being traced
    prev_p: jnp.ndarray     # (N, 3) origin surface of the traced path ray
    prev_pdf: jnp.ndarray   # (N,)
    prev_delta: jnp.ndarray  # (N,) bool
    idx: jnp.ndarray        # (N,) uint32 camera-ray index (RNG lane)
    alive: jnp.ndarray      # (N,) bool
    # pending (set at P_TRACE shading, consumed at P_SHADOW resolve)
    nee_L: jnp.ndarray      # (N, 3) contribution if shadow ray unoccluded
    next_o: jnp.ndarray     # (N, 3) next path ray
    next_d: jnp.ndarray     # (N, 3)
    cont: jnp.ndarray       # (N,) bool path continues after this surface
    phase: jnp.ndarray      # (N,) i32
    # in-flight traversal
    tr_o: jnp.ndarray       # (N, 3) ray being traversed (path or shadow)
    tr_d: jnp.ndarray       # (N, 3)
    tr_cur: jnp.ndarray     # (N,) i32 node code (DONE = finished)
    tr_sp: jnp.ndarray      # (N,) i32 stack pointer
    tr_stack: jnp.ndarray   # (N, layout.stack) i32 shift-register, top=col 0
    tr_t: jnp.ndarray       # (N,) best-hit t (init: maxt)
    tr_face: jnp.ndarray    # (N,) i32 best face (-1 none)
    tr_u: jnp.ndarray      # (N,)
    tr_v: jnp.ndarray      # (N,)

    @staticmethod
    def empty(n: int, stack_depth: int | None = None):
        """stack_depth should be the scene BVH's layout.stack (defaults to
        DEFAULT_LAYOUT's); _trav_steps reads it back from tr_stack.shape."""
        sd = DEFAULT_LAYOUT.stack if stack_depth is None else stack_depth
        z3 = lambda: jnp.zeros((n, 3), m.Float)  # noqa: E731
        zi = lambda v=0: jnp.full((n,), v, jnp.int32)  # noqa: E731
        zf = lambda v=0.0: jnp.full((n,), v, m.Float)  # noqa: E731
        return PersistentState(
            L=z3(), f=jnp.ones((n, 3), m.Float), eta=zf(1.0), depth=zi(1),
            prev_p=z3(), prev_pdf=zf(1.0),
            prev_delta=jnp.ones((n,), bool),
            idx=jnp.zeros((n,), jnp.uint32),
            alive=jnp.zeros((n,), bool),
            nee_L=z3(), next_o=z3(), next_d=z3(),
            cont=jnp.zeros((n,), bool), phase=zi(P_TRACE),
            tr_o=z3(), tr_d=z3(), tr_cur=zi(DONE), tr_sp=zi(0),
            tr_stack=jnp.zeros((n, sd), jnp.int32),
            tr_t=zf(0.0), tr_face=zi(-1), tr_u=zf(), tr_v=zf(),
        )


def _start_traversal(st: PersistentState, take, o, d, maxt):
    """Arm the traversal fields for lanes in `take` (fresh query)."""
    t3 = take[:, None]
    return dataclasses.replace(st, 
        tr_o=jnp.where(t3, o, st.tr_o),
        tr_d=jnp.where(t3, d, st.tr_d),
        tr_cur=jnp.where(take, jnp.int32(0), st.tr_cur),
        tr_sp=jnp.where(take, 0, st.tr_sp),
        tr_t=jnp.where(take, maxt, st.tr_t),
        tr_face=jnp.where(take, -1, st.tr_face),
        tr_u=jnp.where(take, 0.0, st.tr_u),
        tr_v=jnp.where(take, 0.0, st.tr_v),
    )


def unify_tables(bvh):
    """(unified table, n_nodes) for the stepper — now precomputed at build
    time (BVH.unified; see scene/types.py for the gather-count rationale)."""
    return bvh.unified, bvh.nodes.shape[0]


def _engine_step(unified, n_nodes: int, lay: BVHLayout, idle_spread: bool,
                 o, d, any_hit, cur, sp, stack, t_best, face_best,
                 u_best, v_best):
    """ONE traversal iteration of the shared engine: one unified-row
    gather, 8-box slab tests + LEAF_CAP unrolled triangle tests under both
    views, ordered shift-register push/pop.  Pure function of the engine
    registers — shared verbatim by the single-path stepper (_trav_steps)
    and the two-path pipelined stepper (integrators/pipelined.py).
    `any_hit` marks occlusion queries (early exit on any leaf hit)."""
    WIDTH, LEAF_CAP = lay.width, lay.leaf_cap
    NODE_BASE, FACE_OFF, LEAF_ROW = lay.node_base, lay.face_off, lay.leaf_row
    STACK_DEPTH = stack.shape[1]
    n = cur.shape[0]
    ki = jnp.arange(WIDTH, dtype=jnp.int32)
    col8 = ki[None, :]
    lane_iota = jnp.arange(n, dtype=jnp.int32)
    total_rows = unified.shape[0]

    inv_d = m.safe_div(jnp.ones((), m.Float), d, fill=jnp.inf)
    live = cur != DONE
    is_int = cur >= 0
    is_leaf = cur <= -2

    row_idx = jnp.where(
        is_int, cur,
        n_nodes + jnp.where(is_leaf, -cur - 2, 0),
    )
    # idle lanes: SPREAD their (discarded) gather rows across the table
    # instead of all hitting one dummy row — the round-3 gather probe
    # measured duplicate indices 1.45x SLOWER than random (bank
    # conflicts serialize), so a shared dummy row makes idle lanes
    # actively expensive rather than free.
    if idle_spread:
        row_idx = jnp.where(live, row_idx, lane_iota % total_rows)
    row = jnp.take(unified, row_idx, axis=0)          # (N, 88)
    codes = jax.lax.bitcast_convert_type(row[:, 0:WIDTH], jnp.int32)
    bb = row[:, NODE_BASE : NODE_BASE + 6 * WIDTH].reshape(n, WIDTH, 6)
    t0 = (bb[:, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bb[:, :, 3:6] - o[:, None, :]) * inv_d[:, None, :]
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (
        (t_near <= t_far * 1.00000024) & (t_far > 0.0)
        & (t_near < t_best[:, None]) & (codes != DONE)
        & is_int[:, None]
    )

    t_sort = jnp.where(hit, t_near, jnp.inf)
    k_near = jnp.argmin(t_sort, axis=-1)
    any_child = jnp.any(hit, axis=-1)
    onehot_near = ki[None, :] == k_near[:, None]
    near_code = jnp.sum(jnp.where(onehot_near, codes, 0), axis=-1)

    push_mask = hit & ~onehot_near
    n_push = jnp.sum(push_mask, axis=-1).astype(jnp.int32)
    tp = jnp.where(push_mask, t_near, -jnp.inf)
    farther = (
        (tp[:, None, :] > tp[:, :, None])
        | ((tp[:, None, :] == tp[:, :, None])
           & (ki[None, None, :] > ki[None, :, None]))
    ) & push_mask[:, None, :]
    rank_far = jnp.sum(farther, axis=-1).astype(jnp.int32)

    trow = row  # leaf view of the same gathered row
    frow = jax.lax.bitcast_convert_type(
        trow[:, FACE_OFF:LEAF_ROW], jnp.int32
    )
    for kk in range(LEAF_CAP):
        g9 = trow[:, 9 * kk : 9 * kk + 9]
        v0 = g9[:, 0:3]
        e1 = g9[:, 3:6] - v0
        e2 = g9[:, 6:9] - v0
        pvec = m.cross(d, e2)
        det = m.dot(e1, pvec)
        inv_det = m.safe_div(jnp.ones((), det.dtype), det)
        tvec = o - v0
        uu = m.dot(tvec, pvec) * inv_det
        qvec = m.cross(tvec, e1)
        vv = m.dot(d, qvec) * inv_det
        tt = m.dot(e2, qvec) * inv_det
        h = (
            (jnp.abs(det) > 1e-10)
            & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            & (tt > 0.0) & (tt < t_best)
        )
        ok = is_leaf & h & (frow[:, kk] >= 0)
        t_best = jnp.where(ok, tt, t_best)
        face_best = jnp.where(ok, frow[:, kk], face_best)
        u_best = jnp.where(ok, uu, u_best)
        v_best = jnp.where(ok, vv, v_best)

    early_done = any_hit & is_leaf & (face_best >= 0)

    descend = is_int & any_child
    want_pop = live & ~early_done & ~descend
    can_pop = want_pop & (sp > 0)
    popped = jnp.where(can_pop, stack[:, 0], DONE)
    nxt = jnp.where(descend, near_code, jnp.where(want_pop, popped, DONE))
    nxt = jnp.where(live & ~early_done, nxt, DONE)
    sp_new = jnp.where(
        descend, jnp.minimum(sp + n_push, STACK_DEPTH),
        jnp.where(can_pop, sp - 1, sp),
    )
    sp_new = jnp.where(nxt == DONE, 0, sp_new)

    # shift-register update: right by n_push on descend, left 1 on pop.
    # The right shift composes by power-of-2 stages (shift bit b set ->
    # shift by 2^b): ceil(log2 WIDTH) full-width selects instead of
    # WIDTH-1 — the (N, STACK_DEPTH) selects are pure streaming
    # bandwidth, so halving their count trims the stepper's largest
    # non-gather term.  Composition is exact: each stage inserts zeros
    # at the left, matching the direct zeros-pad of the total shift.
    shift = jnp.where(descend, n_push, 0) - can_pop.astype(jnp.int32)
    res = stack
    amt = 1
    b = 0
    while amt < WIDTH:
        res = jnp.where(
            (((shift >> b) & 1) > 0)[:, None] & (shift > 0)[:, None],
            jnp.concatenate(
                [jnp.zeros((n, amt), jnp.int32),
                 res[:, : STACK_DEPTH - amt]],
                axis=1,
            ),
            res,
        )
        amt *= 2
        b += 1
    res = jnp.where(
        (shift == -1)[:, None],
        jnp.concatenate(
            [stack[:, 1:], jnp.full((n, 1), DONE, jnp.int32)], axis=1
        ),
        res,
    )
    # insert pushed codes at columns 0..n_push-1, nearest at column 0
    head = res[:, :WIDTH]
    for kk in range(WIDTH):
        colk = (n_push - 1 - rank_far[:, kk])[:, None]
        mk = (push_mask[:, kk] & descend)[:, None]
        sel = (col8 == colk) & mk
        head = jnp.where(sel, codes[:, kk : kk + 1], head)
    stack = jnp.concatenate([head, res[:, WIDTH:]], axis=1)
    return nxt, sp_new, stack, t_best, face_best, u_best, v_best


def _trav_steps(unified, n_nodes: int, st: PersistentState, k: int,
                occl=None, sh_depth=None,
                layout: BVHLayout | None = None,
                idle_spread: bool = True, census=None):
    """Advance every in-flight traversal by at most k iterations.

    One fused stepper serves both phases: P_SHADOW lanes early-exit on any
    hit (occlusion queries need no nearest ordering, but ordered pushes are
    correct for them too, so the push logic is shared).  One row gather per
    iteration serves internal AND leaf lanes (unify_tables): the fetched
    row is decoded under both views, each masked by the lane's node kind —
    the garbage view is discarded by the same masks that already guarded
    the two-gather form.

    The stack is a SHIFT-REGISTER: the top is always column 0, so a pop is
    a static slice (free) and a push shifts the row right by n_push via a
    9-way elementwise select — pure streaming bandwidth — instead of a
    scatter + pop-gather pair per iteration.
    Bottom entries fall off on overflow; bvh8.collapse_to_wide asserts at
    build time that the collapsed depth fits layout.stack, so overflow
    cannot occur.  (A windowed t-stack culled-pop skip lived here in round
    3 and measured a net loss; see git history.)

    Shadow resolve is INLINE: a P_SHADOW lane whose any-hit completes is
    resolved at the top of the next iteration (add the pending NEE
    contribution, flip to P_TRACE, re-arm the stored next path ray) — all
    elementwise work, zero gathers.  The lane keeps traversing in the
    SAME round instead of idling until the next round;
    finished paths park in P_RETIRE for the (outside) film splat.  Only
    trace-shading, which needs table gathers and BSDF sampling, remains a
    heavyweight out-of-loop transition.

    When `occl`/`sh_depth` are given (the path-replay recorder,
    integrators/replay.py), each inline resolve also sets
    occl[lane, sh_depth-1] = shadow-ray occluded, and the function returns
    (state, occl).

    `layout` (static) gives the packed-row offsets; None = DEFAULT_LAYOUT.
    Stack capacity is read from st.tr_stack.shape.

    `census` (optional (2,) int64, exclusive with occl) accumulates
    [live-lane row gathers, total row gathers] per iteration (an
    active-row counter for a roofline reduction); returns (state, census).  None (the default) compiles it out."""
    lay = layout if layout is not None else DEFAULT_LAYOUT
    n = st.alive.shape[0]
    alive = st.alive
    cont_p, nee_L = st.cont, st.nee_L
    next_o, next_d = st.next_o, st.next_d
    record = occl is not None
    count = census is not None
    assert not (record and count)
    if record:
        colD = jnp.arange(occl.shape[1], dtype=jnp.int32)[None, :]

    def body(_, carry):
        if record:
            (cur, sp, stack, t_best, face_best, u_best, v_best,
             o, d, phase, L, occl) = carry
            census = None
        elif count:
            (cur, sp, stack, t_best, face_best, u_best, v_best,
             o, d, phase, L, census) = carry
            occl = None
        else:
            (cur, sp, stack, t_best, face_best, u_best, v_best,
             o, d, phase, L) = carry
            occl = census = None

        # ----- inline shadow resolve (elementwise; see docstring) -----
        finB = alive & (phase == P_SHADOW) & (cur == DONE)
        occluded = face_best >= 0
        L = L + jnp.where((finB & ~occluded)[:, None], nee_L, 0.0)
        if record:
            occl = occl | (
                (colD == (sh_depth - 1)[:, None])
                & (finB & occluded)[:, None]
            )
        adv = finB & cont_p
        phase = jnp.where(
            adv, P_TRACE, jnp.where(finB & ~cont_p, P_RETIRE, phase)
        )
        o = jnp.where(adv[:, None], next_o, o)
        d = jnp.where(adv[:, None], next_d, d)
        cur = jnp.where(adv, jnp.int32(0), cur)
        sp = jnp.where(adv, 0, sp)
        t_best = jnp.where(adv, jnp.inf, t_best)
        face_best = jnp.where(adv, -1, face_best)
        u_best = jnp.where(adv, 0.0, u_best)
        v_best = jnp.where(adv, 0.0, v_best)

        any_hit = phase == P_SHADOW
        if count:
            # int32: one launch's worth (lanes x steps x rounds ~ 42M at
            # the flagship operating point) fits comfortably; the probe
            # accumulates across launches in host integers
            census = census + jnp.stack(
                [jnp.sum((cur != DONE).astype(jnp.int32)), jnp.int32(n)]
            )
        nxt, sp_new, stack, t_best, face_best, u_best, v_best = \
            _engine_step(
                unified, n_nodes, lay, idle_spread, o, d, any_hit,
                cur, sp, stack, t_best, face_best, u_best, v_best,
            )
        out = (nxt, sp_new, stack, t_best, face_best, u_best,
               v_best, o, d, phase, L)
        if record:
            return out + (occl,)
        if count:
            return out + (census,)
        return out

    init = (st.tr_cur, st.tr_sp, st.tr_stack, st.tr_t,
            st.tr_face, st.tr_u, st.tr_v, st.tr_o, st.tr_d, st.phase, st.L)
    if record:
        init = init + (occl,)
    elif count:
        init = init + (census,)
    fin = jax.lax.fori_loop(0, k, body, init)
    (cur, sp, stack, t, face, u, v, o, d, phase, L) = fin[:11]
    st = dataclasses.replace(st,
        tr_cur=cur, tr_sp=sp, tr_stack=stack, tr_t=t,
        tr_face=face, tr_u=u, tr_v=v, tr_o=o, tr_d=d, phase=phase, L=L,
    )
    return (st, fin[11]) if (record or count) else st


def _retire(scene: Scene, st: PersistentState, rayL, *, deferred_pad):
    """Free lanes whose path finished (inline shadow resolve in _trav_steps
    parked them in P_RETIRE); also catch any still-unresolved P_SHADOW
    completion (a shadow query that finished on the round's LAST stepper
    iteration) by resolving it here, exactly as the stepper would at its
    next top-of-loop.

    Retired radiance is DEFERRED: instead of a per-round filter splat into
    the film (4 tent taps, one scatter-ADD per round), each
    finished ray scatter-SETs its radiance into a per-ray buffer
    `rayL[(idx - deferred_pad_offset)]`; every camera ray retires exactly
    once, so indices are unique (no accumulation semantics needed) and the
    filter footprint math leaves the hot loop entirely.  The caller splats
    the whole frame ONCE at the end (render_persistent) — film positions
    re-derive from the counter-based RNG, so they need not ride the state.
    `deferred_pad` = (dummy row index, ray-index offset of row 0)."""
    n_pad, idx0 = deferred_pad
    finB = st.alive & (st.phase == P_SHADOW) & (st.tr_cur == DONE)
    occluded = st.tr_face >= 0
    L = st.L + jnp.where((finB & ~occluded)[:, None], st.nee_L, 0.0)
    advance = finB & st.cont
    retire = (st.alive & (st.phase == P_RETIRE)) | (finB & ~st.cont)

    dst = jnp.where(retire, st.idx - idx0, n_pad)
    rayL = rayL.at[dst].set(jnp.where(jnp.isfinite(L), L, 0.0))
    st = dataclasses.replace(st,
        L=jnp.where(finB[:, None], L, st.L),
        alive=st.alive & ~retire,
        phase=jnp.where(advance, P_TRACE, st.phase),
    )
    st = _start_traversal(
        st, advance, st.next_o, st.next_d, jnp.full_like(st.tr_t, jnp.inf)
    )
    return st, rayL


def _tile_dims(w: int, h: int):
    """Largest tile sides <= 128 that divide the image (static)."""
    tw = next(t for t in range(min(128, w), 0, -1) if w % t == 0)
    th = next(t for t in range(min(128, h), 0, -1) if h % t == 0)
    return tw, th


def ray_pixel(camera, pix, order: str | None = None):
    """Map a linear pixel rank to (px, py).

    order='tile' renumbers pixels tile-major (default tiles up to
    128x128): consecutive ray indices then cover a compact 2-D tile
    instead of a 1280-wide row band, so the ~65k in-flight rays of the
    persistent machine stay spatially coherent (gathers may reward index
    locality).  Default 'row' keeps the reference's row-major order.
    None reads StepperConfig.from_env-style DEFAULT_STEPPER."""
    if order is None:
        order = DEFAULT_STEPPER.ray_order
    w, h = camera.resolution
    if order == "tile":
        tw, th = _tile_dims(w, h)
        per_tile = jnp.uint32(tw * th)
        tiles_x = jnp.uint32(w // tw)
        tile = pix // per_tile
        r = pix % per_tile
        px = (tile % tiles_x) * jnp.uint32(tw) + r % jnp.uint32(tw)
        py = (tile // tiles_x) * jnp.uint32(th) + r // jnp.uint32(tw)
        return px.astype(m.Float), py.astype(m.Float)
    px = (pix % jnp.uint32(w)).astype(m.Float)
    py = (pix // jnp.uint32(w)).astype(m.Float)
    return px, py


def ray_positions(camera, seed, idx, spp: int):
    """Film position of camera ray `idx` — pixel corner + RNG jitter,
    exactly as _refill_persistent armed it (dimension 0 of the lane)."""
    pix = idx // jnp.uint32(spp)
    px, py = ray_pixel(camera, pix)
    jitter = _rand(seed, idx, jnp.zeros_like(idx), 2)
    return jnp.stack([px, py], axis=-1) + jitter


@partial(jax.jit, static_argnames=("spp", "rfilter", "w", "h"))
def splat_deferred(camera, seed, rayL, idx0, n_valid, *, spp: int,
                   rfilter: str, w: int, h: int):
    """One whole-frame filter splat of a deferred per-ray radiance buffer
    (rows = camera rays idx0 .. idx0+len), gated to the first n_valid."""
    n = rayL.shape[0]
    idx = jnp.uint32(idx0) + jnp.arange(n, dtype=jnp.uint32)
    pos = ray_positions(camera, seed, idx, spp)
    film = filmlib.new_film(w, h)
    return filmlib.put(
        film, pos, rayL,
        active=jnp.arange(n, dtype=jnp.uint32) < n_valid, rfilter=rfilter,
    )


def _shade(scene: Scene, seed, doneA, hit_o, hit_d, hit_t, hit_face,
           hit_u, hit_v, L, f, eta, depth, prev_p, prev_pdf, prev_delta,
           idx, *, max_depth: int, rr_depth: int):
    """Pure shading of completed closest-hits, exactly as
    wavefront._bounce (emission MIS -> NEE sample -> BSDF sample -> RR).
    Takes explicit hit + path-state arrays (no PersistentState) so both
    the single-path machine (_transition_trace) and the two-path pipelined
    machine (integrators/pipelined.py) share the same estimator math and
    RNG dimensions.  Returns a SimpleNamespace of post-shade fields; the
    caller commits them under its own masks."""
    mats, tex = scene.materials, scene.textures

    ray = Ray.make(hit_o, hit_d)
    t_out = jnp.where(hit_face >= 0, hit_t, jnp.inf)
    si, si_row = _make_si(scene, ray, t_out, hit_face, hit_u, hit_v,
                          return_row=True)
    hit = doneA & si.valid

    # ---------------- emission at the hit (ray-first MIS) ----------------
    ref = SimpleNamespace(p=prev_p)
    gate = doneA & (prev_pdf > 0.0)
    em_pdf = pdf_emitter_direction_packed(
        scene, ref, si, si_row[:, 27], si_row[:, 28],
        gate & ~prev_delta,
    )
    mis_hit = jnp.where(prev_delta, 1.0, mis_weight(prev_pdf, em_pdf))
    L = L + jnp.where(
        (gate & hit)[:, None],
        f * eval_emitter(scene, si, hit) * mis_hit[:, None], 0.0,
    )
    esc = doneA & ~si.valid & (prev_pdf > 0.0)
    env_pdf = pdf_environment_direction(scene, hit_d, esc & ~prev_delta)
    mis_env = jnp.where(prev_delta, 1.0, mis_weight(prev_pdf, env_pdf))
    L = L + jnp.where(
        esc[:, None],
        f * eval_environment(scene, esc, hit_d) * mis_env[:, None], 0.0,
    )

    # ------------------------- NEE at the surface ------------------------
    cont = hit & (depth < max_depth)
    base = jnp.uint32(2) + jnp.uint32(6) * (depth - 1).astype(jnp.uint32)
    flags = bsdflib.bsdf_flags(mats, si.mat_id)
    active_em = cont & has_flag(flags, BSDFFlags.Smooth)

    u_em = _rand(seed, idx, base, 2)
    ds, em_weight = sample_emitter_direction(
        scene, si, u_em, False, active_em
    )
    active_em &= ds.pdf != 0.0
    wo = si.to_local(ds.d)

    u1 = _rand(seed, idx, base + jnp.uint32(2), 1)
    u2 = _rand(seed, idx, base + jnp.uint32(3), 2)
    bsdf_val, bsdf_pdf, bs, bsdf_weight = bsdflib.eval_pdf_sample(
        mats, tex, si, wo, u1, u2, cont
    )
    mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf))
    nee_L = jnp.where(
        active_em[:, None],
        f * bsdf_val * em_weight * mis_em[:, None], 0.0,
    )

    # ------------------- BSDF bounce + Russian roulette ------------------
    f2 = f * bsdf_weight
    eta2 = eta * bs.eta
    fmax = m.max_component(f2)
    rr_prob = jnp.minimum(fmax * eta2 * eta2, 0.95)
    rr_active = depth >= rr_depth
    u_rr = _rand(seed, idx, base + jnp.uint32(5), 1)
    rr_continue = u_rr < rr_prob
    f2 = jnp.where(
        rr_active[:, None],
        f2 * m.safe_rcp(jax.lax.stop_gradient(rr_prob))[:, None], f2,
    )
    cont2 = cont & (fmax != 0.0) & (~rr_active | rr_continue)
    ray2 = si.spawn_ray(si.to_world(bs.wo))
    shadow = si.spawn_ray_to(ds.p)

    return SimpleNamespace(
        L=L, f=f2, eta=eta2, p=si.p, pdf=bs.pdf,
        delta=has_flag(bs.sampled_type, BSDFFlags.Delta),
        nee_L=nee_L, next_o=ray2.o, next_d=ray2.d, cont=cont2,
        shadow_o=shadow.o, shadow_d=shadow.d, shadow_maxt=shadow.maxt,
        active_em=active_em,
    )


def _transition_trace(scene: Scene, st: PersistentState, seed, *,
                      max_depth: int, rr_depth: int):
    """P_TRACE lanes whose closest-hit finished: shade the surface
    (_shade), leaving the shadow query armed and the next ray pending."""
    doneA = st.alive & (st.phase == P_TRACE) & (st.tr_cur == DONE)
    sh = _shade(
        scene, seed, doneA, st.tr_o, st.tr_d, st.tr_t, st.tr_face,
        st.tr_u, st.tr_v, st.L, st.f, st.eta, st.depth, st.prev_p,
        st.prev_pdf, st.prev_delta, st.idx,
        max_depth=max_depth, rr_depth=rr_depth,
    )

    # --------------- commit for doneA lanes; arm shadow query ------------
    d3 = doneA[:, None]
    st = dataclasses.replace(st,
        L=jnp.where(d3, sh.L, st.L),
        f=jnp.where((doneA & sh.cont)[:, None], sh.f, st.f),
        eta=jnp.where(doneA & sh.cont, sh.eta, st.eta),
        depth=jnp.where(doneA & sh.cont, st.depth + 1, st.depth),
        prev_p=jnp.where(d3, sh.p, st.prev_p),
        prev_pdf=jnp.where(doneA, sh.pdf, st.prev_pdf),
        prev_delta=jnp.where(doneA, sh.delta, st.prev_delta),
        nee_L=jnp.where(d3, sh.nee_L, st.nee_L),
        next_o=jnp.where(d3, sh.next_o, st.next_o),
        next_d=jnp.where(d3, sh.next_d, st.next_d),
        cont=jnp.where(doneA, sh.cont, st.cont),
        phase=jnp.where(doneA, P_SHADOW, st.phase),
    )
    st = _start_traversal(st, doneA & sh.active_em, sh.shadow_o,
                          sh.shadow_d, sh.shadow_maxt)
    # lanes with no NEE query finish P_SHADOW trivially (tr_cur stays DONE,
    # tr_face < 0 -> unoccluded but nee_L = 0)
    st = dataclasses.replace(st,
        tr_face=jnp.where(doneA & ~sh.active_em, -1, st.tr_face),
        tr_cur=jnp.where(doneA & ~sh.active_em, DONE, st.tr_cur),
    )
    return st


def _refill_persistent(scene: Scene, st: PersistentState, next_ray, seed, *,
                       spp: int, ray_end):
    """Dead lanes take fresh camera rays (prefix-sum ranked, fixed shapes;
    same scheme as wavefront._refill_impl)."""
    dead = ~st.alive
    rank = jnp.cumsum(dead.astype(jnp.int32)) - dead.astype(jnp.int32)
    new_idx = next_ray + rank.astype(jnp.uint32)
    take = dead & (new_idx < jnp.uint32(ray_end))

    pos = ray_positions(scene.camera, seed, new_idx, spp)
    ray = sensorlib.sample_ray(scene.camera, pos)

    n = st.alive.shape[0]
    t3 = take[:, None]
    st = dataclasses.replace(st,
        L=jnp.where(t3, 0.0, st.L),
        f=jnp.where(t3, 1.0, st.f),
        eta=jnp.where(take, 1.0, st.eta),
        depth=jnp.where(take, 1, st.depth),
        prev_p=jnp.where(t3, ray.o, st.prev_p),
        prev_pdf=jnp.where(take, 1.0, st.prev_pdf),
        prev_delta=jnp.where(take, True, st.prev_delta),
        idx=jnp.where(take, new_idx, st.idx),
        alive=st.alive | take,
        nee_L=jnp.where(t3, 0.0, st.nee_L),
        cont=jnp.where(take, False, st.cont),
        phase=jnp.where(take, P_TRACE, st.phase),
    )
    st = _start_traversal(st, take, ray.o, ray.d,
                          jnp.full((n,), jnp.inf, m.Float))
    return st, next_ray + jnp.sum(take.astype(jnp.uint32))


@partial(
    jax.jit,
    static_argnames=("n_nodes", "spp", "max_depth", "rr_depth", "steps",
                     "n_rounds", "idle_spread"),
    donate_argnums=(1, 2, 3),
)
def _run_persistent(scene: Scene, st: PersistentState, rayL, next_ray,
                    seed, ray_end, unified, idx0, *, n_nodes: int, spp: int,
                    max_depth: int, rr_depth: int, steps: int,
                    n_rounds: int, idle_spread: bool = True):
    """`rayL` is the deferred per-ray radiance buffer (rows + 1 dummy);
    `idx0` the camera-ray index of its row 0 (device offset when sharded)."""
    n_pad = jnp.uint32(rayL.shape[0] - 1)
    layout = scene.bvh.layout  # static pytree aux (None -> DEFAULT_LAYOUT)

    def one_round(carry, _):
        st, rayL, next_ray = carry
        st, rayL = _retire(scene, st, rayL, deferred_pad=(n_pad, idx0))
        st = _transition_trace(
            scene, st, seed, max_depth=max_depth, rr_depth=rr_depth
        )
        st, next_ray = _refill_persistent(
            scene, st, next_ray, seed, spp=spp, ray_end=ray_end
        )
        st = _trav_steps(unified, n_nodes, st, steps, layout=layout,
                         idle_spread=idle_spread)
        return (st, rayL, next_ray), None

    (st, rayL, next_ray), _ = jax.lax.scan(
        one_round, (st, rayL, next_ray), None, length=n_rounds
    )
    return st, rayL, next_ray


@jax.jit
def _poll(st: PersistentState, next_ray):
    return jnp.sum(st.alive.astype(jnp.int32)), next_ray


def render_persistent(scene: Scene, seed: int = 0, spp: int = 16,
                      max_depth: int = 16, rr_depth: int = 4,
                      rfilter: str = "box", n_lanes: int = 32768,
                      steps: int = 16, rounds_per_launch: int = 8,
                      stepper: StepperConfig | None = None):
    """Full-frame render with the persistent state-machine wavefront.

    `steps` bounds traversal iterations per round; `rounds_per_launch`
    rounds scan inside each dispatch.

    Film accumulation is deferred (see _retire): rounds scatter-SET each
    finished ray's radiance into `rayL`; the filter splat happens once per
    frame here."""
    w, h = scene.camera.resolution
    n_total = w * h * spp
    n_lanes = min(n_lanes, n_total)
    cfg = stepper if stepper is not None else DEFAULT_STEPPER

    seed_u = jnp.uint32(seed)
    rayL = jnp.zeros((n_total + 1, 3), m.Float)
    lay = scene.bvh.layout or DEFAULT_LAYOUT
    st = PersistentState.empty(n_lanes, stack_depth=lay.stack)
    next_ray = jnp.zeros((), jnp.uint32)
    unified, n_nodes = unify_tables(scene.bvh)
    idx0 = jnp.uint32(0)
    while True:
        st, rayL, next_ray = _run_persistent(
            scene, st, rayL, next_ray, seed_u, jnp.uint32(n_total),
            unified, idx0, n_nodes=n_nodes, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, steps=steps, n_rounds=rounds_per_launch,
            idle_spread=cfg.idle_spread,
        )
        n_alive, cursor = jax.device_get(_poll(st, next_ray))
        if int(cursor) >= n_total and int(n_alive) == 0:
            break
    film = splat_deferred(
        scene.camera, seed_u, rayL[:n_total], idx0, jnp.uint32(n_total),
        spp=spp, rfilter=rfilter, w=w, h=h,
    )
    return filmlib.develop(film)
