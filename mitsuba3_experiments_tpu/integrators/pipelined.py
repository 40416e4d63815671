"""Two-path software-pipelined persistent wavefront (round-4 scheduler).

Why: in the single-path persistent stepper, lanes whose trace query
completed mid-round idle until the out-of-loop shading transition (43% of
gathered rows belonged to idle lanes when this was measured on the
accelerator the system was first built for; on the GPU the share is not
measured yet).  Shorter rounds cut the idle but multiply the transitions
that amortize it.

The structural fix: each lane holds TWO independent paths (A, B) sharing
ONE traversal engine.  When the engine finishes path A's trace query, its
hit is saved to A's slot and the engine switches to B's pending query in
the same iteration — shadow rays, next-bounce rays, or fresh camera rays
queued at the last transition.  Rounds stay long (transition amortization
intact) while the idle iterations fill with the other path's work.  At the
round boundary, BOTH paths' completed traces are shaded (two masked passes
of the same `_shade` core — per-bounce transition cost is unchanged).

Scheduling changes only WHICH rows the engine gathers, not any estimate:
paths carry their own camera-ray index, so RNG dimensions, shading math
(persistent._shade) and per-ray radiance are identical to render() /
render_persistent (equality-tested).

Reference lineage: replaces the hardware SIMT scheduler that keeps OptiX
warps busy across divergent path lengths (/root/reference/path.py:238,281
megakernel traces); SURVEY.md section 7 "hard parts" #1.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.struct import jstruct
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..scene.types import Scene
from .persistent import (
    DEFAULT_LAYOUT,
    DONE,
    _engine_step,
    _shade,
    ray_positions,
    splat_deferred,
    unify_tables,
)

# per-path phases
PH_DEAD = 0       # no work (refill target)
PH_TRACE_PQ = 1   # trace pending, ray in qt_* (fresh camera ray)
PH_TRACE_PN = 2   # trace pending, ray in next_* (armed by shadow resolve)
PH_TRACE_RQ = 3   # trace running in engine (ray source qt_*)
PH_TRACE_RN = 4   # trace running (ray source next_*)
PH_READY_Q = 5    # trace done, hit saved in h_*, awaiting shading
PH_READY_N = 6
PH_SHADOW_P = 7   # shadow pending, ray in qt_*
PH_SHADOW_R = 8   # shadow running in engine
PH_RETIRE = 9     # path finished; L awaits the deferred splat


@jstruct
class PipelinedState:
    """Per-lane: S path slots (default 2) + one shared traversal engine.

    Path-slot fields are stored SLOT-MAJOR (S, N) / (S, N, 3): a (N, S)
    array has a 2-wide minor dimension, which tiled layouts pad badly, and
    slot-major everywhere removes every per-round transpose.  Lane
    sharding under shard_map uses PipelinedState.pspec() (slot fields
    shard axis 1, engine fields axis 0).

    `Closure-class` fields are written only at round transitions, so the
    stepper reads them as loop-invariant closures and the fori_loop carry
    stays small (the round-3 t-stack lesson: carry columns cost real
    streaming bandwidth).
    """

    # ---- closure-class path state (constant within a round) ----
    f: jnp.ndarray          # (S, N, 3) throughput at the next ray
    eta: jnp.ndarray        # (S, N)
    depth: jnp.ndarray      # (S, N) i32
    prev_p: jnp.ndarray     # (S, N, 3)
    prev_pdf: jnp.ndarray   # (S, N)
    prev_delta: jnp.ndarray  # (S, N) bool
    idx: jnp.ndarray        # (S, N) u32 camera-ray index
    nee_L: jnp.ndarray      # (S, N, 3) pending NEE contribution
    next_o: jnp.ndarray     # (S, N, 3) next path ray (source for TRACE_*N)
    next_d: jnp.ndarray     # (S, N, 3)
    cont: jnp.ndarray       # (S, N) bool
    qt_o: jnp.ndarray       # (S, N, 3) transition-armed query (camera or
    qt_d: jnp.ndarray       # (S, N, 3)  shadow ray; source for *_PQ / _P)
    qt_maxt: jnp.ndarray    # (S, N)
    sh_depth: jnp.ndarray   # (S, N) i32 bounce of the pending shadow ray
    #                         (recorder bookkeeping; set at shading)
    # ---- carried path state (mutated inside the stepper) ----
    phase: jnp.ndarray      # (S, N) i32
    own: jnp.ndarray        # (N,) i32 which slot owns the engine
    L: jnp.ndarray          # (S, N, 3)
    h_t: jnp.ndarray        # (S, N) saved trace hit
    h_face: jnp.ndarray     # (S, N) i32
    h_u: jnp.ndarray        # (S, N)
    h_v: jnp.ndarray        # (S, N)
    # ---- shared traversal engine (as persistent.PersistentState) ----
    tr_o: jnp.ndarray       # (N, 3)
    tr_d: jnp.ndarray       # (N, 3)
    tr_cur: jnp.ndarray     # (N,) i32
    tr_sp: jnp.ndarray      # (N,) i32
    tr_stack: jnp.ndarray   # (N, S) i32
    tr_t: jnp.ndarray       # (N,)
    tr_face: jnp.ndarray    # (N,) i32
    tr_u: jnp.ndarray       # (N,)
    tr_v: jnp.ndarray       # (N,)

    @property
    def n_slots(self) -> int:
        return self.phase.shape[0]

    @staticmethod
    def empty(n: int, stack_depth: int | None = None, n_slots: int = 2):
        sd = DEFAULT_LAYOUT.stack if stack_depth is None else stack_depth
        S = n_slots
        z23 = lambda v=0.0: jnp.full((S, n, 3), v, m.Float)  # noqa: E731
        z2 = lambda v=0.0: jnp.full((S, n), v, m.Float)      # noqa: E731
        i2 = lambda v=0: jnp.full((S, n), v, jnp.int32)      # noqa: E731
        return PipelinedState(
            f=z23(1.0), eta=z2(1.0), depth=i2(1),
            prev_p=z23(), prev_pdf=z2(1.0),
            prev_delta=jnp.ones((S, n), bool),
            idx=jnp.zeros((S, n), jnp.uint32),
            nee_L=z23(), next_o=z23(), next_d=z23(),
            cont=jnp.zeros((S, n), bool),
            qt_o=z23(), qt_d=z23(), qt_maxt=z2(), sh_depth=i2(1),
            phase=i2(PH_DEAD), own=jnp.zeros((n,), jnp.int32),
            L=z23(), h_t=z2(), h_face=i2(-1), h_u=z2(), h_v=z2(),
            tr_o=jnp.zeros((n, 3), m.Float), tr_d=jnp.zeros((n, 3), m.Float),
            tr_cur=jnp.full((n,), DONE, jnp.int32),
            tr_sp=jnp.zeros((n,), jnp.int32),
            tr_stack=jnp.zeros((n, sd), jnp.int32),
            tr_t=z2()[0], tr_face=jnp.full((n,), -1, jnp.int32),
            tr_u=z2()[0], tr_v=z2()[0],
        )

    @staticmethod
    def pspec(axis: str = "dp"):
        """PartitionSpec pytree for lane sharding under shard_map: slot
        fields (S, N, ...) shard axis 1, engine fields (N, ...) axis 0."""
        from jax.sharding import PartitionSpec as P

        lane0, slot1 = P(axis), P(None, axis)
        return PipelinedState(
            f=slot1, eta=slot1, depth=slot1, prev_p=slot1,
            prev_pdf=slot1, prev_delta=slot1, idx=slot1, nee_L=slot1,
            next_o=slot1, next_d=slot1, cont=slot1, qt_o=slot1,
            qt_d=slot1, qt_maxt=slot1, sh_depth=slot1, phase=slot1,
            own=lane0, L=slot1, h_t=slot1, h_face=slot1, h_u=slot1,
            h_v=slot1, tr_o=lane0, tr_d=lane0, tr_cur=lane0, tr_sp=lane0,
            tr_stack=lane0, tr_t=lane0, tr_face=lane0, tr_u=lane0,
            tr_v=lane0,
        )


# ---- slot helpers: pure elementwise selects, never gathers ----


def _sel(a, own):
    """Slot-major a[own] as an elementwise select (any slot count;
    `own` may be any (N,) int array, e.g. a round-robin candidate)."""
    S = a.shape[0]
    if a.ndim == 2:
        out = a[0]
        for s in range(1, S):
            out = jnp.where(own == s, a[s], out)
        return out
    out = a[0]
    for s in range(1, S):
        out = jnp.where((own == s)[:, None], a[s], out)
    return out


def _put(a, own, mask, val):
    """Slot-major a[own] = val where mask (elementwise, any slot count)."""
    S = a.shape[0]
    if a.ndim == 2:
        return jnp.stack(
            [jnp.where(mask & (own == s), val, a[s]) for s in range(S)],
            axis=0,
        )
    return jnp.stack(
        [jnp.where((mask & (own == s))[:, None], val, a[s])
         for s in range(S)], axis=0,
    )


def _pending(ph):
    return (ph == PH_TRACE_PQ) | (ph == PH_TRACE_PN) | (ph == PH_SHADOW_P)


def _complete_and_arm(cl, ph, own, L, h_t, h_face, h_u, h_v,
                      tro, trd, cur, sp, t, face, u, v, occm=None):
    """Elementwise completion + engine (re)arming — the scheduler core.

    `cl` holds the closure-class fields (SimpleNamespace-like view of the
    state).  Runs at the top of every stepper iteration and once more at
    the round boundary (to catch the final iteration's completion).
    One-shot by construction: completions flip the phase they trigger on.

    All slot arrays (ph, L, h_*, cl.*) are SLOT-MAJOR (2, N, ...); occm
    (recorder only) is (2, W, N) uint32 — a per-slot occlusion BITMASK:
    bit (sh_depth-1) of the slot's words records whether its NEE shadow
    ray at that bounce was occluded.  Packed words instead of (2, D, N)
    bools keep the stepper carry small (3 words cover depth 65 where the
    single-path recorder streams 65 bool columns per iteration).
    """
    done = cur == DONE
    php = _sel(ph, own)

    # ---- shadow completion: resolve inline, chain to the next trace ----
    sfin = done & (php == PH_SHADOW_R)
    occluded = face >= 0
    addL = sfin & ~occluded
    L = _put(L, own, addL, _sel(L, own) + _sel(cl.nee_L, own))
    if occm is not None:
        bitpos = (_sel(cl.sh_depth, own) - 1).astype(jnp.uint32)
        word = (bitpos // 32).astype(jnp.int32)
        v_bit = jnp.where(
            sfin & occluded,
            jnp.uint32(1) << (bitpos % 32), jnp.uint32(0),
        )
        cols = []
        for wdx in range(occm.shape[1]):
            w2 = occm[:, wdx]
            cols.append(_put(w2, own, sfin & (word == wdx),
                             _sel(w2, own) | v_bit))
        occm = jnp.stack(cols, axis=1)
    contp = _sel(cl.cont, own)
    ph = _put(ph, own, sfin,
              jnp.where(contp, PH_TRACE_PN, PH_RETIRE))

    # ---- trace completion: save the hit, park as READY ----
    tfin = done & ((php == PH_TRACE_RQ) | (php == PH_TRACE_RN))
    h_t = _put(h_t, own, tfin, t)
    h_face = _put(h_face, own, tfin, face)
    h_u = _put(h_u, own, tfin, u)
    h_v = _put(h_v, own, tfin, v)
    ph = _put(ph, own, tfin,
              jnp.where(php == PH_TRACE_RQ, PH_READY_Q, PH_READY_N))

    # ---- engine arming: own slot first, else round-robin to the next
    # pending slot (S=2 reduces to the original "switch to the other") ----
    S = ph.shape[0]
    own_pend = _pending(_sel(ph, own))
    new_own = own
    found = own_pend
    for k in range(1, S):
        cand = jax.lax.rem(own + k, S)
        cand_pend = _pending(_sel(ph, cand))
        new_own = jnp.where(done & ~found & cand_pend, cand, new_own)
        found = found | cand_pend
    own = new_own
    p3 = _sel(ph, own)
    arm = done & _pending(p3)
    from_next = p3 == PH_TRACE_PN
    qo = jnp.where(from_next[:, None], _sel(cl.next_o, own),
                   _sel(cl.qt_o, own))
    qd = jnp.where(from_next[:, None], _sel(cl.next_d, own),
                   _sel(cl.qt_d, own))
    qmax = jnp.where(p3 == PH_SHADOW_P, _sel(cl.qt_maxt, own), jnp.inf)
    a3 = arm[:, None]
    tro = jnp.where(a3, qo, tro)
    trd = jnp.where(a3, qd, trd)
    cur = jnp.where(arm, jnp.int32(0), cur)
    sp = jnp.where(arm, 0, sp)
    t = jnp.where(arm, qmax, t)
    face = jnp.where(arm, -1, face)
    u = jnp.where(arm, 0.0, u)
    v = jnp.where(arm, 0.0, v)
    run_ph = jnp.where(
        p3 == PH_TRACE_PQ, PH_TRACE_RQ,
        jnp.where(p3 == PH_TRACE_PN, PH_TRACE_RN, PH_SHADOW_R),
    )
    ph = _put(ph, own, arm, run_ph)
    out = (ph, own, L, h_t, h_face, h_u, h_v, tro, trd, cur, sp, t, face,
           u, v)
    return out + (occm,) if occm is not None else out


def _slot_major_closures(st: PipelinedState):
    """The closure-class fields the scheduler reads every iteration —
    already slot-major in the state, no copies."""
    from types import SimpleNamespace

    return SimpleNamespace(
        nee_L=st.nee_L, cont=st.cont,
        next_o=st.next_o, next_d=st.next_d,
        qt_o=st.qt_o, qt_d=st.qt_d,
        qt_maxt=st.qt_maxt, sh_depth=st.sh_depth,
    )


def _stepper(unified, n_nodes: int, st: PipelinedState, k: int, *,
             layout=None, idle_spread: bool = True, occm=None,
             arm_every: int = 1):
    """Advance the engines by at most k iterations, scheduling both slots
    (see module docstring).  The engine body is persistent._engine_step —
    identical traversal math to the single-path stepper.  With `occm`
    ((S, W, N), recorder), returns (state, occm).

    `arm_every` (round-4 chunked arming): run the scheduler
    (_complete_and_arm) every arm_every-th engine iteration instead of
    every iteration.  Legal because a completed engine lane is a no-op
    (cur == DONE gathers a discarded spread row) and no re-arming happens
    mid-chunk, so `any_hit` and the ray registers are chunk-invariant —
    the inner engine loop then carries ONLY the seven traversal registers
    (the slot streams ph/L/h_* are touched once per chunk, not per
    iteration).  Estimates are identical (scheduling changes which rows
    get gathered, never any value); the cost is up to arm_every-1 idle
    iterations per completed query."""
    lay = layout if layout is not None else DEFAULT_LAYOUT
    cl = _slot_major_closures(st)
    rec = occm is not None
    ka = max(1, min(arm_every, k))

    def make_body(chunk_len):
        def body(_, carry):
            if rec:
                (ph, own, L, h_t, h_face, h_u, h_v,
                 tro, trd, cur, sp, stack, t, face, u, v, occm) = carry
            else:
                (ph, own, L, h_t, h_face, h_u, h_v,
                 tro, trd, cur, sp, stack, t, face, u, v) = carry
                occm = None
            out = _complete_and_arm(
                cl, ph, own, L, h_t, h_face, h_u, h_v,
                tro, trd, cur, sp, t, face, u, v, occm=occm,
            )
            (ph, own, L, h_t, h_face, h_u, h_v, tro, trd, cur, sp, t,
             face, u, v) = out[:15]
            if rec:
                occm = out[15]
            any_hit = _sel(ph, own) == PH_SHADOW_R
            if chunk_len == 1:
                cur, sp, stack, t, face, u, v = _engine_step(
                    unified, n_nodes, lay, idle_spread, tro, trd, any_hit,
                    cur, sp, stack, t, face, u, v,
                )
            else:
                def engine_only(_, ec):
                    return _engine_step(
                        unified, n_nodes, lay, idle_spread, tro, trd,
                        any_hit, *ec,
                    )

                cur, sp, stack, t, face, u, v = jax.lax.fori_loop(
                    0, chunk_len, engine_only,
                    (cur, sp, stack, t, face, u, v)
                )
            res = (ph, own, L, h_t, h_face, h_u, h_v,
                   tro, trd, cur, sp, stack, t, face, u, v)
            return res + (occm,) if rec else res

        return body

    # k need not divide by ka: full chunks then one clamped remainder
    # chunk, so the round runs EXACTLY k engine iterations (values are
    # scheduling-independent either way; this keeps the documented
    # "at most k iterations" cost contract exact).
    n_full, rem = divmod(k, ka)

    init = (st.phase, st.own, st.L, st.h_t,
            st.h_face, st.h_u, st.h_v,
            st.tr_o, st.tr_d, st.tr_cur, st.tr_sp, st.tr_stack, st.tr_t,
            st.tr_face, st.tr_u, st.tr_v)
    if rec:
        init = init + (occm,)
    fin = init
    if n_full:
        fin = jax.lax.fori_loop(0, n_full, make_body(ka), fin)
    if rem:
        fin = make_body(rem)(0, fin)
    (ph, own, L, h_t, h_face, h_u, h_v, tro, trd, cur, sp, stack, t,
     face, u, v) = fin[:16]
    st = dataclasses.replace(
        st, phase=ph, own=own, L=L, h_t=h_t,
        h_face=h_face, h_u=h_u, h_v=h_v,
        tr_o=tro, tr_d=trd, tr_cur=cur, tr_sp=sp, tr_stack=stack,
        tr_t=t, tr_face=face, tr_u=u, tr_v=v,
    )
    if rec:
        return st, fin[16]
    return st


def _finish_round(st: PipelinedState, occm=None):
    """Round-boundary completion catch-up (the stepper handles completions
    at the TOP of each iteration, so the final iteration's completion is
    still pending here) — pure elementwise, includes re-arming.  occm is
    (S, W, N) as stored."""
    out = _complete_and_arm(
        _slot_major_closures(st), st.phase, st.own, st.L,
        st.h_t, st.h_face, st.h_u, st.h_v,
        st.tr_o, st.tr_d, st.tr_cur, st.tr_sp, st.tr_t, st.tr_face,
        st.tr_u, st.tr_v,
        occm=occm,
    )
    (ph, own, L, h_t, h_face, h_u, h_v, tro, trd, cur, sp, t, face, u,
     v) = out[:15]
    st = dataclasses.replace(
        st, phase=ph, own=own, L=L, h_t=h_t,
        h_face=h_face, h_u=h_u, h_v=h_v,
        tr_o=tro, tr_d=trd, tr_cur=cur, tr_sp=sp, tr_t=t,
        tr_face=face, tr_u=u, tr_v=v,
    )
    if occm is not None:
        return st, out[15]
    return st


def _retire_pipelined(st: PipelinedState, rayL, *, deferred_pad):
    """Deferred splat of finished paths (both slots), as persistent._retire."""
    n_pad, idx0 = deferred_pad
    for p in range(st.n_slots):
        ret = st.phase[p] == PH_RETIRE
        Lp = st.L[p]
        dst = jnp.where(ret, st.idx[p] - idx0, n_pad)
        rayL = rayL.at[dst].set(jnp.where(jnp.isfinite(Lp), Lp, 0.0))
        st = dataclasses.replace(
            st, phase=st.phase.at[p].set(
                jnp.where(ret, PH_DEAD, st.phase[p])
            ),
        )
    return st, rayL


def _retire_dense(st: PipelinedState, rayG, idx0):
    """Generation-indexed DENSE retire (round-5): with strided ray
    ownership (ray idx = idx0 + g*S*N + p*N + i — see _refill_strided),
    a retiring slot's destination is a deterministic function of (g, p,
    lane), so the deferred-radiance write is a dense `where` over the
    (G, N) generation plane instead of a scatter: the two per-slot
    scatters cost a full row each EVERY round regardless of how few slots
    actually retire, while this dense form streams G*N rows.  rayG is
    (G, S, N, 3); reshape(-1, 3) is ray order."""
    G, S, n = rayG.shape[0], rayG.shape[1], rayG.shape[2]
    gi = jnp.arange(G, dtype=jnp.uint32)[:, None]
    for p in range(S):
        ret = st.phase[p] == PH_RETIRE
        g = (st.idx[p] - idx0) // jnp.uint32(S * n)
        cond = (gi == g[None, :]) & ret[None, :]
        Lp = st.L[p]
        Lp = jnp.where(jnp.isfinite(Lp), Lp, 0.0)
        rayG = rayG.at[:, p].set(
            jnp.where(cond[..., None], Lp[None], rayG[:, p])
        )
        st = dataclasses.replace(
            st, phase=st.phase.at[p].set(
                jnp.where(ret, PH_DEAD, st.phase[p])
            ),
        )
    return st, rayG


def _transition_pipelined(scene: Scene, st: PipelinedState, seed, *,
                          max_depth: int, rr_depth: int, rec=None):
    """Shade both slots' READY paths with the shared persistent._shade
    core, then queue their shadow (or next/retire) work.

    `rec` (recorder): (prim, u, v) tuple of (S, N, D) slot-local record
    arrays; each shaded slot's saved hit is written at column depth-1 and
    its sh_depth bookkeeping set (the occlusion bit lands in the stepper's
    bitmask at resolve time).  Returns (st, rec) then."""
    record = rec is not None
    if record:
        r_prim, r_u, r_v = rec
        colD = jnp.arange(r_prim.shape[2], dtype=jnp.int32)[None, :]
    for p in range(st.n_slots):
        ph = st.phase[p]
        doneA = (ph == PH_READY_Q) | (ph == PH_READY_N)
        if record:
            sel = (colD == (st.depth[p] - 1)[:, None]) & doneA[:, None]
            r_prim = r_prim.at[p].set(
                jnp.where(sel, st.h_face[p][:, None], r_prim[p]))
            r_u = r_u.at[p].set(
                jnp.where(sel, st.h_u[p][:, None], r_u[p]))
            r_v = r_v.at[p].set(
                jnp.where(sel, st.h_v[p][:, None], r_v[p]))
            st = dataclasses.replace(
                st, sh_depth=st.sh_depth.at[p].set(
                    jnp.where(doneA, st.depth[p], st.sh_depth[p])),
            )
        from_n = (ph == PH_READY_N)[:, None]
        hit_o = jnp.where(from_n, st.next_o[p], st.qt_o[p])
        hit_d = jnp.where(from_n, st.next_d[p], st.qt_d[p])
        sh = _shade(
            scene, seed, doneA, hit_o, hit_d, st.h_t[p],
            st.h_face[p], st.h_u[p], st.h_v[p], st.L[p],
            st.f[p], st.eta[p], st.depth[p], st.prev_p[p],
            st.prev_pdf[p], st.prev_delta[p], st.idx[p],
            max_depth=max_depth, rr_depth=rr_depth,
        )
        d3 = doneA[:, None]
        adv = doneA & sh.cont
        new_ph = jnp.where(
            doneA & sh.active_em, PH_SHADOW_P,
            jnp.where(adv, PH_TRACE_PN, jnp.where(doneA, PH_RETIRE, ph)),
        )
        st = dataclasses.replace(
            st,
            L=st.L.at[p].set(jnp.where(d3, sh.L, st.L[p])),
            f=st.f.at[p].set(
                jnp.where(adv[:, None], sh.f, st.f[p])),
            eta=st.eta.at[p].set(
                jnp.where(adv, sh.eta, st.eta[p])),
            depth=st.depth.at[p].set(
                jnp.where(adv, st.depth[p] + 1, st.depth[p])),
            prev_p=st.prev_p.at[p].set(
                jnp.where(d3, sh.p, st.prev_p[p])),
            prev_pdf=st.prev_pdf.at[p].set(
                jnp.where(doneA, sh.pdf, st.prev_pdf[p])),
            prev_delta=st.prev_delta.at[p].set(
                jnp.where(doneA, sh.delta, st.prev_delta[p])),
            nee_L=st.nee_L.at[p].set(
                jnp.where(d3, sh.nee_L, st.nee_L[p])),
            next_o=st.next_o.at[p].set(
                jnp.where(d3, sh.next_o, st.next_o[p])),
            next_d=st.next_d.at[p].set(
                jnp.where(d3, sh.next_d, st.next_d[p])),
            cont=st.cont.at[p].set(
                jnp.where(doneA, sh.cont, st.cont[p])),
            qt_o=st.qt_o.at[p].set(jnp.where(
                (doneA & sh.active_em)[:, None], sh.shadow_o,
                st.qt_o[p])),
            qt_d=st.qt_d.at[p].set(jnp.where(
                (doneA & sh.active_em)[:, None], sh.shadow_d,
                st.qt_d[p])),
            qt_maxt=st.qt_maxt.at[p].set(jnp.where(
                doneA & sh.active_em, sh.shadow_maxt, st.qt_maxt[p])),
            phase=st.phase.at[p].set(new_ph),
        )
    return (st, (r_prim, r_u, r_v)) if record else st


def _refill_pipelined(scene: Scene, st: PipelinedState, next_ray, seed, *,
                      spp: int, ray_end, strided: bool = False):
    """Dead slots take fresh camera rays (prefix-sum ranked per slot).

    `strided=True` (round-5 dense-retire mode): slot (p, lane i) OWNS the
    strided ray subsequence idx0 + g*S*N + p*N + i, g = 0,1,... — no
    prefix-sum allocation, and retire destinations become gen-indexed
    (see _retire_dense).  Estimates are identical either way (RNG and
    shading key on the RAY index, never the lane), only which lane traces
    which ray changes.  next_ray still accumulates the number of taken
    rays, so the host poll's completion condition is unchanged."""
    S = st.n_slots
    n = st.phase.shape[1]
    for p in range(st.n_slots):
        dead = st.phase[p] == PH_DEAD
        if strided:
            # idx holds the slot's PREVIOUS ray (init: one stride below
            # the first owned ray, exact under uint32 wraparound)
            new_idx = st.idx[p] + jnp.uint32(S * n)
        else:
            di = dead.astype(jnp.int32)
            rank = jnp.cumsum(di) - di
            new_idx = next_ray + rank.astype(jnp.uint32)
        take = dead & (new_idx < jnp.uint32(ray_end))
        pos = ray_positions(scene.camera, seed, new_idx, spp)
        ray = sensorlib.sample_ray(scene.camera, pos)
        t3 = take[:, None]
        st = dataclasses.replace(
            st,
            L=st.L.at[p].set(jnp.where(t3, 0.0, st.L[p])),
            f=st.f.at[p].set(jnp.where(t3, 1.0, st.f[p])),
            eta=st.eta.at[p].set(jnp.where(take, 1.0, st.eta[p])),
            depth=st.depth.at[p].set(
                jnp.where(take, 1, st.depth[p])),
            prev_p=st.prev_p.at[p].set(
                jnp.where(t3, ray.o, st.prev_p[p])),
            prev_pdf=st.prev_pdf.at[p].set(
                jnp.where(take, 1.0, st.prev_pdf[p])),
            prev_delta=st.prev_delta.at[p].set(
                jnp.where(take, True, st.prev_delta[p])),
            idx=st.idx.at[p].set(
                jnp.where(take, new_idx, st.idx[p])),
            nee_L=st.nee_L.at[p].set(
                jnp.where(t3, 0.0, st.nee_L[p])),
            cont=st.cont.at[p].set(
                jnp.where(take, False, st.cont[p])),
            qt_o=st.qt_o.at[p].set(
                jnp.where(t3, ray.o, st.qt_o[p])),
            qt_d=st.qt_d.at[p].set(
                jnp.where(t3, ray.d, st.qt_d[p])),
            qt_maxt=st.qt_maxt.at[p].set(
                jnp.where(take, jnp.inf, st.qt_maxt[p])),
            phase=st.phase.at[p].set(
                jnp.where(take, PH_TRACE_PQ, st.phase[p])),
        )
        next_ray = next_ray + jnp.sum(take.astype(jnp.uint32))
    return st, next_ray


@partial(
    jax.jit,
    static_argnames=("n_nodes", "spp", "max_depth", "rr_depth", "steps",
                     "n_rounds", "idle_spread", "arm_every", "dense"),
    donate_argnums=(1, 2, 3),
)
def _run_pipelined(scene: Scene, st: PipelinedState, rayL, next_ray,
                   seed, ray_end, unified, idx0, *, n_nodes: int, spp: int,
                   max_depth: int, rr_depth: int, steps: int,
                   n_rounds: int, idle_spread: bool = True,
                   arm_every: int = 1, dense: bool = False):
    """`dense=False`: rayL is the (rows+1, 3) deferred-radiance buffer,
    retire scatters (legacy).  `dense=True`: rayL is the (G, S, N, 3)
    generation buffer, refill is strided and retire is the dense
    gen-indexed write (round-5; see _retire_dense)."""
    n_pad = jnp.uint32(rayL.shape[0] - 1)
    layout = scene.bvh.layout

    def one_round(carry, _):
        st, rayL, next_ray = carry
        st = _finish_round(st)
        if dense:
            st, rayL = _retire_dense(st, rayL, idx0)
        else:
            st, rayL = _retire_pipelined(
                st, rayL, deferred_pad=(n_pad, idx0))
        st = _transition_pipelined(
            scene, st, seed, max_depth=max_depth, rr_depth=rr_depth
        )
        st, next_ray = _refill_pipelined(
            scene, st, next_ray, seed, spp=spp, ray_end=ray_end,
            strided=dense,
        )
        st = _stepper(unified, n_nodes, st, steps, layout=layout,
                      idle_spread=idle_spread, arm_every=arm_every)
        return (st, rayL, next_ray), None

    (st, rayL, next_ray), _ = jax.lax.scan(
        one_round, (st, rayL, next_ray), None, length=n_rounds
    )
    return st, rayL, next_ray


@jax.jit
def _poll2(st: PipelinedState, next_ray):
    return jnp.sum((st.phase != PH_DEAD).astype(jnp.int32)), next_ray


def render_pipelined(scene: Scene, seed: int = 0, spp: int = 16,
                     max_depth: int = 16, rr_depth: int = 4,
                     rfilter: str = "box", n_lanes: int = 32768,
                     steps: int = 16, rounds_per_launch: int = 8,
                     n_slots: int = 2, arm_every: int = 1,
                     retire: str = "auto", gen_cap: int = 64):
    """Full-frame render with the S-slot pipelined machine.  Per-ray
    radiance is identical to render_persistent (same RNG dims, same
    shading core) — only the engine scheduling differs.  `n_slots` is the
    in-flight paths per lane (2 = the round-4 two-path machine);
    `arm_every` chunks the scheduler to every k-th engine iteration
    (see _stepper).

    `retire`: "dense" uses strided ray ownership + the gen-indexed dense
    retire (replaces the two per-slot scatters); "scatter" the prefix-sum
    refill + scatter retire; "auto" picks dense for DEEP specs
    (max_depth >= 16) when the generation count G = ceil(rays / (S*N))
    fits `gen_cap`.  The split (dense wins deep, loses shallow, where
    strided ownership forfeits the global cursor's load balancing) was
    measured on the accelerator this system was first built for; on the
    GPU it is a hypothesis (ROADMAP queue 1, item 4)."""
    w, h = scene.camera.resolution
    n_total = w * h * spp
    n_lanes = min(n_lanes, max(n_total // n_slots, 1))

    seed_u = jnp.uint32(seed)
    lay = scene.bvh.layout or DEFAULT_LAYOUT
    st = PipelinedState.empty(n_lanes, stack_depth=lay.stack,
                              n_slots=n_slots)
    next_ray = jnp.zeros((), jnp.uint32)
    unified, n_nodes = unify_tables(scene.bvh)
    idx0 = jnp.uint32(0)
    G = (n_total + n_slots * n_lanes - 1) // (n_slots * n_lanes)
    dense = retire == "dense" or (
        retire == "auto" and max_depth >= 16 and G <= gen_cap)
    if dense:
        rayL = jnp.zeros((G, n_slots, n_lanes, 3), m.Float)
        iota = jnp.arange(n_lanes, dtype=jnp.uint32)
        st = dataclasses.replace(st, idx=jnp.stack(
            [idx0 + jnp.uint32(p * n_lanes) + iota
             - jnp.uint32(n_slots * n_lanes) for p in range(n_slots)]))
    else:
        rayL = jnp.zeros((n_total + 1, 3), m.Float)
    while True:
        st, rayL, next_ray = _run_pipelined(
            scene, st, rayL, next_ray, seed_u, jnp.uint32(n_total),
            unified, idx0, n_nodes=n_nodes, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, steps=steps, n_rounds=rounds_per_launch,
            arm_every=arm_every, dense=dense,
        )
        n_alive, cursor = jax.device_get(_poll2(st, next_ray))
        if int(cursor) >= n_total and int(n_alive) == 0:
            break
    if dense:
        rayL = rayL.reshape(G * n_slots * n_lanes, 3)
    film = splat_deferred(
        scene.camera, seed_u, rayL[:n_total], idx0, jnp.uint32(n_total),
        spp=spp, rfilter=rfilter, w=w, h=h,
    )
    return filmlib.develop(film)


# ------------------------- pipelined recorder -------------------------

def _flush_record_pipelined(st: PipelinedState, occm, r_prim, r_u, r_v,
                            glob, idx0):
    from .replay import _prim_encode
    """Flush RETIREd slots' packed record rows into the frame-sized glob
    (one (N, D+1, 4) scatter per slot per round; rows [:D] are the record
    layout of replay._run_record_full — prim bitcast f32, occl as 0/1
    unpacked from the bitmask).  Row D carries the slot's final RADIANCE
    (L.rgb, 0): the recorder runs the full forward machine, so the
    forward film is a FREE byproduct of recording (splat_deferred after
    the loop), which lets replay_grads_sorted skip its entire forward
    bucketed pass (the film it would recompute is bit-identical: same
    rays, same RNG dims, same shading core).  Folding L into the SAME
    packed scatter matters: a row scatter's cost is per operation as much
    as per byte, so a separate (N,3) radiance scatter per slot per round
    would add one more.  Clears the slot to
    PH_DEAD for refill."""
    D = r_prim.shape[2]
    n_pad = glob.shape[0] - 1
    colD = jnp.arange(D, dtype=jnp.uint32)
    for p in range(st.n_slots):
        ret = st.phase[p] == PH_RETIRE
        # unpack occlusion bits for this slot: (N, D) f32 — occm is
        # (S, W, N), so the static word pick gives (D, N) and one
        # transpose per round per slot restores record layout
        words = occm[p, (colD // 32).astype(jnp.int32)]  # (D, N)
        occf = ((words >> (colD % 32)[:, None]) & 1).astype(jnp.float32).T
        Lp = st.L[p]
        L_row = jnp.concatenate(
            [jnp.where(jnp.isfinite(Lp), Lp, 0.0),
             jnp.zeros((Lp.shape[0], 1), Lp.dtype)], axis=-1,
        )
        packed = jnp.concatenate(
            [
                jnp.stack(
                    [
                        _prim_encode(r_prim[p]),
                        r_u[p],
                        r_v[p],
                        occf,
                    ],
                    axis=-1,
                ),
                L_row[:, None, :],
            ],
            axis=1,
        )
        dst = jnp.where(ret, st.idx[p] - jnp.uint32(idx0),
                        jnp.uint32(n_pad))
        glob = glob.at[dst].set(packed)
        st = dataclasses.replace(
            st, phase=st.phase.at[p].set(
                jnp.where(ret, PH_DEAD, st.phase[p])),
        )
        # clear the freed slot's local record so a refill starts clean
        r3 = ret[:, None]
        r_prim = r_prim.at[p].set(jnp.where(r3, -1, r_prim[p]))
        r_u = r_u.at[p].set(jnp.where(r3, 0.0, r_u[p]))
        r_v = r_v.at[p].set(jnp.where(r3, 0.0, r_v[p]))
        occm = occm.at[p].set(
            jnp.where(ret[None, :], jnp.uint32(0), occm[p]))
    return st, occm, r_prim, r_u, r_v, glob


def _flush_record_dense(st: PipelinedState, occm, r_prim, r_u, r_v,
                        globG, idx0):
    """Gen-indexed DENSE record flush (round-5): the strided-ownership
    analog of _flush_record_pipelined.  globG is (G, S, N, D+1, 4); a
    retiring slot's rows land at its generation plane via a dense `where`
    instead of the per-slot packed scatter (scatter cost is per row and
    grows with row width).  reshape(G*S*N, D+1, 4) is ray order."""
    from .replay import _prim_encode
    G = globG.shape[0]
    D = r_prim.shape[2]
    n = st.phase.shape[1]
    S = st.n_slots
    colD = jnp.arange(D, dtype=jnp.uint32)
    gi = jnp.arange(G, dtype=jnp.uint32)[:, None]
    for p in range(S):
        ret = st.phase[p] == PH_RETIRE
        words = occm[p, (colD // 32).astype(jnp.int32)]  # (D, N)
        occf = ((words >> (colD % 32)[:, None]) & 1).astype(jnp.float32).T
        Lp = st.L[p]
        L_row = jnp.concatenate(
            [jnp.where(jnp.isfinite(Lp), Lp, 0.0),
             jnp.zeros((Lp.shape[0], 1), Lp.dtype)], axis=-1,
        )
        packed = jnp.concatenate(
            [
                jnp.stack(
                    [_prim_encode(r_prim[p]), r_u[p], r_v[p], occf],
                    axis=-1,
                ),
                L_row[:, None, :],
            ],
            axis=1,
        )  # (N, D+1, 4)
        g = (st.idx[p] - jnp.uint32(idx0)) // jnp.uint32(S * n)
        cond = (gi == g[None, :]) & ret[None, :]        # (G, N)
        globG = globG.at[:, p].set(jnp.where(
            cond[:, :, None, None], packed[None], globG[:, p]))
        st = dataclasses.replace(
            st, phase=st.phase.at[p].set(
                jnp.where(ret, PH_DEAD, st.phase[p])),
        )
        r3 = ret[:, None]
        r_prim = r_prim.at[p].set(jnp.where(r3, -1, r_prim[p]))
        r_u = r_u.at[p].set(jnp.where(r3, 0.0, r_u[p]))
        r_v = r_v.at[p].set(jnp.where(r3, 0.0, r_v[p]))
        occm = occm.at[p].set(
            jnp.where(ret[None, :], jnp.uint32(0), occm[p]))
    return st, occm, r_prim, r_u, r_v, globG


@partial(
    jax.jit,
    static_argnames=("n_nodes", "spp", "max_depth", "rr_depth", "steps",
                     "n_rounds", "idle_spread", "arm_every", "dense"),
    donate_argnums=(1, 2, 3, 4, 5, 6, 7),
)
def _run_record_pipelined(scene: Scene, st: PipelinedState, occm, r_prim,
                          r_u, r_v, glob, next_ray, seed, ray_end,
                          unified, idx0=0, *, n_nodes: int, spp: int,
                          max_depth: int, rr_depth: int, steps: int,
                          n_rounds: int, idle_spread: bool = True,
                          arm_every: int = 1, dense: bool = False):
    """Recorder rounds on the two-path machine: the refill+flush design of
    replay._run_record_full with the pipelined scheduler underneath.
    `glob` is (rows+1, D+1, 4): record rows plus the radiance row D (see
    _flush_record_pipelined) — or, with dense=True (round-5 strided
    ownership), the (G, S, N, D+1, 4) generation buffer of
    _flush_record_dense."""
    layout = scene.bvh.layout

    def one_round(carry, _):
        st, occm, r_prim, r_u, r_v, glob, next_ray = carry
        st, occm = _finish_round(st, occm=occm)
        if dense:
            st, occm, r_prim, r_u, r_v, glob = _flush_record_dense(
                st, occm, r_prim, r_u, r_v, glob, idx0,
            )
        else:
            st, occm, r_prim, r_u, r_v, glob = _flush_record_pipelined(
                st, occm, r_prim, r_u, r_v, glob, idx0,
            )
        st, (r_prim, r_u, r_v) = _transition_pipelined(
            scene, st, seed, max_depth=max_depth, rr_depth=rr_depth,
            rec=(r_prim, r_u, r_v),
        )
        st, next_ray = _refill_pipelined(
            scene, st, next_ray, seed, spp=spp, ray_end=ray_end,
            strided=dense,
        )
        st, occm = _stepper(unified, n_nodes, st, steps, layout=layout,
                            idle_spread=idle_spread, occm=occm,
                            arm_every=arm_every)
        return (st, occm, r_prim, r_u, r_v, glob, next_ray), None

    (st, occm, r_prim, r_u, r_v, glob, next_ray), _ = jax.lax.scan(
        one_round, (st, occm, r_prim, r_u, r_v, glob, next_ray),
        None, length=n_rounds,
    )
    return st, occm, r_prim, r_u, r_v, glob, next_ray


def record_full_pipelined(scene: Scene, seed, n_rays: int, *, spp: int,
                          max_depth: int, rr_depth: int, steps: int = 16,
                          rounds_per_launch: int = 8, n_lanes: int = 32768,
                          pad_to: int | None = None,
                          return_film: bool = False,
                          rfilter: str = "box", n_slots: int = 2,
                          arm_every: int = 1, flush: str = "auto"):
    """record_full on the two-path pipelined machine — same PathRecord
    (bit-equal: same rays, same RNG dims, same flush layout), recorded with
    the idle-filling scheduler.  Drop-in for replay.record_full.

    `n_slots`: in-flight paths per lane (see render_pipelined).

    return_film=True additionally returns the forward film (weight channel
    included, splat with `rfilter`): the recorder runs the full forward
    shading machine, so each retired slot's radiance is flushed alongside
    its record rows and one deferred splat reconstructs the frame — the
    film replay_grads_sorted's forward pass would otherwise recompute from
    the record (same rays, same RNG dims -> identical), for free."""
    from .replay import PathRecord, _prim_decode, _prim_encode

    n_lanes = min(n_lanes, max(n_rays // n_slots, 1))
    rows = max(pad_to or n_rays, n_rays)
    lay = scene.bvh.layout or DEFAULT_LAYOUT
    st = PipelinedState.empty(n_lanes, stack_depth=lay.stack,
                              n_slots=n_slots)
    W = (max_depth + 31) // 32
    occm = jnp.zeros((n_slots, W, n_lanes), jnp.uint32)
    r_prim = jnp.full((n_slots, n_lanes, max_depth), -1, jnp.int32)
    r_u = jnp.zeros((n_slots, n_lanes, max_depth), jnp.float32)
    r_v = jnp.zeros((n_slots, n_lanes, max_depth), jnp.float32)
    miss_row = jnp.concatenate([
        _prim_encode(jnp.full((1,), -1, jnp.int32)),
        jnp.zeros((3,), jnp.float32),
    ])
    G = (n_rays + n_slots * n_lanes - 1) // (n_slots * n_lanes)
    # flush="auto" keeps the scatter: the strided ownership's forfeited
    # load balancing cost more than the flush scatter saved at d8 on the
    # accelerator this was first tuned on, and at d65 the dense write
    # would stream ~4 GB/round (computed).  Hypothesis on the GPU (ROADMAP
    # queue 1, item 4).  "dense" stays as an explicit, bit-equal option.
    dense = flush == "dense"
    if dense:
        glob = jnp.tile(miss_row, (G, n_slots, n_lanes,
                                   max_depth + 1, 1))
        iota = jnp.arange(n_lanes, dtype=jnp.uint32)
        st = dataclasses.replace(st, idx=jnp.stack(
            [iota + jnp.uint32(p * n_lanes)
             - jnp.uint32(n_slots * n_lanes) for p in range(n_slots)]))
    else:
        # glob rows: [0:D] record layout, row D = radiance (L.rgb, 0)
        glob = jnp.tile(miss_row, (rows + 1, max_depth + 1, 1))
    next_ray = jnp.zeros((), jnp.uint32)
    seed_u = jnp.uint32(seed)
    unified, n_nodes = unify_tables(scene.bvh)
    while True:
        st, occm, r_prim, r_u, r_v, glob, next_ray = _run_record_pipelined(
            scene, st, occm, r_prim, r_u, r_v, glob, next_ray,
            seed_u, jnp.uint32(n_rays), unified, n_nodes=n_nodes, spp=spp,
            max_depth=max_depth, rr_depth=rr_depth, steps=steps,
            n_rounds=rounds_per_launch, arm_every=arm_every, dense=dense,
        )
        n_alive, cursor = jax.device_get(_poll2(st, next_ray))
        if int(cursor) >= n_rays and int(n_alive) == 0:
            break
    if dense:
        glob = glob.reshape(G * n_slots * n_lanes, max_depth + 1, 4)
        if rows > glob.shape[0]:
            glob = jnp.concatenate([
                glob,
                jnp.tile(miss_row,
                         (rows - glob.shape[0], max_depth + 1, 1)),
            ])
    rayL = glob[:n_rays, max_depth, 0:3]
    glob = glob[:rows, :max_depth]
    rec = PathRecord(
        prim=_prim_decode(glob[:, :, 0]),
        u=glob[:, :, 1],
        v=glob[:, :, 2],
        occl=glob[:, :, 3] != 0.0,
    )
    if not return_film:
        return rec
    w, h = scene.camera.resolution
    film = splat_deferred(
        scene.camera, seed_u, rayL, jnp.uint32(0),
        jnp.uint32(n_rays), spp=spp, rfilter=rfilter, w=w, h=h,
    )
    return rec, film
