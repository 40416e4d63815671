"""Vectorized 8-wide BVH traversal: scene.ray_intersect / ray_test.

Replaces the OptiX RTX / Embree backends (SURVEY.md section 2.2; usage
/root/reference/path.py:238,281, restirgi.py:320,346).  Rays traverse in
lockstep inside one `lax.while_loop` over the packed-row wide BVH
(scene/bvh8.py).  Per iteration:

  internal step: ONE (N,)-row gather of the 64-float node row, then pure
                 elementwise slab tests of all 8 child boxes; nearest hit child is
                 descended, the other hits are pushed with ONE flat scatter.
  leaf step:     ONE row gather of 8 packed triangles (+1 for face ids),
                 8 unrolled elementwise Moller-Trumbore tests.

The shape assumes a step's cost is its count of dependent row gathers (as
measured on the accelerator this system was first built for; a hypothesis
on the GPU, ROADMAP queue 1, item 3) — so each step does the minimum count
of simple row gathers and nothing else touches memory.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import math as m
from ..core.records import Ray, SurfaceInteraction
from ..scene.bvh8 import DEFAULT_LAYOUT
from ..scene.types import Scene
DONE = jnp.int32(-1)  # shared with "empty child" code


def _tri_test9(o, d, g9, t_best):
    """Moller-Trumbore against a packed (N, 9) [v0|v1|v2] row."""
    v0 = g9[:, 0:3]
    e1 = g9[:, 3:6] - v0
    e2 = g9[:, 6:9] - v0
    pvec = m.cross(d, e2)
    det = m.dot(e1, pvec)
    inv_det = m.safe_div(jnp.ones((), det.dtype), det)
    tvec = o - v0
    u = m.dot(tvec, pvec) * inv_det
    qvec = m.cross(tvec, e1)
    v = m.dot(d, qvec) * inv_det
    t = m.dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) > 1e-10)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > 0.0) & (t < t_best)
    )
    return t, u, v, hit


@partial(jax.jit, static_argnames=("n_nodes", "any_hit", "layout"))
def _traverse(unified, n_nodes: int, o, d, maxt, active,
              any_hit: bool = False, layout=None):
    """Returns (t, face, u, v) with face == -1 for misses.

    ONE unified-table row gather per iteration (BVH.unified: row < n_nodes
    internal, else leaf): the fetched row is decoded under both views, each
    masked by the lane's node kind — same scheme as the persistent stepper
    (integrators/persistent.py), which this lockstep loop predates.

    `layout` (static, scene/bvh8.BVHLayout) gives the packed-row offsets and
    stack capacity; None = DEFAULT_LAYOUT (round-4 config consolidation: the
    layout rides the built BVH, so non-default layouts are in-process
    testable)."""
    lay = layout if layout is not None else DEFAULT_LAYOUT
    WIDTH, LEAF_CAP, STACK_DEPTH = lay.width, lay.leaf_cap, lay.stack
    NODE_BASE, FACE_OFF, LEAF_ROW = lay.node_base, lay.face_off, lay.leaf_row
    n = o.shape[0]
    inv_d = m.safe_div(jnp.ones((), m.Float), d, fill=jnp.inf)

    t_best = jnp.where(active, maxt, 0.0)
    face_best = jnp.full((n,), -1, jnp.int32)
    u_best = jnp.zeros((n,), m.Float)
    v_best = jnp.zeros((n,), m.Float)

    # code: >=0 internal row; -1 DONE; <=-2 leaf row (-code-2)
    # shift-register stack, top = column 0: pop is a static slice and push
    # is an elementwise 9-way select — streaming bandwidth instead of a
    # scatter + pop-gather pair
    cur = jnp.where(active, jnp.zeros((n,), jnp.int32), DONE)
    stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp = jnp.zeros((n,), jnp.int32)

    def cond(state):
        cur, *_ = state
        return jnp.any(cur != DONE)

    def body(state):
        cur, sp, stack, t_best, face_best, u_best, v_best = state
        live = cur != DONE
        is_int = cur >= 0
        is_leaf = cur <= -2

        # ----------- one unified row gather; internal view: slabs ----------
        row_idx = jnp.where(
            is_int, cur, n_nodes + jnp.where(is_leaf, -cur - 2, 0)
        )
        row = jnp.take(unified, row_idx, axis=0)          # (N, 88)
        codes = jax.lax.bitcast_convert_type(row[:, 0:WIDTH], jnp.int32)
        bb = row[:, NODE_BASE : NODE_BASE + 6 * WIDTH].reshape(n, WIDTH, 6)
        t0 = (bb[:, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
        t1 = (bb[:, :, 3:6] - o[:, None, :]) * inv_d[:, None, :]
        tmin = jnp.minimum(t0, t1)
        tmax = jnp.maximum(t0, t1)
        t_near = jnp.max(tmin, axis=-1)                 # (N, 8)
        t_far = jnp.min(tmax, axis=-1)
        hit = (
            (t_near <= t_far * 1.00000024) & (t_far > 0.0)
            & (t_near < t_best[:, None]) & (codes != DONE)
            & is_int[:, None]
        )

        t_sort = jnp.where(hit, t_near, jnp.inf)
        k_near = jnp.argmin(t_sort, axis=-1)            # (N,)
        any_child = jnp.any(hit, axis=-1)
        onehot_near = (
            jnp.arange(WIDTH, dtype=jnp.int32)[None, :] == k_near[:, None]
        )
        near_code = jnp.sum(jnp.where(onehot_near, codes, 0), axis=-1)

        # push the remaining hit children far-to-near (top of stack = nearest
        # remaining -> t_best culling prunes the most on later pops); the
        # ordering is a rank computed from an 8x8 pairwise compare
        push_mask = hit & ~onehot_near                  # (N, 8)
        n_push = jnp.sum(push_mask, axis=-1).astype(jnp.int32)
        if any_hit:
            # occlusion query: any hit ends the lane, so push order is
            # irrelevant — slot-order prefix count, no 8x8 rank matrix
            pm = push_mask.astype(jnp.int32)
            rank_far = jnp.cumsum(pm, axis=-1) - pm
        else:
            tp = jnp.where(push_mask, t_near, -jnp.inf)  # pushed entries only
            ki = jnp.arange(WIDTH, dtype=jnp.int32)
            farther = (
                (tp[:, None, :] > tp[:, :, None])
                | ((tp[:, None, :] == tp[:, :, None])
                   & (ki[None, None, :] > ki[None, :, None]))
            ) & push_mask[:, None, :]
            # pos_k = sp + #{pushed j farther than k}: farthest lands at the
            # bottom, nearest at the top (popped first)
            rank_far = jnp.sum(farther, axis=-1).astype(jnp.int32)

        # --------------- leaf view of the same gathered row ----------------
        trow = row
        frow = jax.lax.bitcast_convert_type(
            trow[:, FACE_OFF:LEAF_ROW], jnp.int32
        )
        for k in range(LEAF_CAP):
            t, u, v, h = _tri_test9(o, d, trow[:, 9 * k : 9 * k + 9], t_best)
            ok = is_leaf & h & (frow[:, k] >= 0)
            t_best = jnp.where(ok, t, t_best)
            face_best = jnp.where(ok, frow[:, k], face_best)
            u_best = jnp.where(ok, u, u_best)
            v_best = jnp.where(ok, v, v_best)

        if any_hit:
            early_done = is_leaf & (face_best >= 0)
        else:
            early_done = jnp.zeros_like(is_leaf)

        # ------------------------- pop / descend --------------------------
        # capacity: collapse_to_wide guarantees depth*(WIDTH-1) <=
        # STACK_DEPTH; if it ever overflowed, the shift drops the DEEPEST
        # (farthest) entries rather than the new pushes
        descend = is_int & any_child
        want_pop = live & ~early_done & ~descend
        can_pop = want_pop & (sp > 0)
        popped = jnp.where(sp > 0, stack[:, 0], DONE)
        nxt = jnp.where(
            descend, near_code, jnp.where(want_pop, popped, DONE)
        )
        nxt = jnp.where(live & ~early_done, nxt, DONE)
        sp_new = jnp.where(
            descend, jnp.minimum(sp + n_push, STACK_DEPTH),
            jnp.where(can_pop, sp - 1, sp),
        )
        sp_new = jnp.where(nxt == DONE, 0, sp_new)

        # shift-register update: right by n_push on descend, left on pop
        shift = jnp.where(descend, n_push, 0) - can_pop.astype(jnp.int32)
        res = stack
        res = jnp.where(
            (shift == -1)[:, None],
            jnp.concatenate(
                [stack[:, 1:], jnp.full((n, 1), DONE, jnp.int32)], axis=1
            ),
            res,
        )
        for s in range(1, WIDTH):
            shifted = jnp.concatenate(
                [jnp.zeros((n, s), jnp.int32), stack[:, : STACK_DEPTH - s]],
                axis=1,
            )
            res = jnp.where((shift == s)[:, None], shifted, res)
        # insert pushed codes at columns 0..n_push-1, nearest at column 0
        head = res[:, :WIDTH]
        col8 = jnp.arange(WIDTH, dtype=jnp.int32)[None, :]
        for k in range(WIDTH):
            colk = (n_push - 1 - rank_far[:, k])[:, None]
            mk = (push_mask[:, k] & descend)[:, None]
            head = jnp.where((col8 == colk) & mk, codes[:, k : k + 1], head)
        stack = jnp.concatenate([head, res[:, WIDTH:]], axis=1)

        return (nxt, sp_new, stack, t_best, face_best, u_best, v_best)

    state = (cur, sp, stack, t_best, face_best, u_best, v_best)
    cur, sp, stack, t_best, face_best, u_best, v_best = jax.lax.while_loop(
        cond, body, state
    )
    t_out = jnp.where(face_best >= 0, t_best, jnp.inf)
    return t_out, face_best, u_best, v_best


# Scenes at or below this many leaf rows skip the BVH: a dense all-triangles
# test is pure elementwise work with zero gathers — fastest for tiny scenes.
BRUTE_FORCE_MAX_SLOTS = 64


def _layout(scene):
    return scene.bvh.layout or DEFAULT_LAYOUT


def _n_tri_slots(scene):
    return scene.bvh.leaf_tris.shape[0] * _layout(scene).leaf_cap


def ray_intersect(scene: Scene, ray: Ray, active=None) -> SurfaceInteraction:
    """Closest-hit query returning a full SurfaceInteraction."""
    n = ray.o.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    if _n_tri_slots(scene) <= BRUTE_FORCE_MAX_SLOTS:
        return ray_intersect_brute(scene, ray, active)
    b = scene.bvh
    t, face, u, v = _traverse(
        b.unified, b.nodes.shape[0],
        ray.o, ray.d, ray.maxt, active, False, layout=b.layout,
    )
    return _make_si(scene, ray, t, face, u, v)


def ray_test(scene: Scene, ray: Ray, active=None):
    """Any-hit (shadow) query: True where the segment (0, maxt) is occluded."""
    n = ray.o.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    if _n_tri_slots(scene) <= BRUTE_FORCE_MAX_SLOTS:
        si = ray_intersect_brute(scene, ray, active)
        return si.prim_idx >= 0
    b = scene.bvh
    t, face, _, _ = _traverse(
        b.unified, b.nodes.shape[0],
        ray.o, ray.d, ray.maxt, active, True, layout=b.layout,
    )
    return face >= 0


def ray_intersect_brute(scene: Scene, ray: Ray, active=None) -> SurfaceInteraction:
    """Oracle path: test every packed triangle slot (validates the BVH)."""
    n = ray.o.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    b = scene.bvh
    cap = _layout(scene).leaf_cap
    L = b.leaf_tris.shape[0]
    tris = b.leaf_tris[:, : 9 * cap].reshape(L * cap, 3, 3)
    faces_flat = b.leaf_face.reshape(-1)  # kept alongside the fused rows
    maxt = jnp.where(active, ray.maxt, 0.0)

    from .triangle import intersect_tri

    t, u, v, hit = intersect_tri(ray.o, ray.d, tris[None, :, :, :], maxt)
    t = jnp.where((faces_flat >= 0)[None, :], t, jnp.inf)
    k = jnp.argmin(t, axis=-1)
    tb = jnp.take_along_axis(t, k[:, None], -1)[:, 0]
    face = jnp.where(
        jnp.isfinite(tb), jnp.take(faces_flat, k), -1
    )
    ub = jnp.take_along_axis(u, k[:, None], -1)[:, 0]
    vb = jnp.take_along_axis(v, k[:, None], -1)[:, 0]
    return _make_si(
        scene, ray, jnp.where(face >= 0, tb, jnp.inf), face, ub, vb
    )


def _make_si(scene: Scene, ray: Ray, t, face, u, v, return_row=False):
    """Assemble the SurfaceInteraction from a hit (global face id).

    ONE row gather from Geometry.face_packed (layout documented there)
    instead of 13 from an indexed soup.  e1/e2 are precomputed at build
    with the identical subtraction, so results are bit-equal to the
    13-gather form.

    `return_row=True` additionally returns the fetched (N, 32) row so hot
    paths can read the folded NEE-pdf columns (27: pmf, 28: area) without
    a second large-table gather (emitter.pdf_emitter_direction_packed)."""
    g = scene.geometry
    valid = face >= 0
    # invalid lanes: SPREAD their (discarded) gather rows across the table
    # instead of all hitting row 0 — duplicate gather indices can serialize
    # the whole op.  Safe for AD:
    # every consumer of the fetched row is where-gated on `valid`, so the
    # spread rows' cotangents are exactly zero (and face_packed is geometry,
    # not a differentiated table).
    n_faces = g.face_packed.shape[0]
    iota = jnp.arange(face.shape[0], dtype=face.dtype) % n_faces
    face_s = jnp.where(valid, face, iota)

    row = jnp.take(g.face_packed, face_s, axis=0)       # (N, 32)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    p = v0 + e1 * u[:, None] + v[:, None] * e2
    ng = m.normalize(m.cross(e1, e2))

    flat = row[:, 24] > 0.5
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    ns = m.normalize(
        n0 * (1.0 - u - v)[:, None] + n1 * u[:, None] + n2 * v[:, None]
    )
    ns = jnp.where(flat[:, None], ng, ns)
    # keep shading normal in the same hemisphere as the geometric one
    ns = jnp.where(m.dot(ns, ng)[:, None] < 0.0, -ns, ns)

    uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    uv = uv0 * (1.0 - u - v)[:, None] + uv1 * u[:, None] + uv2 * v[:, None]

    sh_s, sh_t = m.coordinate_system(ns)
    wi = m.to_local(sh_s, sh_t, ns, -ray.d)

    mat_id = jax.lax.bitcast_convert_type(row[:, 25], jnp.int32)
    emitter_id = jax.lax.bitcast_convert_type(row[:, 26], jnp.int32)

    inval = ~valid
    si = SurfaceInteraction(
        t=jnp.where(valid, t, jnp.inf),
        p=jnp.where(inval[:, None], 0.0, p),
        n=jnp.where(inval[:, None], jnp.array([0.0, 0.0, 1.0]), ng),
        sh_n=jnp.where(inval[:, None], jnp.array([0.0, 0.0, 1.0]), ns),
        sh_s=jnp.where(inval[:, None], jnp.array([1.0, 0.0, 0.0]), sh_s),
        sh_t=jnp.where(inval[:, None], jnp.array([0.0, 1.0, 0.0]), sh_t),
        uv=jnp.where(inval[:, None], 0.0, uv),
        wi=jnp.where(inval[:, None], jnp.array([0.0, 0.0, 1.0]), wi),
        prim_idx=jnp.where(valid, face, -1),
        mat_id=jnp.where(valid, mat_id, -1),
        emitter_id=jnp.where(valid, emitter_id, -1),
    )
    if return_row:
        return si, row
    return si
