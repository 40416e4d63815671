"""Multi-device parallelism: ray/tile data parallelism over a device mesh.

The reference has zero distributed code (SURVEY.md section 2.3) — its only
parallel axis is the SIMT wavefront.  Here that axis shards across devices:

  * mesh ("dp",) over all devices (NVLink within a host, the network across
    hosts via jax.distributed.initialize — same code path).
  * scene/BVH/NN parameters replicated per device.
  * the wavefront (ray lanes) sharded over "dp"; each device traces its lanes
    and splats into a *local* film copy; films merge with one psum at the end
    (film is small vs ray state).
  * gradients of scene/NN parameters all-reduce with psum inside the
    backward shard_map — the NCCL-all-reduce analog of BASELINE.md.
"""
from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import math as m
from ..core.rng import Sampler
from ..render import film as filmlib
from ..render import sensor as sensorlib
from ..scene.params import update as scene_update


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), ("dp",))


def _make_sharded(mesh: Mesh, spec, make):
    """`make()`'s arrays built directly in their shards, so no device
    holds the whole of them.  `spec` is a PartitionSpec, or a pytree of
    them matching make()'s output."""
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                             is_leaf=lambda x: isinstance(x, P))
    return jax.jit(make, out_shardings=shardings)()


def _replicate(tree, mesh: Mesh):
    """`tree` placed once on every device of `mesh`: the launch loops
    below then pass committed replicas instead of re-copying a
    single-device scene to the mesh at every launch."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def _trace_lanes(scene, integrator, seed, pass_idx, lane, spp_per_pass,
                 rfilter, film_shape):
    """Trace a block of lanes and return the (partial) film they splat."""
    w, h = scene.camera.resolution
    pix = lane // spp_per_pass
    px = (pix % w).astype(m.Float)
    py = (pix // w).astype(m.Float)
    n_total = w * h * spp_per_pass
    sampler = Sampler.create(
        seed, lane=lane + jnp.uint32(n_total) * pass_idx
    )
    sampler, jitter = sampler.next_2d()
    pos = jnp.stack([px, py], axis=-1) + jitter
    ray = sensorlib.sample_ray(scene.camera, pos)
    L, _, _ = integrator.sample(scene, sampler, ray)
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    film = jnp.zeros(film_shape, m.Float)
    return filmlib.put(film, pos, L, rfilter=rfilter)


@partial(
    jax.jit,
    static_argnames=("integrator", "spp_per_pass", "rfilter", "mesh",
                     "n_launch"),
)
def _render_pass_sharded(scene, integrator, seed, pass_idx,
                         spp_per_pass: int, rfilter: str, mesh: Mesh,
                         lane_offset=0, n_launch: int | None = None):
    w, h = scene.camera.resolution
    n = w * h * spp_per_pass
    ndev = mesh.shape["dp"]
    n_pad = n_launch if n_launch is not None else (
        ((n + ndev - 1) // ndev) * ndev
    )
    lanes = jnp.uint32(lane_offset) + jnp.arange(n_pad, dtype=jnp.uint32)
    # lanes beyond n wrap; they re-trace lane 0 but splat weight is divided
    # out by develop, so padding only costs compute, not bias
    lanes = jnp.where(lanes < n, lanes, jnp.uint32(0))

    def per_device(scene, lanes):
        film = _trace_lanes(
            scene, integrator, seed, pass_idx, lanes, spp_per_pass,
            rfilter, (h, w, 4),
        )
        return jax.lax.psum(film, "dp")

    shard_fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P("dp")),
        out_specs=P(),
        # the bounce loop mixes replicated (scene) and varying (lane) state;
        # VMA inference can't type the while carry, so it is disabled here
        # (retried on jax 0.9, round 5: still TypeErrors at trace time —
        # the equality tests vs the single-device renderer are the guard)
        check_vma=False,
    )
    return shard_fn(scene, lanes)


def render_sharded(scene, integrator, mesh: Mesh, seed: int = 0,
                   spp: int = 16, rfilter: str = "box",
                   spp_per_pass: int | None = None,
                   chunk: int | None = None):
    """Multi-device render: wavefront sharded over mesh axis "dp".

    `chunk` bounds the per-DEVICE lanes per launch: each shard_map launch
    traces chunk*ndev lanes and the host loops over lane offsets: the
    multi-device composition of the single-device chunked render.
    """
    w, h = scene.camera.resolution
    if spp_per_pass is None:
        spp_per_pass = max(1, min(spp, (1 << 21) // max(w * h, 1)))
    while spp % spp_per_pass:
        spp_per_pass -= 1
    ndev = mesh.shape["dp"]
    n = w * h * spp_per_pass
    film = filmlib.new_film(w, h)
    for p in range(spp // spp_per_pass):
        if chunk is None:
            film = film + _render_pass_sharded(
                scene, integrator, jnp.uint32(seed), jnp.uint32(p),
                spp_per_pass, rfilter, mesh,
            )
        else:
            n_launch = chunk * ndev
            for off in range(0, n, n_launch):
                film = film + _render_pass_sharded(
                    scene, integrator, jnp.uint32(seed), jnp.uint32(p),
                    spp_per_pass, rfilter, mesh,
                    lane_offset=jnp.uint32(off), n_launch=n_launch,
                )
    return filmlib.develop(film)


def render_persistent_sharded(scene, mesh: Mesh, seed: int = 0,
                              spp: int = 16, max_depth: int = 16,
                              rr_depth: int = 4, rfilter: str = "box",
                              n_lanes: int = 32768, steps: int = 16,
                              rounds_per_launch: int = 8,
                              scheduler: str = "persistent",
                              arm_every: int = 1):
    """Multi-device persistent-wavefront render: each device runs its own
    incremental-traversal state machine over an owned contiguous slice of
    the global ray stream; each device splats its deferred per-ray
    radiance slice once at the end, films psum at develop.  RNG is keyed
    by global ray index, so the result equals the single-device renderer
    up to splat-order float noise.

    scheduler="persistent" runs the single-path machine
    (integrators/persistent.py); "pipelined" the two-path idle-filling
    machine (integrators/pipelined.py) — identical images either way."""
    from ..integrators.persistent import (
        PersistentState,
        _run_persistent,
        splat_deferred,
        unify_tables,
    )

    if scheduler == "pipelined":
        from ..integrators.pipelined import (
            PipelinedState as _State,
            _run_pipelined as _runner,
        )

        def _alive(st):
            from ..integrators.pipelined import PH_DEAD
            return int(jnp.sum((st.phase != PH_DEAD).astype(jnp.int32)))
    else:
        _State, _runner = PersistentState, _run_persistent

        def _alive(st):
            return int(jnp.sum(st.alive.astype(jnp.int32)))

    scene = _replicate(scene, mesh)
    w, h = scene.camera.resolution
    n_total = w * h * spp
    ndev = mesh.shape["dp"]
    per = (n_total + ndev - 1) // ndev
    n_lanes = min(n_lanes, per)

    # pipelined slot fields are slot-major (S, N, ...): shard axis 1
    stspec = (_State.pspec("dp") if scheduler == "pipelined"
              else P("dp"))
    st = _make_sharded(mesh, stspec, lambda: _State.empty(
        n_lanes * ndev,
        stack_depth=None if scene.bvh.layout is None
        else scene.bvh.layout.stack))
    rayLs = _make_sharded(mesh, P("dp"),
                          lambda: jnp.zeros((ndev, per + 1, 3), m.Float))
    offsets = jnp.arange(ndev, dtype=jnp.uint32) * jnp.uint32(per)
    cursors = jnp.copy(offsets)  # donated below: must not alias offsets
    ray_end = jnp.minimum(
        (jnp.arange(ndev, dtype=jnp.uint32) + 1) * jnp.uint32(per),
        jnp.uint32(n_total),
    )

    unified, n_nodes = unify_tables(scene.bvh)

    sched_kw = {"arm_every": arm_every} if scheduler == "pipelined" else {}

    def per_device(scene, st, rayL, next_ray, rend, off, seed, unified):
        st, rl, nr = _runner(
            scene, st, rayL[0], next_ray[0], seed, rend[0], unified,
            off[0], n_nodes=n_nodes, spp=spp, max_depth=max_depth,
            rr_depth=rr_depth, steps=steps, n_rounds=rounds_per_launch,
            **sched_kw,
        )
        return st, rl[None], nr[None]

    shard_fn = jax.jit(
        jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(), stspec, P("dp"), P("dp"), P("dp"), P("dp"),
                      P(), P()),
            out_specs=(stspec, P("dp"), P("dp")),
            check_vma=False,
        ),
        donate_argnums=(1, 2, 3),
    )

    seed_u = jnp.uint32(seed)
    while True:
        st, rayLs, cursors = shard_fn(
            scene, st, rayLs, cursors, ray_end, offsets, seed_u, unified
        )
        n_alive = _alive(st)
        done = bool(jnp.all(cursors >= ray_end))
        if done and n_alive == 0:
            break
    # develop-time (once per frame): stitch the owned slices back into the
    # global per-ray buffer and splat.  Positions re-derive from the RNG,
    # so this equals the single-device splat exactly.
    rayL = rayLs[:, :per].reshape(ndev * per, 3)[:n_total]
    film = splat_deferred(
        scene.camera, seed_u, rayL, jnp.uint32(0), jnp.uint32(n_total),
        spp=spp, rfilter=rfilter, w=w, h=h,
    )
    return filmlib.develop(film)


@partial(jax.jit, static_argnames=("integrator", "spp_per_pass", "mesh"))
def sharded_grad_step(scene, params, target, seed, mesh: Mesh,
                      integrator, spp_per_pass: int = 1):
    """One data-parallel differentiable-render training step.

    Per device: trace a lane shard with AD enabled, build the partial film,
    psum films to get the full estimate, MSE against `target`, backprop;
    parameter grads are identical across devices by construction (the psum
    is inside the loss), giving the all-reduced gradient of BASELINE.md.
    Returns (loss, grads) — both replicated.
    """
    w, h = scene.camera.resolution
    n = w * h * spp_per_pass
    ndev = mesh.shape["dp"]
    n_pad = ((n + ndev - 1) // ndev) * ndev
    lanes = jnp.arange(n_pad, dtype=jnp.uint32)
    lanes = jnp.where(lanes < n, lanes, jnp.uint32(0))

    def per_device(scene, target, lanes, params):
        def loss_fn(params):
            s = scene_update(scene, params)
            film = _trace_lanes(
                s, integrator, seed, jnp.uint32(0), lanes, spp_per_pass,
                "box", (h, w, 4),
            )
            film = jax.lax.psum(film, "dp")
            img = filmlib.develop(film)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        # psum's TRANSPOSE is itself an all-reduce, so each device's film
        # cotangent arrives ndev-fold inflated and its grad is ndev x (its
        # own lanes' partial).  psum/ndev = the exact full gradient (this
        # is the actual NCCL-all-reduce analog; round 1's "identical by
        # construction" was wrong — caught by the replay equality test).
        ndev = jax.lax.psum(1, "dp")
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, "dp") / ndev, grads
        )
        return loss, grads

    shard_fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P("dp"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return shard_fn(scene, target, lanes, params)


def sharded_replay_grad(scene, params, target, seed, mesh: Mesh, *,
                        idx0: int = 0, n_lanes: int = 32768, spp: int,
                        max_depth: int, rr_depth: int = 4,
                        rfilter: str = "box", steps: int = 16,
                        rounds_per_launch: int = 8, ray_end=None,
                        chunk: int | None = None,
                        scheduler: str = "persistent",
                        arm_every: int = 1):
    """Multi-device fwd+bwd on the production path: each
    device owns a contiguous slice of the ray stream and RECORDS it with
    the refill+flush persistent recorder (integrators/replay.py::
    _run_record_full — lanes < rays, a retiring lane flushes its packed
    rows and immediately refills, exactly the single-device record_full that
    replaced the straggler-bound per-chunk recorder), then differentiates
    the traversal-free REPLAY:

      1. forward replay per device (chunked lax.scan) -> partial film;
         ONE psum -> the full frame, from which the film ADJOINT
         dLoss/dS is computed (replicated) — same decomposition as
         replay_grads_sorted, exact for any ray->device/chunk partition.
      2. adjoint replay per device: grad of <adj, S_dev> accumulated over
         its chunks; a plain psum (adjoint contributions are linear —
         no transpose inflation to undo) = the full-frame gradient.

    Returns (loss, grads), both replicated.  `ray_end` bounds the global
    ray range [idx0, ray_end); default records n_lanes*ndev rays (one
    lane per ray, back-compat with the round-2 signature).  `chunk` is
    the per-device replay chunk (default: the whole device slice).
    scheduler="pipelined" records with the two-path machine
    (integrators/pipelined.py — the round-4 production recorder);
    PathRecords are bit-equal either way."""
    from ..integrators import pipelined as pl
    from ..integrators import replay as rp
    from ..integrators.persistent import PersistentState, unify_tables

    scene, params, target = _replicate((scene, params, target), mesh)
    w, h = scene.camera.resolution
    ndev = mesh.shape["dp"]
    if ray_end is None:
        ray_end = idx0 + n_lanes * ndev
    n = ray_end - idx0
    per = (n + ndev - 1) // ndev          # rays per device
    lanes = min(n_lanes, per)             # lanes per device
    if chunk is None or chunk > per:
        chunk = per
    rows = ((per + chunk - 1) // chunk) * chunk   # padded device rows
    D = max_depth
    seed_u = jnp.uint32(seed)
    unified, n_nodes = unify_tables(scene.bvh)

    starts = jnp.uint32(idx0) + jnp.arange(ndev, dtype=jnp.uint32) \
        * jnp.uint32(per)
    ends = jnp.minimum(starts + jnp.uint32(per), jnp.uint32(ray_end))

    # ------------------- record (refill + packed flush) -------------------
    sd = None if scene.bvh.layout is None else scene.bvh.layout.stack
    miss_row = jnp.concatenate([
        rp._prim_encode(jnp.full((1,), -1, jnp.int32)),
        jnp.zeros((3,), jnp.float32),
    ])
    # the pipelined glob carries one extra depth row (the flushed
    # radiance — integrators/pipelined.py::_flush_record_pipelined)
    glob = _make_sharded(mesh, P("dp"), lambda: jnp.tile(miss_row, (
        ndev, rows + 1, D + 1 if scheduler == "pipelined" else D, 1)))
    cursors = jnp.copy(starts)  # donated below: must not alias starts
    rayL = None
    if scheduler == "pipelined":

        def dev_record2(scene, st, occm, r_prim, r_u, r_v, glob, next_ray,
                        start, end, seed, unified):
            st, occm, r_prim, r_u, r_v, g, nr = pl._run_record_pipelined(
                scene, st, occm, r_prim, r_u, r_v, glob[0], next_ray[0],
                seed, end[0], unified, start[0], n_nodes=n_nodes,
                spp=spp, max_depth=max_depth, rr_depth=rr_depth,
                steps=steps, n_rounds=rounds_per_launch,
                arm_every=arm_every,
            )
            return st, occm, r_prim, r_u, r_v, g[None], nr[None]

        # slot-major layouts: state via pspec (slot fields shard axis 1),
        # occm (S, W, N) axis 2, record arrays (S, N, D) axis 1
        sspec = pl.PipelinedState.pspec("dp")
        rec_fn = jax.jit(
            jax.shard_map(
                dev_record2, mesh=mesh,
                in_specs=(P(), sspec, P(None, None, "dp"),
                          P(None, "dp"), P(None, "dp"), P(None, "dp"),
                          P("dp"), P("dp"), P("dp"), P("dp"),
                          P(), P()),
                out_specs=(sspec, P(None, None, "dp"), P(None, "dp"),
                           P(None, "dp"), P(None, "dp"), P("dp"),
                           P("dp")),
                check_vma=False,
            ),
            donate_argnums=(1, 2, 3, 4, 5, 6, 7),
        )
        W = (max_depth + 31) // 32
        st, occm, r_prim, r_u, r_v = _make_sharded(
            mesh, (sspec, P(None, None, "dp"), P(None, "dp"),
                   P(None, "dp"), P(None, "dp")),
            lambda: (pl.PipelinedState.empty(lanes * ndev, stack_depth=sd),
                     jnp.zeros((2, W, lanes * ndev), jnp.uint32),
                     jnp.full((2, lanes * ndev, D), -1, jnp.int32),
                     jnp.zeros((2, lanes * ndev, D), jnp.float32),
                     jnp.zeros((2, lanes * ndev, D), jnp.float32)))
        while True:
            st, occm, r_prim, r_u, r_v, glob, cursors = rec_fn(
                scene, st, occm, r_prim, r_u, r_v, glob, cursors, starts,
                ends, seed_u, unified,
            )
            n_alive = int(jnp.sum(
                (st.phase != pl.PH_DEAD).astype(jnp.int32)))
            if n_alive == 0 and bool(jnp.all(cursors >= ends)):
                break
        rayL = glob[:, :rows, D, 0:3]
        glob = glob[:, :, :D]
    else:
        def dev_record(scene, st, loc, glob, sh_depth, next_ray, start,
                       end, seed, unified):
            st, loc, g, sh_depth, nr = rp._run_record_full(
                scene, st, loc, glob[0], sh_depth, next_ray[0], seed,
                end[0], unified, start[0], n_nodes=n_nodes,
                max_depth=max_depth, rr_depth=rr_depth, steps=steps,
                n_rounds=rounds_per_launch, spp=spp,
            )
            return st, loc, g[None], sh_depth, nr[None]

        rec_fn = jax.jit(
            jax.shard_map(
                dev_record, mesh=mesh,
                in_specs=(P(), P("dp"), P("dp"), P("dp"), P("dp"),
                          P("dp"), P("dp"), P("dp"), P(), P()),
                out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
                check_vma=False,
            ),
            donate_argnums=(1, 2, 3, 4, 5),
        )
        st, loc, sh_depth = _make_sharded(
            mesh, P("dp"),
            lambda: (PersistentState.empty(lanes * ndev, stack_depth=sd),
                     rp.PathRecord.empty(lanes * ndev, D),
                     jnp.ones((lanes * ndev,), jnp.int32)))
        while True:
            st, loc, glob, sh_depth, cursors = rec_fn(
                scene, st, loc, glob, sh_depth, cursors, starts, ends,
                seed_u, unified,
            )
            n_alive = int(jnp.sum(st.alive.astype(jnp.int32)))
            if n_alive == 0 and bool(jnp.all(cursors >= ends)):
                break
    glob = glob[:, :rows]  # drop the dummy flush row
    rec = rp.PathRecord(
        prim=rp._prim_decode(glob[..., 0]),
        u=glob[..., 1], v=glob[..., 2], occl=glob[..., 3] != 0.0,
    )  # (ndev, rows, D) fields, device-sharded on axis 0 below

    n_chunks = rows // chunk
    kwr = dict(spp=spp, max_depth=max_depth, rr_depth=rr_depth)

    # --------------- forward replay -> full film (one psum) ---------------
    def dev_fwd(scene, rec, start, end, seed):
        sl0 = jax.tree_util.tree_map(lambda a: a[0], rec)
        idx = start[0] + jnp.arange(rows, dtype=jnp.uint32)

        def one(film, xs):
            sl, ij = xs
            L, pos, act0 = rp.replay_radiance(
                scene, sl, seed, 0, ray_end=end[0], idx=ij, **kwr,
            )
            return filmlib.put(
                film, pos, jnp.where(jnp.isfinite(L), L, 0.0),
                active=act0, rfilter=rfilter,
            ), None

        rec3 = jax.tree_util.tree_map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), sl0
        )
        film, _ = jax.lax.scan(
            one, filmlib.new_film(w, h), (rec3, idx.reshape(n_chunks, chunk))
        )
        return jax.lax.psum(film, "dp")

    fwd_fn = jax.jit(jax.shard_map(
        dev_fwd, mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P("dp"), P()),
        out_specs=P(), check_vma=False,
    ))

    if rayL is not None:
        # pipelined recorder: the forward film is a free record byproduct
        # (each retired slot flushed its radiance — integrators/
        # pipelined.py::_flush_record_pipelined); one deferred splat per
        # device + psum replaces the whole forward replay pass
        def dev_splat(scene, rayL, start, end, seed):
            from ..integrators.persistent import splat_deferred
            f = splat_deferred(
                scene.camera, seed, rayL[0][:rows], start[0],
                end[0] - start[0], spp=spp, rfilter=rfilter, w=w, h=h,
            )
            return jax.lax.psum(f, "dp")

        splat_fn = jax.jit(jax.shard_map(
            dev_splat, mesh=mesh,
            in_specs=(P(), P("dp"), P("dp"), P("dp"), P()),
            out_specs=P(), check_vma=False,
        ))
        film = splat_fn(scene, rayL, starts, ends, seed_u)
    else:
        film = fwd_fn(scene, rec, starts, ends, seed_u)
    img = filmlib.develop(film)
    wgt = film[..., 3:4]
    msk = wgt > 0.0
    loss = jnp.sum(jnp.where(msk, (img - target) ** 2, 0.0))
    adj = jnp.where(msk, 2.0 * (img - target) / jnp.where(msk, wgt, 1.0),
                    0.0)
    adj = jax.lax.stop_gradient(adj)

    # ----------------- adjoint replay -> all-reduced grads ----------------
    def dev_adj(scene, params, adj, rec, start, end, seed):
        sl0 = jax.tree_util.tree_map(lambda a: a[0], rec)
        idx = start[0] + jnp.arange(rows, dtype=jnp.uint32)
        rec3 = jax.tree_util.tree_map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), sl0
        )

        def one(acc, xs):
            sl, ij = xs

            def scalar(p):
                s = scene_update(scene, p)
                L, pos, act0 = rp.replay_radiance(
                    s, sl, seed, 0, ray_end=end[0], idx=ij, **kwr,
                )
                f = filmlib.put(
                    filmlib.new_film(w, h), pos,
                    jnp.where(jnp.isfinite(L), L, 0.0), active=act0,
                    rfilter=rfilter,
                )
                return jnp.sum(adj * f[..., :3])

            g = jax.grad(scalar)(params)
            return jax.tree_util.tree_map(jnp.add, acc, g), None

        acc0 = jax.tree_util.tree_map(jnp.zeros_like, params)
        acc, _ = jax.lax.scan(one, acc0, (rec3, idx.reshape(n_chunks, chunk)))
        # adjoint contributions are linear in the per-device splats: a
        # plain psum IS the full-frame gradient (no transpose inflation —
        # there is no psum inside `scalar`)
        return jax.tree_util.tree_map(lambda g: jax.lax.psum(g, "dp"), acc)

    adj_fn = jax.jit(jax.shard_map(
        dev_adj, mesh=mesh,
        in_specs=(P(), P(), P(), P("dp"), P("dp"), P("dp"), P()),
        out_specs=P(), check_vma=False,
    ))
    grads = adj_fn(scene, params, adj, rec, starts, ends, seed_u)
    return loss, grads
