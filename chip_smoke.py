#!/usr/bin/env python
"""GPU smoke test: the production path at full width, in one process.

    python chip_smoke.py           # one GPU, phases 1-6 below
    python chip_smoke.py --four    # four GPUs: only the sharded path (7)

 1. environment: the card's name and power limit, JAX version, XLA_FLAGS,
    compile-cache directory;
 2. the native BVH builder and the flagship scene build (bench.py's scene:
    1280x720, ~2M triangles, native SBVH);
 3. forward at depth 8 (bench.forward): first call = compile (set-up), then
    one timed call;
 4. forward+backward (bench.forward_backward: record + replay gradient) at
    depth 8 and depth 65, the same way;
 5. correctness on the device (validation/checks.py): f32 transforms vs
    float64, Cornell path-MIS vs the NumPy oracle, pipelined vs lockstep on
    the flagship, replay gradients vs scan-AD;
 6. __graft_entry__.entry() and dryrun_multichip(1);
 7. (--four) render_persistent_sharded and sharded_replay_grad on a 4-GPU
    ("dp",) mesh against the same calls on a 1-GPU mesh, at flagship d8.

Each phase prints peak device memory after it.  Any failed phase makes the
script exit nonzero; only a run in which every phase passed prints the last
line {"ok": true, "device": {...}}.  Without a GPU it exits 2 at once.
"""
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FAILED = []


def log(msg):
    print(msg, flush=True)


def run_phase(name, fn, *args):
    """Run one phase; on failure record it and return None."""
    from mitsuba3_experiments_tpu.utils.device import peak_bytes

    log(f"== {name}")
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception:  # noqa: BLE001 — every failure is reported, then fatal
        traceback.print_exc()
        sys.stderr.flush()
        FAILED.append(name)
        log(f"FAIL {name} after {time.perf_counter() - t0:.1f} s")
        return None
    log(f"ok {name}: {time.perf_counter() - t0:.1f} s, "
        f"peak_bytes_in_use {peak_bytes()}")
    return out


def phase_env(card):
    import jax

    from mitsuba3_experiments_tpu.utils.cache import enable_compile_cache

    log(f"card: {card}")
    log(f"jax {jax.__version__}; devices {len(jax.devices())} x "
        f"{jax.devices()[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_compile_cache()}")


def phase_scene(on_host):
    """The flagship scene; with `on_host` its arrays are brought back to
    host memory, so that no device holds a copy of it outside the calls."""
    import jax

    import bench
    from mitsuba3_experiments_tpu.scene import native

    t0 = time.perf_counter()
    log(f"native library: {native.build()} "
        f"({time.perf_counter() - t0:.1f} s)")
    from mitsuba3_experiments_tpu.scene.flagship import load_flagship

    t0 = time.perf_counter()
    scene, meta = load_flagship(res=bench.SCENE["res"], spp=bench.SCENE["spp"],
                                tri_budget=bench.SCENE["tris"],
                                cache_dir=None)
    scene.bvh.unified.block_until_ready()
    dt = time.perf_counter() - t0
    tab = scene.bvh.unified
    refs = int((scene.bvh.leaf_face >= 0).sum())
    n_tri = scene.geometry.faces.shape[0]
    log(f"flagship: {n_tri} triangles, {refs} leaf references "
        f"(+{100 * (refs / n_tri - 1):.2f}% spatial-split duplicates), BVH "
        f"table {tab.shape[0]} rows x {tab.shape[1]} f32 = {tab.nbytes} B, "
        f"builder {meta['bvh_builder']}, {dt:.1f} s")
    assert meta["bvh_builder"] == "native-sbvh", meta["bvh_builder"]
    return jax.device_get(scene) if on_host else scene


def _finite(tree):
    import jax
    import jax.numpy as jnp

    return all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(tree))


def phase_forward(scene, card, n_rays):
    import bench

    img, t_first, dt = bench.timed(
        lambda seed: bench.forward(scene, bench.CONFIGS["d8"], seed))
    w, h = scene.camera.resolution
    assert img.shape == (h, w, 3), img.shape
    assert _finite(img) and float(img.mean()) > 0, "bad forward image"
    log(f"forward d8: compile+first run {t_first:.1f} s; {dt:.3f} s = "
        f"{n_rays / dt:.0f} camera rays/s on {card}; mean "
        f"{float(img.mean()):.4f}")
    return img


def phase_fwd_bwd(scene, card, n_rays, target, name):
    import bench

    g, t_first, dt = bench.timed(lambda seed: bench.forward_backward(
        scene, bench.CONFIGS[name], target, seed))
    assert _finite(g), "non-finite gradient"
    for k, v in g.items():
        assert float(abs(v).max()) > 0, f"zero gradient for {k}"
    log(f"fwd+bwd {name}: compile+first run {t_first:.1f} s; {dt:.3f} s = "
        f"{n_rays / dt:.0f} camera rays/s on {card}; |grad| max "
        + ", ".join(f"{k} {float(abs(v).max()):.4g}" for k, v in g.items()))


def phase_checks(scene, img):
    from mitsuba3_experiments_tpu.validation import checks

    log(f"transforms vs float64 (max error / bound scale, limit "
        f"{checks.TRANSFORM_RTOL:g}): {checks.check_transforms()}")
    log(f"cornell path-MIS vs NumPy oracle (block error / bound, limit 1; "
        f"global mean limit 2.5%): {checks.check_cornell_oracle()}")
    log(f"flagship pipelined (seed 1) vs lockstep render (seed 2) (limit "
        f"{checks.PIPE_K_SIGMA:g} sigma): "
        + str(checks.check_pipelined_vs_lockstep(
            scene, img, seed=1, spp=4, max_depth=8, rr_depth=4,
            rfilter="tent", chunk=1 << 19)))
    log(f"replay grads, modes full and sorted, vs scan-AD "
        f"(error / (rtol {checks.GRAD_RTOL:g} |g| "
        f"+ {checks.GRAD_ATOL_FRAC:g} max|g|), limit 1): "
        f"{checks.check_replay_vs_scan_ad()}")


def phase_entry():
    import jax

    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out.block_until_ready()
    assert _finite(out)
    log(f"entry() OK {out.shape}")
    ge.dryrun_multichip(1)
    log("dryrun_multichip(1) OK")


def phase_four(scene, card):
    """Sharded forward and fwd+bwd on 4 GPUs vs the same calls on 1.
    `scene` is in host memory: each call places it on its own mesh."""
    import jax

    import bench
    from mitsuba3_experiments_tpu.parallel import (
        make_mesh,
        render_persistent_sharded,
        sharded_replay_grad,
    )
    from mitsuba3_experiments_tpu.utils.device import peak_bytes
    from mitsuba3_experiments_tpu.validation import checks

    assert len(jax.devices()) >= 4, f"{len(jax.devices())} devices"
    cfg = bench.CONFIGS["d8"]
    spp = bench.SCENE["spp"]
    w, h = scene.camera.resolution
    n_rays = w * h * spp
    fkw = dict(seed=1, spp=spp, max_depth=cfg["depth"], rr_depth=4,
               rfilter="tent", n_lanes=cfg["fwd_lanes"],
               steps=cfg["fwd_steps"],
               rounds_per_launch=cfg["rounds_per_launch"],
               scheduler="pipelined")
    gkw = dict(idx0=0, n_lanes=cfg["rec_lanes"], spp=spp,
               max_depth=cfg["depth"], rr_depth=4, rfilter="box",
               steps=cfg["rec_steps"],
               rounds_per_launch=cfg["rounds_per_launch"], ray_end=n_rays,
               chunk=cfg["replay_chunk"], scheduler="pipelined")
    res = {}
    # before the 4-GPU run only device 0 has been used (the scene build)
    peak0_build = peak_bytes(jax.devices()[0])
    for n in (4, 1):
        mesh = make_mesh(n)
        t0 = time.perf_counter()
        jax.block_until_ready(render_persistent_sharded(scene, mesh, **fkw))
        c_fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = jax.block_until_ready(
            render_persistent_sharded(scene, mesh, **fkw))
        t_fwd = time.perf_counter() - t0
        params = bench.diff_params(scene)
        t0 = time.perf_counter()
        jax.block_until_ready(sharded_replay_grad(
            scene, params, img, 0, mesh, **gkw))
        c_bwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss, g = jax.block_until_ready(sharded_replay_grad(
            scene, params, img, 1, mesh, **gkw))
        t_bwd = time.perf_counter() - t0
        assert _finite((img, loss, g)), f"non-finite output on {n} GPUs"
        res[n] = (img, float(loss), g)
        # parallel/mesh.py builds its jitted shard_maps inside each call,
        # so a second call traces them again: its wall time is not a
        # steady-state frame time
        log(f"{n} GPU(s): forward d8 first call {c_fwd:.1f} s, second "
            f"call {t_fwd:.3f} s; fwd+bwd first call {c_bwd:.1f} s, second "
            f"call {t_bwd:.3f} s; on {'; '.join(card.split('; ')[:n])}")
        if n == 4:
            peaks = [peak_bytes(d) for d in jax.devices()[:4]]
            log(f"peak_bytes_in_use per device after the 4-GPU run: {peaks} "
                f"(device 0 after the scene build: {peak0_build})")
            # nothing lands on device 0 alone: all four high-water marks
            # agree within 10%, and device 0's is set by the sharded run
            assert min(peaks) >= 0.9 * max(peaks), peaks
            assert peaks[0] > peak0_build, (peaks[0], peak0_build)

    (img1, loss1, g1), (img4, loss4, g4) = res[1], res[4]
    log(f"forward 4 vs 1 GPU, same samples (at most "
        f"{checks.SAME_PIXEL_SHARE:g} of pixels beyond rtol "
        f"{checks.SAME_RTOL:g}): {checks.compare_same_samples(img4, img1)}")
    log(f"loss 1 GPU {loss1:.6g}, 4 GPUs {loss4:.6g}")
    assert abs(loss4 / loss1 - 1) <= checks.GRAD_RTOL, (loss1, loss4)
    log(f"grads 4 vs 1 GPU (error / bound, limit 1): "
        f"{checks.compare_grads(g4, g1)}")


def main(argv):
    import bench

    four = "--four" in argv
    unknown = set(argv) - {"--four"}
    if unknown:
        sys.exit(f"unknown arguments {sorted(unknown)}")
    import jax

    from mitsuba3_experiments_tpu.utils.device import card_info, require_gpu

    dev = require_gpu()
    card = card_info()
    log(card)
    w, h = bench.SCENE["res"]
    n_rays = w * h * bench.SCENE["spp"]
    run_phase("1 environment", phase_env, card)
    scene = run_phase("2 native build + flagship scene", phase_scene,
                      four)
    if scene is not None and four:
        run_phase("7 four GPUs: sharded vs one GPU", phase_four, scene, card)
    elif scene is not None:
        img = run_phase("3 forward d8", phase_forward, scene, card, n_rays)
        if img is not None:
            for name in ("d8", "d65"):
                run_phase(f"4 fwd+bwd {name}", phase_fwd_bwd, scene, card,
                          n_rays, img, name)
            run_phase("5 correctness", phase_checks, scene, img)
        run_phase("6 entry points (__graft_entry__.py)", phase_entry)
    if FAILED or scene is None:
        log(f"FAILED phases: {FAILED}")
        sys.exit(1)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
