#!/usr/bin/env python
"""Benchmark: camera rays/s of path-MIS forward and forward+backward on the
flagship bedroom-class scene (scene/flagship.py), on one GPU.

Two configurations run in one process, each at 1280x720, spp 4, ~2M
triangles: depth 8 and depth 65 (the reference bedroom's).  Forward is
integrators/pipelined.py::render_pipelined; forward+backward is
record_full_pipelined + replay.replay_grads w.r.t. material base colours
and emitter radiance.  Each timing follows one untimed call of the same
shapes, whose time is reported as compile (set-up) time.

Prints one JSON line per configuration, naming the device and the card's
power limit.  Exits nonzero without a GPU or when a configuration fails.

Usage: python bench.py [d8|d65 ...]      (default: both)
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SCENE = dict(res=(1280, 720), spp=4, tris=2_000_000)
# lanes, steps and replay chunk as chosen on the earlier accelerator; they
# are hypotheses on the GPU until re-tuned (ROADMAP queue 1, item 4)
CONFIGS = {
    "d8": dict(depth=8, fwd_lanes=49152, fwd_steps=32, rec_lanes=65536,
               rec_steps=32, rounds_per_launch=32, replay_chunk=131072),
    "d65": dict(depth=65, fwd_lanes=65536, fwd_steps=32, rec_lanes=65536,
                rec_steps=48, rounds_per_launch=32, replay_chunk=131072),
}


def diff_params(scene):
    return {"materials.base_color": scene.materials.base_color,
            "emitters.radiance": scene.emitters.radiance}


def forward(scene, cfg, seed):
    """One full-frame path-MIS render (tent filter)."""
    from mitsuba3_experiments_tpu.integrators.pipelined import (
        render_pipelined,
    )

    return render_pipelined(
        scene, seed=seed, spp=SCENE["spp"], max_depth=cfg["depth"],
        rr_depth=4, rfilter="tent", n_lanes=cfg["fwd_lanes"],
        steps=cfg["fwd_steps"], rounds_per_launch=cfg["rounds_per_launch"])


def forward_backward(scene, cfg, target, seed):
    """Record every camera ray's path, then the gradient of the per-pixel
    MSE against `target` by differentiable replay."""
    from mitsuba3_experiments_tpu.integrators.pipelined import (
        record_full_pipelined,
    )
    from mitsuba3_experiments_tpu.integrators.replay import replay_grads
    from mitsuba3_experiments_tpu.scene.params import update

    w, h = scene.camera.resolution
    n_rays = w * h * SCENE["spp"]
    chunk = cfg["replay_chunk"]
    pad = -(-n_rays // chunk) * chunk
    # replay_grads' "auto" mode sorts deep specs (depth >= 16), and the
    # sorted replay takes the recorder's forward film
    deep = cfg["depth"] >= 16
    out = record_full_pipelined(
        scene, seed, n_rays, spp=SCENE["spp"], max_depth=cfg["depth"],
        rr_depth=4, steps=cfg["rec_steps"],
        rounds_per_launch=cfg["rounds_per_launch"], n_lanes=cfg["rec_lanes"],
        pad_to=pad, return_film=deep, rfilter="box")
    rec, film = out if deep else (out, None)
    return replay_grads(
        scene, diff_params(scene), update, target, seed, rec, n_rays,
        chunk=chunk, spp=SCENE["spp"], max_depth=cfg["depth"], rr_depth=4,
        rfilter="box", mode="auto", film=film)


def timed(fn):
    """(fn(1), seconds of fn(0), seconds of fn(1)): the first call with
    these shapes compiles; the second is timed up to block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(0))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(1))
    return out, t_first, time.perf_counter() - t0


def load_scene():
    from mitsuba3_experiments_tpu.scene.flagship import load_flagship

    return load_flagship(res=SCENE["res"], spp=SCENE["spp"],
                         tri_budget=SCENE["tris"])[0]


def main(names):
    import jax

    from mitsuba3_experiments_tpu.utils.cache import enable_compile_cache
    from mitsuba3_experiments_tpu.utils.device import (
        card_info,
        peak_bytes,
        require_gpu,
    )

    dev = require_gpu()
    enable_compile_cache()
    card = card_info()
    scene = load_scene()
    w, h = scene.camera.resolution
    n_rays = w * h * SCENE["spp"]
    for name in names:
        cfg = CONFIGS[name]
        img, c_fwd, t_fwd = timed(lambda seed: forward(scene, cfg, seed))
        g, c_bwd, t_bwd = timed(
            lambda seed: forward_backward(scene, cfg, img, seed))
        finite = bool(jax.numpy.isfinite(img).all()) and all(
            bool(jax.numpy.isfinite(v).all()) for v in g.values())
        print(json.dumps({
            "metric": "camera rays/s, path-MIS, bedroom-class "
                      f"{w}x{h} spp{SCENE['spp']} depth {cfg['depth']}",
            "config": name,
            "fwd_rays_per_s": n_rays / t_fwd,
            "fwd_bwd_rays_per_s": n_rays / t_bwd,
            "fwd_compile_s": c_fwd, "fwd_bwd_compile_s": c_bwd,
            "peak_bytes_in_use": peak_bytes(dev),
            "finite": finite,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
        }), flush=True)
        if not finite:
            sys.exit(f"{name}: non-finite image or gradient")


if __name__ == "__main__":
    names = sys.argv[1:] or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        sys.exit(f"unknown configuration(s) {unknown}; choose from "
                 f"{list(CONFIGS)}")
    main(names)
